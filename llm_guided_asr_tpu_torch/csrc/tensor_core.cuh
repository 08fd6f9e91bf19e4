// Tensor-core building blocks shared by the attention kernels
// (flash_attention.cu, rel_attention.cu), for Hopper (sm_90a); the
// depthwise kernels (depthwise_conv.cu) take its conversions and cp.async.
//
// Every product is a sum of mma.sync m16n8k8 TF32 tiles (A 16x8 row-major,
// B 8x8 column-major, C 16x8 in f32).  With g = lane / 4 and t = lane % 4 a
// thread holds A (g, t) (g+8, t) (g, t+4) (g+8, t+4), B (k t, n g) (k t+4,
// n g) and C (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1).  A product whose A
// operand is a C tile of the previous one takes the k index in the order
// 2t, 2t+1 instead of t, t+4 (c_as_a, load_b_perm): the sum over k is the
// same, and a C tile is then an A fragment as it stands.
//
// The 3xTF32 split: each float32 operand x is taken as big = tf32(x) and
// small = tf32(x - big), and small.big + big.small + big.big in an f32
// accumulator gives float32 accuracy (plain TF32 keeps ~10 bits).  bf16
// values are exact in TF32, so their small parts (and the products on
// them) are dropped.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 2^x by the SFU (relative error ~2^-22, far inside the 2e-5 forward and
// 1e-4 gradient tolerances)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small, both TF32 (round to nearest, ties away, as the hardware
// converts); a value known to be exact in TF32 has small = 0
template <bool EXACT>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
    return;
  }
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// c += a b to float32 accuracy: small.big, then big.small, then big.big
// (a small part known to be 0 is skipped)
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  if (!A_EXACT) mma_tf32(c, as, bb);
  if (!B_EXACT) mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 8) of a raw row-major
// tile, split as it is loaded
template <bool EXACT, int LD, typename T>
__device__ __forceinline__ void load_a(const T* s, int r0, int c0, int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const T* p = s + (r0 + (lane >> 2)) * LD + c0 + (lane & 3);
  split_tf32<EXACT>(to_f32(p[0]), big[0], small[0]);
  split_tf32<EXACT>(to_f32(p[8 * LD]), big[1], small[1]);
  split_tf32<EXACT>(to_f32(p[4]), big[2], small[2]);
  split_tf32<EXACT>(to_f32(p[8 * LD + 4]), big[3], small[3]);
}

// B fragment of tile^T from a split tile: n = tile rows [n0, n0 + 8),
// k = tile columns [k0, k0 + 8)
template <bool EXACT, int LDF>
__device__ __forceinline__ void load_b_t(const uint32_t* big, const uint32_t* small, int n0,
                                         int k0, int lane, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const int o = (n0 + (lane >> 2)) * LDF + k0 + (lane & 3);
  bb[0] = big[o];
  bb[1] = big[o + 4];
  bs[0] = EXACT ? 0u : small[o];
  bs[1] = EXACT ? 0u : small[o + 4];
}

// B fragment of a split tile itself: k = tile rows [k0, k0 + 8) in the order
// 2t, 2t+1 (see above), n = tile columns [n0, n0 + 8)
template <bool EXACT, int LDF>
__device__ __forceinline__ void load_b_perm(const uint32_t* big, const uint32_t* small, int k0,
                                            int n0, int lane, uint32_t (&bb)[2],
                                            uint32_t (&bs)[2]) {
  const int o = (k0 + 2 * (lane & 3)) * LDF + n0 + (lane >> 2);
  bb[0] = big[o];
  bb[1] = big[o + LDF];
  bs[0] = EXACT ? 0u : small[o];
  bs[1] = EXACT ? 0u : small[o + LDF];
}

// C tile (rows g, g+8; columns 2t, 2t+1) as the A fragment of the next
// product in the permuted k order
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split_tf32<false>(c[0], big[0], small[0]);
  split_tf32<false>(c[2], big[1], small[1]);
  split_tf32<false>(c[1], big[2], small[2]);
  split_tf32<false>(c[3], big[3], small[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
