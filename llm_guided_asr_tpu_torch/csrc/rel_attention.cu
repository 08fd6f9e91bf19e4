// Relative-position (Transformer-XL) self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_guided_asr_tpu/ops/rel_attention.py _fwd_kernel
// (called through _fwd_call / rel_flash_attention).  For one (b, h):
//
//   s[i,j]  = qu_i . k_j + qv_i . p_{(T-1)-i+j}      p: [2T-1, dk], row T-1 = offset 0
//   out_i   = sum_j softmax_j(mask_j(s[i,:]) * scale) v_j     mask: kv_valid[b,j]
//
// The TPU kernel materialises s2 = qv p^T as a [T, P] tile and barrel-shifts
// it; here every query row reads its positional rows straight from shared
// memory at the offset (T-1)-i+j, so there is neither a shift nor a
// [T, 2T-1] tensor, and the table needs no 128-row padding.  Masked keys get
// -1e30 (as the TPU kernel does); keys past T are excluded outright.
//
// Design: one block per (query tile of BQ rows, head, batch row), 8 warps of
// RPW rows each.  Key tiles of BK = 32 keys stream through shared memory
// together with the BQ+BK-1 positional rows they need (k and p stored
// transposed, with odd row strides, so both the staging stores and the
// lane-per-key reads are bank-conflict free).  A lane owns one key for the
// scores, and 32*DPL/32 output dims for the accumulation; the softmax is
// online over key tiles with float32 statistics and accumulators, so the
// [T, T] scores never leave registers.
//
// What bounds it on this card: operations.  It does 6*T*T*dk FLOPs per
// (b, h) on the CUDA cores in float32 (67 TFLOP/s peak) and moves only
// 5*T*dk + (2T-1)*dk elements; at the Conformer's shapes (B=1, H=4, T=312,
// dk=64) that is 150 MFLOP against 2.3 MB.  It does not use the tensor
// cores (wgmma/TMA are a later step), so its f32-core bound is the honest
// one for this version; bf16 inputs are widened to f32 in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int BK = 32;          // keys per tile (one per lane)
constexpr int NW = 8;           // warps per block
constexpr int RPW = BQ / NW;    // query rows per warp
constexpr int PROWS = BQ + BK - 1; // positional rows per key tile
constexpr int KTS = BK + 1;     // row stride of the transposed key tile
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL: head dims per lane (dk <= 32 * DPL); DKP = 32 * DPL is the padded dk.
template <typename T, int DPL>
__global__ void __launch_bounds__(NW * 32)
rel_attention_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ kv_valid,
                         T* __restrict__ out, int H, int T_len, int dk, float scale) {
  constexpr int DKP = 32 * DPL;
  extern __shared__ float smem[];
  float* s_qu = smem;                 // [BQ][DKP]
  float* s_qv = s_qu + BQ * DKP;      // [BQ][DKP]
  float* s_kT = s_qv + BQ * DKP;      // [DKP][KTS]
  float* s_v = s_kT + DKP * KTS;      // [BK][DKP]
  float* s_pT = s_v + BK * DKP;       // [DKP][PROWS]

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = ((size_t)b * H + h) * T_len * dk;  // (b, h) slab of [B,H,T,dk]
  const T* qu_bh = qu + base;
  const T* qv_bh = qv + base;
  const T* k_bh = k + base;
  const T* v_bh = v + base;
  const T* p_h = p + (size_t)h * (2 * T_len - 1) * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;

  for (int idx = tid; idx < BQ * DKP; idx += NW * 32) {
    const int r = idx / DKP, d = idx % DKP, i = i0 + r;
    const bool ok = i < T_len && d < dk;
    s_qu[idx] = ok ? to_f32(qu_bh[(size_t)i * dk + d]) : 0.f;
    s_qv[idx] = ok ? to_f32(qv_bh[(size_t)i * dk + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  for (int j0 = 0; j0 < T_len; j0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * DKP; idx += NW * 32) {
      const int jr = idx / DKP, d = idx % DKP, j = j0 + jr;
      const bool ok = j < T_len && d < dk;
      s_kT[d * KTS + jr] = ok ? to_f32(k_bh[(size_t)j * dk + d]) : 0.f;
      s_v[idx] = ok ? to_f32(v_bh[(size_t)j * dk + d]) : 0.f;
    }
    // positional rows (T-1)-i+j for i in [i0, i0+BQ), j in [j0, j0+BK)
    const int rbase = (T_len - 1) - (i0 + BQ - 1) + j0;
    for (int idx = tid; idx < PROWS * DKP; idx += NW * 32) {
      const int rr = idx / DKP, d = idx % DKP, r = rbase + rr;
      const bool ok = r >= 0 && r < 2 * T_len - 1 && d < dk;
      s_pT[d * PROWS + rr] = ok ? to_f32(p_h[(size_t)r * dk + d]) : 0.f;
    }
    __syncthreads();

    const int j = j0 + lane;
    const bool j_in = j < T_len;
    const bool j_valid = j_in && valid_b[j] != 0;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int ii = warp * RPW + r;
      const int pr = (BQ - 1 - ii) + lane;  // local row of p_{(T-1)-i+j}
      const float* qu_r = s_qu + ii * DKP;
      const float* qv_r = s_qv + ii * DKP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DKP; ++d) {
        s = fmaf(qu_r[d], s_kT[d * KTS + lane], s);
        s = fmaf(qv_r[d], s_pT[d * PROWS + pr], s);
      }
      s *= scale;
      if (!j_valid) s = MASKED;
      if (!j_in) s = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      const float e = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(e);
#pragma unroll
      for (int q = 0; q < DPL; ++q) acc[r][q] *= alpha;
      for (int jj = 0; jj < BK; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, e, jj);
#pragma unroll
        for (int q = 0; q < DPL; ++q) acc[r][q] = fmaf(pj, s_v[jj * DKP + q * 32 + lane], acc[r][q]);
      }
      m[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    if (i >= T_len) continue;
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const int d = q * 32 + lane;
      if (d < dk) out[base + (size_t)i * dk + d] = from_f32<T>(acc[r][q] * inv_l);
    }
  }
}

template <typename T, int DPL>
int launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
           const void* kv_valid, void* out, int B, int H, int T_len, int dk, float scale,
           cudaStream_t stream) {
  constexpr int DKP = 32 * DPL;
  const size_t smem = (size_t)(2 * BQ * DKP + DKP * KTS + BK * DKP + DKP * PROWS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rel_attention_fwd_kernel<T, DPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  rel_attention_fwd_kernel<T, DPL><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), static_cast<const int*>(kv_valid),
      static_cast<T*>(out), H, T_len, dk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dk(const void* qu, const void* qv, const void* k, const void* v, const void* p,
                const void* kv_valid, void* out, int B, int H, int T_len, int dk, float scale,
                cudaStream_t s) {
  if (dk <= 32) return launch<T, 1>(qu, qv, k, v, p, kv_valid, out, B, H, T_len, dk, scale, s);
  if (dk <= 64) return launch<T, 2>(qu, qv, k, v, p, kv_valid, out, B, H, T_len, dk, scale, s);
  if (dk <= 128) return launch<T, 4>(qu, qv, k, v, p, kv_valid, out, B, H, T_len, dk, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qu, qv, k, v, out: [B, H, T, dk]; p: [H, 2T-1, dk]; kv_valid: int32 [B, T].
// dtype: 0 = float32, 1 = bfloat16 (all float operands share it).
int rel_attention_fwd(const void* qu, const void* qv, const void* k, const void* v,
                      const void* p, const void* kv_valid, void* out, int B, int H,
                      int T_len, int dk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dk<float>(qu, qv, k, v, p, kv_valid, out, B, H, T_len, dk, scale, s);
  if (dtype == 1)
    return dispatch_dk<__nv_bfloat16>(qu, qv, k, v, p, kv_valid, out, B, H, T_len, dk, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
