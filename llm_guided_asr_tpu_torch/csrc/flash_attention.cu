// Flash self-attention with a validity mask over the frames, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of the library flash attention that
// llm_guided_asr_tpu/models/transformer.py FlashSelfAttention calls (:490),
// in jax/experimental/pallas/ops/tpu/flash_attention.py:
//   _flash_attention_kernel      (forward, through _flash_attention_impl)
//   _flash_attention_dkv_kernel  (dK, dV, through _flash_attention_bwd_dkv)
//   _flash_attention_dq_kernel   (dQ, through _flash_attention_bwd_dq)
// For one (b, h), with valid = valid[b, :] (1 = a frame, 0 = a pad):
//
//   P[i, j] = softmax_j over the valid keys of (q_i . k_j * scale)
//   out_i   = sum_j P[i, j] v_j      for a valid query row, 0 for a pad row
//   lse_i   = log sum_j exp(q_i . k_j * scale) over the valid keys, 0 for a pad row
//
// The module hands the TPU library the mask as SegmentIds (frames in segment
// 1, pads in segment 0, T padded to a multiple of 128) and zeroes the pad
// query rows afterwards; the valid query rows see exactly the valid keys, so
// this is the same function.  Here the mask is read directly and T needs no
// padding: a tile of keys (or queries) with no valid entry is skipped whole,
// and inside a tile masked keys get no probability.
//
// Forward: one block per (query tile of BQ rows, head, batch row), 8 warps of
// RPW rows.  Key tiles of BK = 32 keys stream through shared memory (k
// transposed with an odd row stride, so the lane-per-key reads are bank
// conflict free; v row-major).  A lane owns one key for the scores (the query
// rows are read as float4 broadcasts, every k element feeds RPW rows) and
// DK/32 output dims for the accumulation; the softmax is online over the key
// tiles with float32 statistics, so the [T, T] scores never leave registers.
//
// Backward (the FlashAttention-2 split, scores recomputed from the saved
// log-sum-exp; delta_i = out_i . dout_i comes from the caller, as the library
// takes it from XLA):
//   dkv  one block per (key tile of KB keys, head, batch row): a warp owns
//        KPW keys, a lane owns a query of the current query tile; dk_j and
//        dv_j accumulate in registers over all query tiles;
//   dq   one block per (query tile, head, batch row), laid out as the
//        forward: dq_i = sum_j ds_ij k_j.
// Every output element has one owner, so there are no atomics.
//
// What bounds it on this card: operations.  Per (b, h) and pair of valid
// frames the forward does 4*DK FLOPs (scores, P.v), the dK/dV kernel 8*DK
// (scores and dP recomputed, dV, dK) and the dQ kernel 6*DK (scores, dP,
// dQ), on the CUDA cores in float32 (67 TFLOP/s peak),
// while moving O(T*DK) elements: at the training shape (B=8, H=4, T=1874,
// DK=64) the forward is 2.9e10 FLOP (0.43 ms) against ~31 MB (0.01 ms).  It
// does not use the tensor cores (wgmma/TMA are a later step); bf16 inputs are
// widened to f32 in shared memory and every sum is taken in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int NT = NW * 32;      // threads per block
constexpr int BQ = 32;           // query rows per block in the query-major kernels
constexpr int RPW = BQ / NW;     // query rows per warp
constexpr int BK = 32;           // keys per tile (one per lane) in the query-major kernels
constexpr int KTS = BK + 1;      // row stride of a transposed key tile
constexpr int KB = 32;           // keys per block in the key-major kernel
constexpr int KPW = KB / NW;     // keys per warp
constexpr int QB = 32;           // queries per tile (one per lane) in the key-major kernel
constexpr int QTS = QB + 1;      // row stride of a transposed query tile

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

__device__ __forceinline__ bool is_valid(const int* __restrict__ valid_b, int i, int T_len) {
  return i < T_len && valid_b[i] != 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float x0, float x1, float x2, float x3, float s) {
  s = fmaf(a.x, x0, s);
  s = fmaf(a.y, x1, s);
  s = fmaf(a.z, x2, s);
  return fmaf(a.w, x3, s);
}

// rows [r0, r0 + ROWS) of a [T, DK] slab into shared memory, row-major
// (stride DK) or transposed (element (r, d) at d * tstride + r); rows past
// T are zero
template <typename T, int DK, int ROWS>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int r0, int T_len,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < ROWS * DK; idx += NT) {
    const int r = idx / DK, d = idx % DK;
    dst[idx] = r0 + r < T_len ? to_f32(src[(size_t)(r0 + r) * DK + d]) : 0.f;
  }
}
template <typename T, int DK, int ROWS>
__device__ __forceinline__ void stage_rows_t(const T* __restrict__ src, int r0, int T_len,
                                            float* dst, int tstride) {
  for (int idx = threadIdx.x; idx < ROWS * DK; idx += NT) {
    const int r = idx / DK, d = idx % DK;
    dst[d * tstride + r] = r0 + r < T_len ? to_f32(src[(size_t)(r0 + r) * DK + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int DK>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ valid, T* __restrict__ out, float* __restrict__ lse,
                 int H, int T_len, float scale) {
  constexpr int DPL = DK / 32;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;               // [BQ][DK]
  float* s_kT = s_q + BQ * DK;     // [DK][KTS]
  float* s_v = s_kT + DK * KTS;    // [BK][DK]

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }

  // a tile of pad rows only is written as zeros without reading a key
  const bool any_q = __syncthreads_or(tid < BQ && is_valid(valid_b, i0 + tid, T_len));
  if (any_q) {
    stage_rows<T, DK, BQ>(q + base, i0, T_len, s_q);
    for (int j0 = 0; j0 < T_len; j0 += BK) {
      // the barrier also ends the previous tile's reads (and publishes s_q)
      if (!__syncthreads_or(tid < BK && is_valid(valid_b, j0 + tid, T_len))) continue;
      stage_rows_t<T, DK, BK>(k + base, j0, T_len, s_kT, KTS);
      stage_rows<T, DK, BK>(v + base, j0, T_len, s_v);
      __syncthreads();

      float s[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; d += 4) {
        const float k0 = s_kT[(d + 0) * KTS + lane], k1 = s_kT[(d + 1) * KTS + lane];
        const float k2 = s_kT[(d + 2) * KTS + lane], k3 = s_kT[(d + 3) * KTS + lane];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          s[r] = dot4(ld4(s_q + (warp * RPW + r) * DK + d), k0, k1, k2, k3, s[r]);
      }
      // every processed tile holds a valid key, so each row's maximum is finite
      const bool j_valid = is_valid(valid_b, j0 + lane, T_len);
      float e[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float sr = j_valid ? s[r] * scale : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float alpha = expf(m[r] - m_new);  // 0 on the first tile
        e[r] = expf(sr - m_new);
        l[r] = l[r] * alpha + warp_sum(e[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      }
#pragma unroll 4
      for (int jj = 0; jj < BK; ++jj) {
        float p[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) p[r] = __shfl_sync(0xffffffffu, e[r], jj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const float vv = s_v[jj * DK + c * 32 + lane];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    if (i >= T_len) continue;
    const bool ok = is_valid(valid_b, i, T_len);  // implies any_q, so l >= 1
    const float inv_l = ok ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      out[base + (size_t)i * DK + c * 32 + lane] = from_f32<T>(ok ? acc[r][c] * inv_l : 0.f);
    if (lse != nullptr && lane == 0) lse[row_base + i] = ok ? m[r] + logf(l[r]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward, key-major: dk and dv
// ---------------------------------------------------------------------------

template <typename T, int DK>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, int H, int T_len,
                     float scale) {
  constexpr int DPL = DK / 32;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;                  // [KB][DK]
  float* s_v = s_k + KB * DK;         // [KB][DK]
  float* s_qT = s_v + KB * DK;        // [DK][QTS]
  float* s_doT = s_qT + DK * QTS;     // [DK][QTS]
  float* s_lse = s_doT + DK * QTS;    // [QB]
  float* s_delta = s_lse + QB;        // [QB]

  const int j0 = blockIdx.x * KB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;

  float acc_k[KPW][DPL], acc_v[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // masked keys take no probability: a tile of them gets zero gradients
  const bool any_k = __syncthreads_or(tid < KB && is_valid(valid_b, j0 + tid, T_len));
  if (any_k) {
    stage_rows<T, DK, KB>(k + base, j0, T_len, s_k);
    stage_rows<T, DK, KB>(v + base, j0, T_len, s_v);
    bool key_ok[KPW];
#pragma unroll
    for (int r = 0; r < KPW; ++r) key_ok[r] = is_valid(valid_b, j0 + warp * KPW + r, T_len);
    for (int i0 = 0; i0 < T_len; i0 += QB) {
      // pad query rows carry no gradient; the barrier also ends the
      // previous tile's reads (and publishes s_k, s_v)
      if (!__syncthreads_or(tid < QB && is_valid(valid_b, i0 + tid, T_len))) continue;
      stage_rows_t<T, DK, QB>(q + base, i0, T_len, s_qT, QTS);
      stage_rows_t<T, DK, QB>(dout + base, i0, T_len, s_doT, QTS);
      if (tid < QB) {
        const bool ok = is_valid(valid_b, i0 + tid, T_len);
        s_lse[tid] = ok ? lse[row_base + i0 + tid] : 0.f;
        s_delta[tid] = ok ? delta[row_base + i0 + tid] : 0.f;
      }
      __syncthreads();

      const bool i_valid = is_valid(valid_b, i0 + lane, T_len);  // this lane's query
      float s[KPW], dp[KPW];
#pragma unroll
      for (int r = 0; r < KPW; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; d += 4) {
        const float q0 = s_qT[(d + 0) * QTS + lane], q1 = s_qT[(d + 1) * QTS + lane];
        const float q2 = s_qT[(d + 2) * QTS + lane], q3 = s_qT[(d + 3) * QTS + lane];
        const float g0 = s_doT[(d + 0) * QTS + lane], g1 = s_doT[(d + 1) * QTS + lane];
        const float g2 = s_doT[(d + 2) * QTS + lane], g3 = s_doT[(d + 3) * QTS + lane];
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          const int jj = warp * KPW + r;
          s[r] = dot4(ld4(s_k + jj * DK + d), q0, q1, q2, q3, s[r]);
          dp[r] = dot4(ld4(s_v + jj * DK + d), g0, g1, g2, g3, dp[r]);
        }
      }
      const float lse_i = s_lse[lane], delta_i = s_delta[lane];
      float pr[KPW], ds[KPW];
#pragma unroll
      for (int r = 0; r < KPW; ++r) {
        pr[r] = (i_valid && key_ok[r]) ? expf(s[r] * scale - lse_i) : 0.f;
        ds[r] = pr[r] * (dp[r] - delta_i) * scale;
      }
      // dv_j += sum_i P_ij dout_i;  dk_j += sum_i ds_ij q_i  (a lane owns dims)
#pragma unroll 4
      for (int ii = 0; ii < QB; ++ii) {
        float pi[KPW], di[KPW];
#pragma unroll
        for (int r = 0; r < KPW; ++r) {
          pi[r] = __shfl_sync(0xffffffffu, pr[r], ii);
          di[r] = __shfl_sync(0xffffffffu, ds[r], ii);
        }
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = c * 32 + lane;
          const float g = s_doT[d * QTS + ii];
          const float x = s_qT[d * QTS + ii];
#pragma unroll
          for (int r = 0; r < KPW; ++r) {
            acc_v[r][c] = fmaf(pi[r], g, acc_v[r][c]);
            acc_k[r][c] = fmaf(di[r], x, acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int j = j0 + warp * KPW + r;
    if (j >= T_len) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const size_t g = base + (size_t)j * DK + c * 32 + lane;
      dk_out[g] = from_f32<T>(acc_k[r][c]);
      dv_out[g] = from_f32<T>(acc_v[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, query-major: dq
// ---------------------------------------------------------------------------

template <typename T, int DK>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int T_len, float scale) {
  constexpr int DPL = DK / 32;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                // [BQ][DK]
  float* s_do = s_q + BQ * DK;      // [BQ][DK]
  float* s_kT = s_do + BQ * DK;     // [DK][KTS]
  float* s_vT = s_kT + DK * KTS;    // [DK][KTS]

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;

  float acc[RPW][DPL], lse_r[RPW], delta_r[RPW];
  bool row_ok[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    row_ok[r] = is_valid(valid_b, i, T_len);
    lse_r[r] = row_ok[r] ? lse[row_base + i] : 0.f;
    delta_r[r] = row_ok[r] ? delta[row_base + i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const bool any_q = __syncthreads_or(tid < BQ && is_valid(valid_b, i0 + tid, T_len));
  if (any_q) {
    stage_rows<T, DK, BQ>(q + base, i0, T_len, s_q);
    stage_rows<T, DK, BQ>(dout + base, i0, T_len, s_do);
    for (int j0 = 0; j0 < T_len; j0 += BK) {
      if (!__syncthreads_or(tid < BK && is_valid(valid_b, j0 + tid, T_len))) continue;
      stage_rows_t<T, DK, BK>(k + base, j0, T_len, s_kT, KTS);
      stage_rows_t<T, DK, BK>(v + base, j0, T_len, s_vT, KTS);
      __syncthreads();

      float s[RPW], dp[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DK; d += 4) {
        const float k0 = s_kT[(d + 0) * KTS + lane], k1 = s_kT[(d + 1) * KTS + lane];
        const float k2 = s_kT[(d + 2) * KTS + lane], k3 = s_kT[(d + 3) * KTS + lane];
        const float v0 = s_vT[(d + 0) * KTS + lane], v1 = s_vT[(d + 1) * KTS + lane];
        const float v2 = s_vT[(d + 2) * KTS + lane], v3 = s_vT[(d + 3) * KTS + lane];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int ii = warp * RPW + r;
          s[r] = dot4(ld4(s_q + ii * DK + d), k0, k1, k2, k3, s[r]);
          dp[r] = dot4(ld4(s_do + ii * DK + d), v0, v1, v2, v3, dp[r]);
        }
      }
      const bool j_valid = is_valid(valid_b, j0 + lane, T_len);
      float ds[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = (row_ok[r] && j_valid) ? expf(s[r] * scale - lse_r[r]) : 0.f;
        ds[r] = p * (dp[r] - delta_r[r]) * scale;
      }
      // dq_i += sum_j ds_ij k_j  (a lane owns dims)
#pragma unroll 4
      for (int jj = 0; jj < BK; ++jj) {
        float dj[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) dj[r] = __shfl_sync(0xffffffffu, ds[r], jj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const float kv = s_kT[(c * 32 + lane) * KTS + jj];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][c] = fmaf(dj[r], kv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    if (i >= T_len) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) dq[base + (size_t)i * DK + c * 32 + lane] = from_f32<T>(acc[r][c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DK>
int launch_fwd(const void* q, const void* k, const void* v, const void* valid, void* out,
               void* lse, int B, int H, int T_len, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * DK + DK * KTS + BK * DK) * sizeof(float);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<T*>(out), static_cast<float*>(lse), H, T_len,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_dkv(const void* q, const void* k, const void* v, const void* valid, const void* dout,
               const void* lse, const void* delta, void* dk_out, void* dv_out, int B, int H,
               int T_len, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * KB * DK + 2 * DK * QTS + 2 * QB) * sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + KB - 1) / KB, H, B);
  flash_bwd_dkv_kernel<T, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), H, T_len, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_dq(const void* q, const void* k, const void* v, const void* valid, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H, int T_len, float scale,
              cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BQ * DK + 2 * DK * KTS) * sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, DK><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), H,
      T_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One dispatch over (dtype, head dim) for each entry point: dtype 0 =
// float32, 1 = bfloat16; dk 64, 128 or 256; anything else is refused.
#define FLASH_DISPATCH(LAUNCH, ...)                                   \
  if (dtype == 0) {                                                   \
    if (dk == 64) return LAUNCH<float, 64>(__VA_ARGS__);              \
    if (dk == 128) return LAUNCH<float, 128>(__VA_ARGS__);            \
    if (dk == 256) return LAUNCH<float, 256>(__VA_ARGS__);            \
  } else if (dtype == 1) {                                            \
    if (dk == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);      \
    if (dk == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);    \
    if (dk == 256) return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);    \
  }                                                                   \
  return (int)cudaErrorInvalidValue;

extern "C" {

// q, k, v, out: [B, H, T, dk] in dtype; valid: int32 [B, T]; lse: float32
// [B, H, T] or null (not written).
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                        void* out, void* lse, int B, int H, int T_len, int dk, float scale,
                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, valid, out, lse, B, H, T_len, scale, s)
}

// dk_out, dv_out for the output gradient dout, given the forward's lse and
// delta = rowsum(out * dout), both float32 [B, H, T].
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* valid,
                            const void* dout, const void* lse, const void* delta, void* dk_out,
                            void* dv_out, int B, int H, int T_len, int dk, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, valid, dout, lse, delta, dk_out, dv_out, B, H, T_len,
                 scale, s)
}

// dq for the output gradient dout, from the same lse and delta.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* valid,
                           const void* dout, const void* lse, const void* delta, void* dq, int B,
                           int H, int T_len, int dk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, valid, dout, lse, delta, dq, B, H, T_len, scale, s)
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
