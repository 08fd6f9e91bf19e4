// Relative-position (Transformer-XL) self-attention, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of llm_guided_asr_tpu/ops/rel_attention.py:
// _fwd_kernel (called through _fwd_call) and _bwd_kernel (called through
// _vjp_bwd).  For one (b, h):
//
//   s[i,j]  = (qu_i . k_j + qv_i . p_{(T-1)-i+j}) * scale   p: [2T-1, dk], row T-1 = offset 0
//   P[i,j]  = softmax_j(mask_j(s[i,:]))                     mask: kv_valid[b,j]
//   out_i   = sum_j keep_ij / (1-rate) * P[i,j] v_j         keep: the hash of dropout_keep
//
// The TPU kernel materialises s2 = qv p^T as a [T, P] tile and barrel-shifts
// it (and lane-reverses it in the backward); here every query row reads its
// positional rows straight from shared memory at the offset (T-1)-i+j, so
// there is neither a shift nor a [T, 2T-1] tensor, and the table needs no
// 128-row padding.  Masked keys get -1e30 (as the TPU kernel does); keys
// past T are excluded outright.  Attention-prob dropout re-derives the TPU
// kernel's counter hash of (seed, head, batch, i, j) bit for bit, so the
// forward and the backward drop the same probabilities without storing a
// mask.
//
// Forward: one block per (query tile of BQ rows, head, batch row), 8 warps
// of RPW rows each.  Key tiles of BK = 32 keys stream through shared memory
// together with the BQ+BK-1 positional rows they need (k and p stored
// transposed, with odd row strides, so both the staging stores and the
// lane-per-key reads are bank-conflict free).  A lane owns one key for the
// scores, and DPL output dims for the accumulation; the softmax is online
// over key tiles with float32 statistics, so the [T, T] scores never leave
// registers.  When asked, it stores the per-row log-sum-exp of the
// pre-dropout softmax for the backward.
//
// Backward (the FlashAttention-2 split, scores recomputed from the saved
// log-sum-exp):
//   delta pass  delta_i = dout_i . out_i  (= rowsum(dP o P) even with dropout,
//               since the normaliser is the pre-dropout one);
//   key pass    one block per (key tile, head, batch row): a warp owns keys,
//               a lane owns a query of the current query tile; accumulates
//               dk_j and dv_j in registers over all query tiles, and for each
//               query tile sums ds_ij qv_i over the tile's BQ+BK-1 diagonals
//               in shared memory and adds them to dp [H, 2T-1, dk] (float32,
//               summed over the batch) with one atomicAdd per row and dim;
//   query pass  one block per (query tile, head, batch row), laid out as the
//               forward: accumulates dqu_i = sum_j ds_ij k_j and
//               dqv_i = sum_j ds_ij p_{(T-1)-i+j}.
//
// What bounds it on this card: operations.  The forward does 6*T*T*dk FLOPs
// per (b, h) and the backward 16*T*T*dk (the recomputed scores and their
// five products), on the CUDA cores in float32 (67 TFLOP/s peak), while
// moving only O(T*dk) elements: at the training shapes (B=64, H=4, T=312,
// dk=64) the backward is 2.55e10 FLOP (0.38 ms) against ~200 MB (0.06 ms).
// It does not use the tensor cores (wgmma/TMA are a later step), so its
// f32-core bound is the honest one for this version; bf16 inputs are
// widened to f32 in shared memory and every sum is taken in f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NW = 8;            // warps per block
constexpr int NT = NW * 32;      // threads per block
constexpr int BK = 32;           // keys per tile (one per lane) in the query-major kernels
constexpr int BQ = 16;           // query rows per block in the query-major kernels
constexpr int RPW = BQ / NW;     // query rows per warp
constexpr int PROWS = BQ + BK - 1;   // positional rows per (query tile, key tile)
constexpr int KTS = BK + 1;      // row stride of a transposed key tile
// key-major (dk, dv, dp) kernel
constexpr int KB = 32;           // keys per block
constexpr int KPW = KB / NW;     // keys per warp
constexpr int QB = 32;           // queries per tile (one per lane)
constexpr int QTS = QB + 1;      // row stride of a transposed query tile
constexpr int KPROWS = QB + KB - 1;  // positional rows per (query tile, key block)
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

// The TPU kernel's dropout_keep_mask, one element: uint32 arithmetic wraps
// exactly as jnp.uint32 does.  cell = seed + h*0x927C1 + b*0x68E31DA5.
__device__ __forceinline__ bool dropout_keep(uint32_t cell, int i, int j, uint32_t threshold) {
  uint32_t x = (uint32_t)i * 0x9E3779B1u + (uint32_t)j * 0x85EBCA77u;
  x ^= cell;
  x = (x ^ (x >> 15)) * 0x2C1B3C6Du;
  x = (x ^ (x >> 12)) * 0x297A2D39u;
  x ^= x >> 15;
  return x >= threshold;
}

__device__ __forceinline__ uint32_t dropout_cell(uint32_t seed, int h, int b) {
  return seed + (uint32_t)h * 0x927C1u + (uint32_t)b * 0x68E31DA5u;
}

struct Dropout {
  uint32_t seed;       // the int32 seed's bits
  uint32_t threshold;  // uint32(rate * 2^32); 0 keeps everything
  float inv_keep;      // 1 / (1 - rate)
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// DPL: head dims per lane (dk <= 32 * DPL); DKP = 32 * DPL is the padded dk.
template <typename T, int DPL>
__global__ void __launch_bounds__(NT)
rel_attention_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ p, const int* __restrict__ kv_valid,
                         T* __restrict__ out, float* __restrict__ lse, int H, int T_len,
                         int dk, float scale, Dropout drop) {
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
  const uint32_t cell = dropout_cell(drop.seed, h, b);

  for (int idx = tid; idx < BQ * DKP; idx += NT) {
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
    for (int idx = tid; idx < BK * DKP; idx += NT) {
      const int jr = idx / DKP, d = idx % DKP, j = j0 + jr;
      const bool ok = j < T_len && d < dk;
      s_kT[d * KTS + jr] = ok ? to_f32(k_bh[(size_t)j * dk + d]) : 0.f;
      s_v[idx] = ok ? to_f32(v_bh[(size_t)j * dk + d]) : 0.f;
    }
    // positional rows (T-1)-i+j for i in [i0, i0+BQ), j in [j0, j0+BK)
    const int rbase = (T_len - 1) - (i0 + BQ - 1) + j0;
    for (int idx = tid; idx < PROWS * DKP; idx += NT) {
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
      float e = expf(s - m_new);
      l[r] = l[r] * alpha + warp_sum(e);       // the pre-dropout normaliser
      if (drop.threshold != 0u)
        e = dropout_keep(cell, i0 + ii, j, drop.threshold) ? e * drop.inv_keep : 0.f;
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
    if (lse != nullptr && lane == 0) lse[((size_t)b * H + h) * T_len + i] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// backward: delta_i = dout_i . out_i, one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT)
rel_attention_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int dk) {
  const long long row = (long long)blockIdx.x * NW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * dk;
  const T* g = dout + row * dk;
  float s = 0.f;
  for (int d = lane; d < dk; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// backward, key-major: dk, dv and dp
// ---------------------------------------------------------------------------

template <typename T, int DPL>
__global__ void __launch_bounds__(NT)
rel_attention_bwd_kv_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                            const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ p, const int* __restrict__ kv_valid,
                            const T* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dk_out,
                            T* __restrict__ dv_out, float* __restrict__ dp, int H, int T_len,
                            int dk, float scale, Dropout drop) {
  constexpr int DKP = 32 * DPL;
  extern __shared__ float smem[];
  float* s_k = smem;                   // [KB][DKP]
  float* s_v = s_k + KB * DKP;         // [KB][DKP]
  float* s_quT = s_v + KB * DKP;       // [DKP][QTS]
  float* s_qvT = s_quT + DKP * QTS;    // [DKP][QTS]
  float* s_doT = s_qvT + DKP * QTS;    // [DKP][QTS]
  float* s_pT = s_doT + DKP * QTS;     // [DKP][KPROWS]
  float* s_ds = s_pT + DKP * KPROWS;   // [KB][QTS]
  float* s_lse = s_ds + KB * QTS;      // [QB]
  float* s_delta = s_lse + QB;         // [QB]

  const int j0 = blockIdx.x * KB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = ((size_t)b * H + h) * T_len * dk;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const int n_pos = 2 * T_len - 1;
  const T* p_h = p + (size_t)h * n_pos * dk;
  float* dp_h = dp + (size_t)h * n_pos * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const uint32_t cell = dropout_cell(drop.seed, h, b);

  for (int idx = tid; idx < KB * DKP; idx += NT) {
    const int jr = idx / DKP, d = idx % DKP, j = j0 + jr;
    const bool ok = j < T_len && d < dk;
    s_k[idx] = ok ? to_f32(k[base + (size_t)j * dk + d]) : 0.f;
    s_v[idx] = ok ? to_f32(v[base + (size_t)j * dk + d]) : 0.f;
  }

  float acc_k[KPW][DPL], acc_v[KPW][DPL];
#pragma unroll
  for (int r = 0; r < KPW; ++r)
#pragma unroll
    for (int q = 0; q < DPL; ++q) acc_k[r][q] = acc_v[r][q] = 0.f;

  for (int i0 = 0; i0 < T_len; i0 += QB) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < QB * DKP; idx += NT) {
      const int ir = idx / DKP, d = idx % DKP, i = i0 + ir;
      const bool ok = i < T_len && d < dk;
      const size_t g = base + (size_t)i * dk + d;
      s_quT[d * QTS + ir] = ok ? to_f32(qu[g]) : 0.f;
      s_qvT[d * QTS + ir] = ok ? to_f32(qv[g]) : 0.f;
      s_doT[d * QTS + ir] = ok ? to_f32(dout[g]) : 0.f;
    }
    // positional rows (T-1)-i+j for i in [i0, i0+QB), j in [j0, j0+KB)
    const int rbase = (T_len - 1) - (i0 + QB - 1) + j0;
    for (int idx = tid; idx < KPROWS * DKP; idx += NT) {
      const int rr = idx / DKP, d = idx % DKP, r = rbase + rr;
      const bool ok = r >= 0 && r < n_pos && d < dk;
      s_pT[d * KPROWS + rr] = ok ? to_f32(p_h[(size_t)r * dk + d]) : 0.f;
    }
    if (tid < QB) {
      const int i = i0 + tid;
      s_lse[tid] = i < T_len ? lse[row_base + i] : 0.f;
      s_delta[tid] = i < T_len ? delta[row_base + i] : 0.f;
    }
    __syncthreads();

    const int i = i0 + lane;  // this lane's query
    const bool i_in = i < T_len;
    const float lse_i = s_lse[lane];
    const float delta_i = s_delta[lane];
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int jj = warp * KPW + r;
      const int j = j0 + jj;
      float ds = 0.f, pd = 0.f;
      if (j < T_len) {  // warp-uniform
        const int pr = (QB - 1 - lane) + jj;  // local row of p_{(T-1)-i+j}
        const float* k_r = s_k + jj * DKP;
        const float* v_r = s_v + jj * DKP;
        float s = 0.f, dpr = 0.f;
#pragma unroll 16
        for (int d = 0; d < DKP; ++d) {
          s = fmaf(s_quT[d * QTS + lane], k_r[d], s);
          s = fmaf(s_qvT[d * QTS + lane], s_pT[d * KPROWS + pr], s);
          dpr = fmaf(s_doT[d * QTS + lane], v_r[d], dpr);
        }
        s *= scale;
        if (valid_b[j] == 0) s = MASKED;
        const float prob = i_in ? expf(s - lse_i) : 0.f;
        float dpd = dpr;
        pd = prob;
        if (drop.threshold != 0u) {
          const bool keep = dropout_keep(cell, i, j, drop.threshold);
          pd = keep ? prob * drop.inv_keep : 0.f;
          dpd = keep ? dpr * drop.inv_keep : 0.f;
        }
        ds = prob * (dpd - delta_i) * scale;
      }
      s_ds[jj * QTS + lane] = ds;
      // dv_j += sum_i pd_i dout_i;  dk_j += sum_i ds_i qu_i  (lane owns dims)
      for (int ii = 0; ii < QB; ++ii) {
        const float pdi = __shfl_sync(0xffffffffu, pd, ii);
        const float dsi = __shfl_sync(0xffffffffu, ds, ii);
#pragma unroll
        for (int q = 0; q < DPL; ++q) {
          const int d = q * 32 + lane;
          acc_v[r][q] = fmaf(pdi, s_doT[d * QTS + ii], acc_v[r][q]);
          acc_k[r][q] = fmaf(dsi, s_quT[d * QTS + ii], acc_k[r][q]);
        }
      }
    }
    __syncthreads();

    // dp over this tile's diagonals: local row rr collects ds[jj][ii] qv_ii
    // for every pair with (QB-1-ii)+jj == rr; one thread per (row, dim)
    for (int idx = tid; idx < KPROWS * DKP; idx += NT) {
      const int rr = idx / DKP, d = idx % DKP, row = rbase + rr;
      if (d >= dk || row < 0 || row >= n_pos) continue;
      const int jj_lo = max(0, rr - (QB - 1));
      const int jj_hi = min(KB - 1, rr);
      float a = 0.f;
      for (int jj = jj_lo; jj <= jj_hi; ++jj) {
        const int ii = (QB - 1) + jj - rr;
        a = fmaf(s_ds[jj * QTS + ii], s_qvT[d * QTS + ii], a);
      }
      if (a != 0.f) atomicAdd(dp_h + (size_t)row * dk + d, a);
    }
  }

#pragma unroll
  for (int r = 0; r < KPW; ++r) {
    const int j = j0 + warp * KPW + r;
    if (j >= T_len) continue;
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const int d = q * 32 + lane;
      if (d < dk) {
        dk_out[base + (size_t)j * dk + d] = from_f32<T>(acc_k[r][q]);
        dv_out[base + (size_t)j * dk + d] = from_f32<T>(acc_v[r][q]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, query-major: dqu and dqv
// ---------------------------------------------------------------------------

template <typename T, int DPL>
__global__ void __launch_bounds__(NT)
rel_attention_bwd_q_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const T* __restrict__ p, const int* __restrict__ kv_valid,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dqu,
                           T* __restrict__ dqv, int H, int T_len, int dk, float scale,
                           Dropout drop) {
  constexpr int DKP = 32 * DPL;
  extern __shared__ float smem[];
  float* s_qu = smem;                 // [BQ][DKP]
  float* s_qv = s_qu + BQ * DKP;      // [BQ][DKP]
  float* s_do = s_qv + BQ * DKP;      // [BQ][DKP]
  float* s_kT = s_do + BQ * DKP;      // [DKP][KTS]
  float* s_vT = s_kT + DKP * KTS;     // [DKP][KTS]
  float* s_pT = s_vT + DKP * KTS;     // [DKP][PROWS]

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t base = ((size_t)b * H + h) * T_len * dk;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const T* p_h = p + (size_t)h * (2 * T_len - 1) * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const uint32_t cell = dropout_cell(drop.seed, h, b);

  for (int idx = tid; idx < BQ * DKP; idx += NT) {
    const int r = idx / DKP, d = idx % DKP, i = i0 + r;
    const bool ok = i < T_len && d < dk;
    const size_t g = base + (size_t)i * dk + d;
    s_qu[idx] = ok ? to_f32(qu[g]) : 0.f;
    s_qv[idx] = ok ? to_f32(qv[g]) : 0.f;
    s_do[idx] = ok ? to_f32(dout[g]) : 0.f;
  }
  float lse_r[RPW], delta_r[RPW], acc_u[RPW][DPL], acc_p[RPW][DPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    lse_r[r] = i < T_len ? lse[row_base + i] : 0.f;
    delta_r[r] = i < T_len ? delta[row_base + i] : 0.f;
#pragma unroll
    for (int q = 0; q < DPL; ++q) acc_u[r][q] = acc_p[r][q] = 0.f;
  }

  for (int j0 = 0; j0 < T_len; j0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DKP; idx += NT) {
      const int jr = idx / DKP, d = idx % DKP, j = j0 + jr;
      const bool ok = j < T_len && d < dk;
      s_kT[d * KTS + jr] = ok ? to_f32(k[base + (size_t)j * dk + d]) : 0.f;
      s_vT[d * KTS + jr] = ok ? to_f32(v[base + (size_t)j * dk + d]) : 0.f;
    }
    const int rbase = (T_len - 1) - (i0 + BQ - 1) + j0;
    for (int idx = tid; idx < PROWS * DKP; idx += NT) {
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
      const int i = i0 + ii;
      const int pr = (BQ - 1 - ii) + lane;
      const float* qu_r = s_qu + ii * DKP;
      const float* qv_r = s_qv + ii * DKP;
      const float* do_r = s_do + ii * DKP;
      float s = 0.f, dpr = 0.f;
#pragma unroll 16
      for (int d = 0; d < DKP; ++d) {
        s = fmaf(qu_r[d], s_kT[d * KTS + lane], s);
        s = fmaf(qv_r[d], s_pT[d * PROWS + pr], s);
        dpr = fmaf(do_r[d], s_vT[d * KTS + lane], dpr);
      }
      s *= scale;
      if (!j_valid) s = MASKED;
      const float prob = (j_in && i < T_len) ? expf(s - lse_r[r]) : 0.f;
      float dpd = dpr;
      if (drop.threshold != 0u)
        dpd = dropout_keep(cell, i, j, drop.threshold) ? dpr * drop.inv_keep : 0.f;
      const float ds = prob * (dpd - delta_r[r]) * scale;
      for (int jj = 0; jj < BK; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int q = 0; q < DPL; ++q) {
          const int d = q * 32 + lane;
          acc_u[r][q] = fmaf(dsj, s_kT[d * KTS + jj], acc_u[r][q]);
          acc_p[r][q] = fmaf(dsj, s_pT[d * PROWS + (BQ - 1 - ii) + jj], acc_p[r][q]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = i0 + warp * RPW + r;
    if (i >= T_len) continue;
#pragma unroll
    for (int q = 0; q < DPL; ++q) {
      const int d = q * 32 + lane;
      if (d < dk) {
        dqu[base + (size_t)i * dk + d] = from_f32<T>(acc_u[r][q]);
        dqv[base + (size_t)i * dk + d] = from_f32<T>(acc_p[r][q]);
      }
    }
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

template <typename T, int DPL>
int launch_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const void* kv_valid, void* out, void* lse, int B, int H, int T_len, int dk,
               float scale, Dropout drop, cudaStream_t stream) {
  constexpr int DKP = 32 * DPL;
  const size_t smem = (size_t)(2 * BQ * DKP + DKP * KTS + BK * DKP + DKP * PROWS) * sizeof(float);
  cudaError_t e = allow_smem(rel_attention_fwd_kernel<T, DPL>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  rel_attention_fwd_kernel<T, DPL><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), static_cast<const int*>(kv_valid),
      static_cast<T*>(out), static_cast<float*>(lse), H, T_len, dk, scale, drop);
  return (int)cudaGetLastError();
}

template <typename T, int DPL>
int launch_bwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const void* kv_valid, const void* out, const void* lse, const void* dout,
               void* delta, void* dqu, void* dqv, void* dk_out, void* dv_out, void* dp, int B,
               int H, int T_len, int dk, float scale, Dropout drop, cudaStream_t stream) {
  constexpr int DKP = 32 * DPL;
  const T* qu_ = static_cast<const T*>(qu);
  const T* qv_ = static_cast<const T*>(qv);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* p_ = static_cast<const T*>(p);
  const T* dout_ = static_cast<const T*>(dout);
  const int* valid_ = static_cast<const int*>(kv_valid);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const long long rows = (long long)B * H * T_len;
  rel_attention_delta_kernel<T><<<(unsigned)((rows + NW - 1) / NW), NT, 0, stream>>>(
      static_cast<const T*>(out), dout_, delta_, rows, dk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = (size_t)(2 * KB * DKP + 3 * DKP * QTS + DKP * KPROWS + KB * QTS + 2 * QB)
                         * sizeof(float);
  e = allow_smem(rel_attention_bwd_kv_kernel<T, DPL>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_kv((T_len + KB - 1) / KB, H, B);
  rel_attention_bwd_kv_kernel<T, DPL><<<grid_kv, NT, smem_kv, stream>>>(
      qu_, qv_, k_, v_, p_, valid_, dout_, lse_, delta_, static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), static_cast<float*>(dp), H, T_len, dk, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_q = (size_t)(3 * BQ * DKP + 2 * DKP * KTS + DKP * PROWS) * sizeof(float);
  e = allow_smem(rel_attention_bwd_q_kernel<T, DPL>, smem_q);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((T_len + BQ - 1) / BQ, H, B);
  rel_attention_bwd_q_kernel<T, DPL><<<grid_q, NT, smem_q, stream>>>(
      qu_, qv_, k_, v_, p_, valid_, dout_, lse_, delta_, static_cast<T*>(dqu),
      static_cast<T*>(dqv), H, T_len, dk, scale, drop);
  return (int)cudaGetLastError();
}

Dropout make_dropout(int seed, unsigned int threshold, float inv_keep) {
  Dropout d;
  d.seed = (uint32_t)seed;
  d.threshold = (uint32_t)threshold;
  d.inv_keep = inv_keep;
  return d;
}

}  // namespace

extern "C" {

// qu, qv, k, v, out: [B, H, T, dk]; p: [H, 2T-1, dk]; kv_valid: int32 [B, T];
// lse: float32 [B, H, T] or null (not written).  dtype: 0 = float32,
// 1 = bfloat16 (all float operands share it).  Dropout keeps a probability
// when its hash is >= threshold (= uint32(rate * 2^32); 0 keeps all) and
// scales the kept ones by inv_keep.
int rel_attention_fwd(const void* qu, const void* qv, const void* k, const void* v,
                      const void* p, const void* kv_valid, void* out, void* lse, int B, int H,
                      int T_len, int dk, float scale, int seed, unsigned int threshold,
                      float inv_keep, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
#define REL_FWD(TYPE, DPL) \
  launch_fwd<TYPE, DPL>(qu, qv, k, v, p, kv_valid, out, lse, B, H, T_len, dk, scale, drop, s)
  if (dtype == 0) {
    if (dk <= 32) return REL_FWD(float, 1);
    if (dk <= 64) return REL_FWD(float, 2);
    if (dk <= 128) return REL_FWD(float, 4);
  } else if (dtype == 1) {
    if (dk <= 32) return REL_FWD(__nv_bfloat16, 1);
    if (dk <= 64) return REL_FWD(__nv_bfloat16, 2);
    if (dk <= 128) return REL_FWD(__nv_bfloat16, 4);
  }
#undef REL_FWD
  return (int)cudaErrorInvalidValue;
}

// The backward of rel_attention_fwd: three kernels on one stream (delta,
// key-major, query-major).  out, dout, dqu, dqv, dk_out, dv_out: [B, H, T, dk]
// in dtype; lse, delta (scratch): float32 [B, H, T]; dp: float32
// [H, 2T-1, dk], zeroed by the caller, summed over the batch.
int rel_attention_bwd(const void* qu, const void* qv, const void* k, const void* v,
                      const void* p, const void* kv_valid, const void* out, const void* lse,
                      const void* dout, void* delta, void* dqu, void* dqv, void* dk_out,
                      void* dv_out, void* dp, int B, int H, int T_len, int dk, float scale,
                      int seed, unsigned int threshold, float inv_keep, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
#define REL_BWD(TYPE, DPL)                                                                   \
  launch_bwd<TYPE, DPL>(qu, qv, k, v, p, kv_valid, out, lse, dout, delta, dqu, dqv, dk_out, \
                        dv_out, dp, B, H, T_len, dk, scale, drop, s)
  if (dtype == 0) {
    if (dk <= 32) return REL_BWD(float, 1);
    if (dk <= 64) return REL_BWD(float, 2);
    if (dk <= 128) return REL_BWD(float, 4);
  } else if (dtype == 1) {
    if (dk <= 32) return REL_BWD(__nv_bfloat16, 1);
    if (dk <= 64) return REL_BWD(__nv_bfloat16, 2);
    if (dk <= 128) return REL_BWD(__nv_bfloat16, 4);
  }
#undef REL_BWD
  return (int)cudaErrorInvalidValue;
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
