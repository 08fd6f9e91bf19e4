// Depthwise 1-D convolution, SAME zero padding, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of llm_guided_asr_tpu/ops/depthwise_conv.py:
// _fwd_kernel (called through _pallas_fwd) and _bwd_kernel (called through
// _pallas_bwd).  With pad_l = (K-1)//2 and pad_r = K-1-pad_l (lax SAME
// convention; an even K pads one less on the left):
//
//   y[b,t,c]  = sum_k x[b, t+k-pad_l, c] * w[k,c]
//   dx[b,t,c] = sum_k dy[b, t+k-pad_r, c] * w[K-1-k, c]     (flipped taps, mirrored pad)
//   dw[k,c]   = sum_{b,t} dy[b,t,c] * x[b, t+k-pad_l, c]
//
// accumulated in float32; y and dx are stored in the input type, dw in
// float32 (the wrapper casts it to w's type).
//
// What bounds it on this card: memory.  The forward moves x in and y out;
// the backward moves x and dy in and dx out (at the training shapes,
// [64, 312, 256] x [31, 256] in float32, 61 MB: 18 us at 3.35 TB/s) and does
// 4*B*T*C*K FLOPs (0.63 GFLOP, 9 us on the f32 cores).  At the serving
// shape ([1, 312, 256], 0.6 MB, 0.2 us of bytes) nothing of that binds: the
// time is the launch and the latency of one round of loads and one chain
// of K FMAs.
//
// The forward and dx are one stencil kernel (dx is the forward with the
// taps flipped and the padding mirrored).  A thread owns R consecutive
// output rows of one channel, threads laid on C (every load and store
// coalesced), and slides a window of R inputs down the K taps in registers:
// the R accumulators are independent FMA chains, and a thread loads each
// tap's weight once and R+K-1 inputs for its R outputs (overlapping windows
// of neighbouring row groups meet in L1).  K is a template for the
// configs' kernel sizes (31, 15, 8), so the tap loop unrolls and every load
// issues at once; any other K runs the same kernel with a runtime K.  R is
// chosen from the grid: the most of 16, 4 and 2 rows a thread that still
// gives two blocks an SM (16 at the training shapes; 2 at B = 1 serving,
// [1, 312, 256]: 312 blocks of 4 warps, where one chain of 16 x 31 FMAs a
// thread in 80 blocks of 2 warps ran before).
//
// dw is a reduction over B*T rows into K*C sums, in two kernels with no
// atomics.  dwconv1d_dw_kernel: a warp owns 32 neighbouring channels of one
// slab of rows of one batch row (a slab never crosses a batch row, so the
// zero padding stays per row).  It streams its rows of dy and x through its
// own ring in shared memory by 16-byte cp.async, two groups of 8 rows in
// flight, so no lane waits on device memory row by row; each lane keeps K
// float32 accumulators and a ring of the last K inputs in registers and
// issues K independent FMAs a row.  The register ring's slots are fixed at
// compile time by unrolling the row loop K times (K a template, as the
// stencil's); any other K, or rows that are not 16-byte aligned, run
// dwconv1d_dw_taps_kernel, tap by tap from global memory, one partial a
// slab.  A block holds up to 4 consecutive slabs of one batch row and adds
// their sums in slab order into one [K, C] partial of a float32 workspace;
// dwconv1d_dw_sum_kernel adds the partials in a fixed order (eight warps
// sum eight runs of consecutive partials, then the eight sums are added in
// order), so a repeat call is bitwise equal, dw included.  What bounds dw:
// the bytes of x and dy (41 MB in float32 at the training shape, 12 us),
// plus the halo of K-1 rows a slab and the partials; its FMAs (4.7 us on
// the f32 cores) hide under them.  The slabs a row come from the grid
// (dwconv1d_bwd_slabs): the smallest power of two that gives 12 warps an
// SM, with slabs of at least K rows (4 at [64, 312, 256], 32 at the
// long-form [8, 1874, 256]): fewer leave warps waiting on memory, more
// add halo and partials.  Of rings of 2, 4 and 6 groups, 2 ran fastest
// (the least shared memory a block); the block's sum cuts the partials'
// traffic by the slabs it holds.

#include <cstdint>

#include "tensor_core.cuh"  // to_f32, from_f32, cp.async

namespace {

constexpr int SC = 32;  // channels per stencil block (one warp's lanes)
constexpr int SG = 4;   // row groups per stencil block (= warps)
constexpr int DW_WARPS = 4;  // most warps a dw block, one (slab, 32 channels) each
constexpr int DW_GROUP = 8;  // rows a dw warp copies at once
constexpr int DW_RING = 16;  // rows of a dw warp's ring in shared memory
constexpr int SUM_WARPS = 8; // warps per dw sum block, one run of slabs each
constexpr int SUM_G = 16;    // partials whose loads one warp issues together
constexpr int MAX_SLABS = 64;


// FLIP = false: the forward, y = x (*) w with pad_l on the left.
// FLIP = true: dx = dy (*) flip(w) with pad_r on the left.
// KT > 0: K = KT at compile time; KT = 0: K = k_rt.  Rows [t0, t0 + R) of
// channel c: win[r] holds x[t0 + r + k - pad] at tap k.
template <typename T, bool FLIP, int KT, int R>
__global__ void __launch_bounds__(SC * SG)
dwconv1d_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int T_len, int C, int k_rt) {
  const int K = KT > 0 ? KT : k_rt;
  const int c = blockIdx.y * SC + threadIdx.x % SC;
  const int t0 = (blockIdx.x * SG + threadIdx.x / SC) * R;
  const int b = blockIdx.z;
  if (c >= C || t0 >= T_len) return;  // no block barrier: each thread owns its outputs
  const int pad = FLIP ? K - 1 - (K - 1) / 2 : (K - 1) / 2;
  const T* xc = x + (size_t)b * T_len * C + c;
  auto load = [&](int t) { return t >= 0 && t < T_len ? to_f32(xc[(size_t)t * C]) : 0.f; };

  float win[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    win[r] = load(t0 - pad + r);
    acc[r] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float wk = to_f32(w[(size_t)(FLIP ? K - 1 - k : k) * C + c]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(win[r], wk, acc[r]);
#pragma unroll
    for (int r = 0; r + 1 < R; ++r) win[r] = win[r + 1];
    if (k + 1 < K) win[R - 1] = load(t0 - pad + k + R);
  }
  T* yc = y + (size_t)b * T_len * C + c;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (t0 + r < T_len) yc[(size_t)(t0 + r) * C] = from_f32<T>(acc[r]);
}

// dw partials: a block of W = min(4, slabs) warps owns channels
// [c0, c0 + 32) of W consecutive slabs of batch row b, a warp one slab
// [t_begin, t_end) and a lane one channel.  A warp streams its rows through
// its own ring of DW_RING rows in shared memory by 16-byte cp.async, in
// groups of DW_GROUP rows, DW_RING / DW_GROUP groups in flight: for row t
// the ring holds dy[t] and x[t - pad_l + K - 1], the input entering the
// window.  Each lane slides a ring of the last K inputs in registers (slot
// (i + k) % K holds x[t - pad_l + k] at row t = t_begin + m * K + i: the row
// loop is unrolled K times) and issues K FMAs a row.  The block then adds
// its W slabs' sums in slab order and writes one partial,
// work[b * slabs / W + slab / W][k][c].  Needs C a multiple of 16 bytes'
// worth of elements and 16-byte aligned x and dy.
template <typename T, int KT>
__global__ void __launch_bounds__(DW_WARPS * 32)
dwconv1d_dw_kernel(const T* __restrict__ dy, const T* __restrict__ x, float* __restrict__ work,
                   int T_len, int C, int slabs) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int CHUNKS = 32 / V;     // copies a row of the warp
  constexpr int IN_FLIGHT = DW_RING / DW_GROUP;
  constexpr int RING_BYTES = 2 * DW_WARPS * DW_RING * 32 * sizeof(T);
  constexpr int SUM_BYTES = DW_WARPS * KT * 32 * sizeof(float);
  __shared__ __align__(16) unsigned char smem[RING_BYTES > SUM_BYTES ? RING_BYTES : SUM_BYTES];
  const int n_warps = blockDim.x / 32, wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (C + 31) / 32;
  const int part = blockIdx.x / groups;  // b * (slabs / n_warps) + slab / n_warps
  const int c0 = (blockIdx.x % groups) * 32, c = c0 + lane;
  const int b = part / (slabs / n_warps), s = part % (slabs / n_warps) * n_warps + wid;
  const int rows = (T_len + slabs - 1) / slabs;
  const int t_begin = min(s * rows, T_len), t_end = min(t_begin + rows, T_len);
  const int pad_l = (KT - 1) / 2;
  const T* xb = x + (size_t)b * T_len * C;
  const T* gb = dy + (size_t)b * T_len * C;
  T(*rx)[32] = reinterpret_cast<T(*)[32]>(smem) + wid * DW_RING;
  T(*rg)[32] = reinterpret_cast<T(*)[32]>(smem) + (DW_WARPS + wid) * DW_RING;

  // group j: rows t_begin + DW_GROUP * j + r into ring rows (DW_GROUP * j + r) % DW_RING;
  // rows outside the data are zeros
  auto issue = [&](int j) {
#pragma unroll
    for (int i = lane; i < 2 * DW_GROUP * CHUNKS; i += 32) {
      const bool is_x = i < DW_GROUP * CHUNKS;
      const int r = (i / CHUNKS) % DW_GROUP, ch = (i % CHUNKS) * V;
      const int row = t_begin + DW_GROUP * j + r;
      const int t = is_x ? row - pad_l + KT - 1 : row;
      const bool ok = (is_x ? t >= 0 && t < T_len : t < t_end) && c0 + ch < C;
      const T* src = (is_x ? xb : gb) + (ok ? (size_t)t * C + c0 + ch : 0);
      cp_async16(&(is_x ? rx : rg)[(DW_GROUP * j + r) % DW_RING][ch], src, ok);
    }
  };

  const int n = t_end - t_begin;
  const int n_groups = (n + DW_GROUP - 1) / DW_GROUP;
#pragma unroll
  for (int j = 0; j < IN_FLIGHT; ++j) {
    if (j < n_groups) issue(j);
    cp_async_commit();
  }
  float ring[KT], acc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const int t = t_begin - pad_l + j;
    ring[j] = j + 1 < KT && c < C && t >= 0 && t < T_len ? to_f32(xb[(size_t)t * C + c]) : 0.f;
    acc[j] = 0.f;
  }
  for (int m = 0; m < n; m += KT) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      const int r = m + i;  // row t_begin + r
      if (r < n) {
        if (r % DW_GROUP == 0) {  // group r / DW_GROUP must have landed
          if (r > 0) {  // the group before it is read: refill its ring rows
            __syncwarp();
            if (r / DW_GROUP - 1 + IN_FLIGHT < n_groups) issue(r / DW_GROUP - 1 + IN_FLIGHT);
            cp_async_commit();
          }
          cp_async_wait<IN_FLIGHT - 1>();
          __syncwarp();
        }
        ring[(i + KT - 1) % KT] = to_f32(rx[r % DW_RING][lane]);
        const float g = to_f32(rg[r % DW_RING][lane]);
#pragma unroll
        for (int k = 0; k < KT; ++k) acc[k] = fmaf(g, ring[(i + k) % KT], acc[k]);
      }
    }
  }

  // the block's slabs, added in slab order, into one partial
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the sums take its place
  float* sums = reinterpret_cast<float*>(smem);  // [n_warps][KT][32]
#pragma unroll
  for (int k = 0; k < KT; ++k) sums[(wid * KT + k) * 32 + lane] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < KT * 32; i += blockDim.x) {
    float sum = sums[i];
    for (int w = 1; w < n_warps; ++w) sum += sums[w * KT * 32 + i];
    if (c0 + i % 32 < C) work[((size_t)part * KT + i / 32) * C + c0 + i % 32] = sum;
  }
}

// dw partials for any K and layout: a warp owns 32 channels of one slab
// (as the staged kernel's partials) and sums tap by tap from global memory.
template <typename T>
__global__ void __launch_bounds__(DW_WARPS * 32)
dwconv1d_dw_taps_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                        float* __restrict__ work, int B, int T_len, int C, int K, int slabs) {
  const int groups = (C + 31) / 32;
  const int warp = blockIdx.x * DW_WARPS + threadIdx.x / 32;
  const int q = warp / groups;  // b * slabs + s
  const int c = (warp % groups) * 32 + threadIdx.x % 32;
  if (q >= B * slabs || c >= C) return;  // no block barrier: each thread owns its outputs
  const int b = q / slabs, s = q % slabs;
  const int rows = (T_len + slabs - 1) / slabs;
  const int t_begin = min(s * rows, T_len), t_end = min(t_begin + rows, T_len);
  const int pad_l = (K - 1) / 2;
  const T* xc = x + (size_t)b * T_len * C + c;
  const T* gc = dy + (size_t)b * T_len * C + c;
  float* out = work + (size_t)q * K * C + c;
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
    for (int t = t_begin; t < t_end; ++t) {
      const int tx = t + k - pad_l;
      if (tx >= 0 && tx < T_len) acc = fmaf(to_f32(gc[(size_t)t * C]), to_f32(xc[(size_t)tx * C]), acc);
    }
    out[(size_t)k * C] = acc;
  }
}

// dw[k, c] = sum over the n partials work[q][k][c]: warp g of a block sums
// the run of partials [g * per, (g + 1) * per) in order, then the runs'
// sums are added in order of g.
__global__ void __launch_bounds__(SUM_WARPS * 32)
dwconv1d_dw_sum_kernel(const float* __restrict__ work, float* __restrict__ dw, int n, int KC) {
  __shared__ float part[SUM_WARPS][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;  // k * C + c
  const int per = (n + SUM_WARPS - 1) / SUM_WARPS;
  const int q0 = min(g * per, n), q1 = min(q0 + per, n);
  float acc = 0.f;
  if (i < KC) {
    for (int q = q0; q < q1; q += SUM_G) {
      float p[SUM_G];
#pragma unroll
      for (int j = 0; j < SUM_G; ++j) p[j] = q + j < q1 ? work[(size_t)(q + j) * KC + i] : 0.f;
#pragma unroll
      for (int j = 0; j < SUM_G; ++j)
        if (q + j < q1) acc += p[j];
    }
  }
  part[g][lane] = acc;
  __syncthreads();
  if (g == 0 && i < KC) {
    float sum = part[0][lane];
#pragma unroll
    for (int j = 1; j < SUM_WARPS; ++j) sum += part[j][lane];
    dw[i] = sum;
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <typename T, bool FLIP, int R>
int launch_stencil_rows(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
                        cudaStream_t stream) {
  dim3 grid((T_len + R * SG - 1) / (R * SG), (C + SC - 1) / SC, B);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  auto run = [&](auto kernel) { kernel<<<grid, SC * SG, 0, stream>>>(xp, wp, yp, T_len, C, K); };
  switch (K) {
    case 31: run(dwconv1d_stencil_kernel<T, FLIP, 31, R>); break;
    case 15: run(dwconv1d_stencil_kernel<T, FLIP, 15, R>); break;
    case 8: run(dwconv1d_stencil_kernel<T, FLIP, 8, R>); break;
    default: run(dwconv1d_stencil_kernel<T, FLIP, 0, R>);
  }
  return (int)cudaGetLastError();
}

// the most rows a thread (16, 4, 2) that still leaves two blocks an SM
template <typename T, bool FLIP>
int launch_stencil(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
                   cudaStream_t stream) {
  int sms = 0;
  const int code = sm_count(&sms);
  if (code != 0) return code;
  auto fills = [&](int r) {
    return (long)B * ((T_len + r * SG - 1) / (r * SG)) * ((C + SC - 1) / SC) >= 2L * sms;
  };
  if (fills(16)) return launch_stencil_rows<T, FLIP, 16>(x, w, y, B, T_len, C, K, stream);
  if (fills(4)) return launch_stencil_rows<T, FLIP, 4>(x, w, y, B, T_len, C, K, stream);
  return launch_stencil_rows<T, FLIP, 2>(x, w, y, B, T_len, C, K, stream);
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw, void* work,
               int slabs, int B, int T_len, int C, int K, cudaStream_t stream) {
  int code = launch_stencil<T, true>(dy, w, dx, B, T_len, C, K, stream);
  if (code != 0 || K == 0) return code;
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  float* wk = static_cast<float*>(work);
  // the staged kernel copies 16-byte pieces of rows
  const bool aligned = C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const int groups = (C + 31) / 32;
  const int n_warps = min(DW_WARPS, slabs);  // slabs a block: a power of two, as slabs is
  int parts = B * slabs / n_warps;
  auto run = [&](auto kernel) {
    kernel<<<parts * groups, n_warps * 32, 0, stream>>>(dyp, xp, wk, T_len, C, slabs);
  };
  if (aligned && K == 31) {
    run(dwconv1d_dw_kernel<T, 31>);
  } else if (aligned && K == 15) {
    run(dwconv1d_dw_kernel<T, 15>);
  } else if (aligned && K == 8) {
    run(dwconv1d_dw_kernel<T, 8>);
  } else {
    parts = B * slabs;
    dwconv1d_dw_taps_kernel<T><<<(parts * groups + DW_WARPS - 1) / DW_WARPS, DW_WARPS * 32, 0,
                                 stream>>>(dyp, xp, wk, B, T_len, C, K, slabs);
  }
  code = (int)cudaGetLastError();
  if (code != 0) return code;
  dwconv1d_dw_sum_kernel<<<(K * C + 31) / 32, SUM_WARPS * 32, 0, stream>>>(
      wk, static_cast<float*>(dw), parts, K * C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it)
int dwconv1d_fwd(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_stencil<float, false>(x, w, y, B, T_len, C, K, s);
  if (dtype == 1) return launch_stencil<__nv_bfloat16, false>(x, w, y, B, T_len, C, K, s);
  return (int)cudaErrorInvalidValue;
}

// The slabs a batch row dwconv1d_bwd cuts T into for dw on the current
// device: the smallest power of two that gives 12 warps an SM, at most 64,
// with slabs of at least K rows.  Launches nothing; a negative value is a
// CUDA error code, negated.
int dwconv1d_bwd_slabs(int B, int T_len, int C, int K) {
  int sms = 0;
  const int code = sm_count(&sms);
  if (code != 0) return -code;
  const long warps = (long)B * ((C + 31) / 32);
  int n = 1;
  while (n < MAX_SLABS && warps * n < 12L * sms && (T_len + 2 * n - 1) / (2 * n) >= K) n *= 2;
  return n;
}

// The backward of dwconv1d_fwd: dx [B, T, C] in dtype and dw float32 [K, C].
// slabs: a power of two; work: float32 [B * slabs, K, C], room for the
// partial sums of dw (a slab of no rows adds zeros).  Three kernels on one
// stream: the dx stencil, the partials, their sum in a fixed order.
int dwconv1d_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw, void* work,
                 int slabs, int B, int T_len, int C, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slabs < 1 || (slabs & (slabs - 1)) || !work) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_bwd<float>(dy, x, w, dx, dw, work, slabs, B, T_len, C, K, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(dy, x, w, dx, dw, work, slabs, B, T_len, C, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* dwconv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
