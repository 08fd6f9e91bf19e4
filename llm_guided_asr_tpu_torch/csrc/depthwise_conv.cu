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
// 4*B*T*C*K FLOPs (0.63 GFLOP, 9 us on the f32 cores).  At the serving shape
// ([1, 312, 256], 0.6 MB, 0.2 us of bytes) nothing of that binds: the time is
// the launch and the latency of one round of loads and one chain of K FMAs.
// Design: the forward and dx are one stencil kernel (dx is the forward with
// the taps flipped and the padding mirrored).  A thread owns R consecutive
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
// thread in 80 blocks of 2 warps ran before).  dw stages a T tile of x (with
// halo) and dy in shared memory, sums its K products per channel in
// registers and adds one float32 atomicAdd per (k, c) per block into the
// zeroed dw.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int SC = 32;  // channels per stencil block (one warp's lanes)
constexpr int SG = 4;   // row groups per stencil block (= warps)
constexpr int TW = 64;  // rows per block (dw)
constexpr int CB = 64;  // channels per block (= threads) (dw)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T>
__global__ void __launch_bounds__(CB)
dwconv1d_dw_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   float* __restrict__ dw, int T_len, int C, int K) {
  extern __shared__ float smem[];
  float* xs = smem;                       // [(TW + K - 1)][CB]
  float* gs = smem + (TW + K - 1) * CB;   // [TW][CB]
  const int t0 = blockIdx.x * TW;
  const int c = blockIdx.y * CB + threadIdx.x;
  const int b = blockIdx.z;
  const int pad_l = (K - 1) / 2;
  if (c >= C) return;  // no block barrier below: each thread owns its column
  const T* xb = x + (size_t)b * T_len * C;
  const T* gb = dy + (size_t)b * T_len * C;
  const int rows = min(TW, T_len - t0);

  for (int r = 0; r < rows + K - 1; ++r) {
    const int t = t0 - pad_l + r;
    xs[r * CB + threadIdx.x] = (t >= 0 && t < T_len) ? to_f32(xb[(size_t)t * C + c]) : 0.f;
  }
  for (int r = 0; r < rows; ++r) gs[r * CB + threadIdx.x] = to_f32(gb[(size_t)(t0 + r) * C + c]);

  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
    for (int tt = 0; tt < rows; ++tt)
      acc = fmaf(gs[tt * CB + threadIdx.x], xs[(tt + k) * CB + threadIdx.x], acc);
    atomicAdd(dw + (size_t)k * C + c, acc);
  }
}

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  auto fills = [&](int r) {
    return (long)B * ((T_len + r * SG - 1) / (r * SG)) * ((C + SC - 1) / SC) >= 2L * sms;
  };
  if (fills(16)) return launch_stencil_rows<T, FLIP, 16>(x, w, y, B, T_len, C, K, stream);
  if (fills(4)) return launch_stencil_rows<T, FLIP, 4>(x, w, y, B, T_len, C, K, stream);
  return launch_stencil_rows<T, FLIP, 2>(x, w, y, B, T_len, C, K, stream);
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw, int B,
               int T_len, int C, int K, cudaStream_t stream) {
  const int code = launch_stencil<T, true>(dy, w, dx, B, T_len, C, K, stream);
  if (code != 0) return code;
  const size_t smem = (size_t)(2 * TW + K - 1) * CB * sizeof(float);
  cudaError_t e = allow_smem(dwconv1d_dw_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + TW - 1) / TW, (C + CB - 1) / CB, B);
  dwconv1d_dw_kernel<T><<<grid, CB, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<float*>(dw), T_len, C, K);
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

// The backward of dwconv1d_fwd: dx [B, T, C] in dtype, dw float32 [K, C]
// zeroed by the caller.  Two kernels on one stream.
int dwconv1d_bwd(const void* dy, const void* x, const void* w, void* dx, void* dw, int B,
                 int T_len, int C, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(dy, x, w, dx, dw, B, T_len, C, K, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(dy, x, w, dx, dw, B, T_len, C, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* dwconv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
