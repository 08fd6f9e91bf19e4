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
// 4*B*T*C*K FLOPs (0.63 GFLOP, 9 us on the f32 cores).
// Design: one block per (T tile, C chunk, batch row), threads laid on C so
// that every global load and store is coalesced and every shared-memory
// access is bank-conflict free.  The forward and dx stage a T tile plus
// its K-1 halo rows once in shared memory and walk the K taps out of it,
// reading the input (TT+K-1)/TT times instead of K times; dx is the
// forward stencil with the taps flipped and the padding mirrored.  dw
// stages a longer T tile of x (with halo) and dy, sums its K products per
// channel in registers and adds one float32 atomicAdd per (k, c) per
// block into the zeroed dw.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TT = 16;  // output rows per block (forward, dx)
constexpr int TW = 64;  // rows per block (dw)
constexpr int CB = 64;  // channels per block (= threads)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// FLIP = false: the forward, y = x (*) w with pad_l on the left.
// FLIP = true: dx = dy (*) flip(w) with pad_r on the left.
template <typename T, bool FLIP>
__global__ void __launch_bounds__(CB)
dwconv1d_stencil_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int T_len, int C, int K) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [(TT + K - 1)][CB]
  float* ws = smem + (TT + K - 1) * CB;  // [K][CB]
  const int t0 = blockIdx.x * TT;
  const int c = blockIdx.y * CB + threadIdx.x;
  const int b = blockIdx.z;
  const int pad = FLIP ? K - 1 - (K - 1) / 2 : (K - 1) / 2;
  const bool c_ok = c < C;
  const T* xb = x + (size_t)b * T_len * C;

  for (int r = 0; r < TT + K - 1; ++r) {
    const int t = t0 - pad + r;
    float v = 0.f;
    if (c_ok && t >= 0 && t < T_len) v = to_f32(xb[(size_t)t * C + c]);
    xs[r * CB + threadIdx.x] = v;
  }
  for (int k = 0; k < K; ++k) {
    const int kw = FLIP ? K - 1 - k : k;
    ws[k * CB + threadIdx.x] = c_ok ? to_f32(w[(size_t)kw * C + c]) : 0.f;
  }
  // each thread reads back only its own column: no block barrier needed
  if (!c_ok) return;

  T* yb = y + (size_t)b * T_len * C;
  const int rows = min(TT, T_len - t0);
  for (int tt = 0; tt < rows; ++tt) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k)
      acc = fmaf(xs[(tt + k) * CB + threadIdx.x], ws[k * CB + threadIdx.x], acc);
    yb[(size_t)(t0 + tt) * C + c] = from_f32<T>(acc);
  }
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

template <typename T, bool FLIP>
int launch_stencil(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(TT + K - 1 + K) * CB * sizeof(float);
  cudaError_t e = allow_smem(dwconv1d_stencil_kernel<T, FLIP>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + TT - 1) / TT, (C + CB - 1) / CB, B);
  dwconv1d_stencil_kernel<T, FLIP><<<grid, CB, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), T_len, C, K);
  return (int)cudaGetLastError();
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
