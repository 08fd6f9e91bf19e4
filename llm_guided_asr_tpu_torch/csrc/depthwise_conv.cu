// Depthwise 1-D convolution forward, SAME zero padding, for Hopper (sm_90a).
//
// Replaces the TPU kernel llm_guided_asr_tpu/ops/depthwise_conv.py
// _fwd_kernel (called through _pallas_fwd): y[b,t,c] = sum_k x[b,t+k-pad_l,c]
// * w[k,c] with pad_l = (K-1)//2 (lax SAME convention; an even K pads one
// less on the left), accumulated in float32, stored in the input type.
//
// What bounds it on this card: memory.  At the Conformer's shapes
// ([1,312,256] x [31,256]) it moves ~0.7 MB and does 5 MFLOP -- a fraction
// of a microsecond at 3.35 TB/s, so in practice the launch dominates.
// Design: one block per (T tile, C chunk, batch row).  The T tile plus its
// K-1 halo rows is staged once in shared memory, with the threads laid on
// C so that every global load and store is coalesced and every shared-memory
// read is bank-conflict free; each thread then walks its channel's K taps
// out of shared memory for TT output rows, reading x from device memory
// (TT+K-1)/TT times instead of K times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TT = 16;  // output rows per block
constexpr int CB = 64;  // channels per block (= threads)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(CB)
dwconv1d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int T_len, int C, int K) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [(TT + K - 1)][CB]
  float* ws = smem + (TT + K - 1) * CB;  // [K][CB]
  const int t0 = blockIdx.x * TT;
  const int c = blockIdx.y * CB + threadIdx.x;
  const int b = blockIdx.z;
  const int pad_l = (K - 1) / 2;
  const bool c_ok = c < C;
  const T* xb = x + (size_t)b * T_len * C;

  for (int r = 0; r < TT + K - 1; ++r) {
    const int t = t0 - pad_l + r;
    float v = 0.f;
    if (c_ok && t >= 0 && t < T_len) v = to_f32(xb[(size_t)t * C + c]);
    xs[r * CB + threadIdx.x] = v;
  }
  for (int k = 0; k < K; ++k)
    ws[k * CB + threadIdx.x] = c_ok ? to_f32(w[(size_t)k * C + c]) : 0.f;
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
int launch(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
           cudaStream_t stream) {
  const size_t smem = (size_t)(TT + K - 1 + K) * CB * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dwconv1d_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((T_len + TT - 1) / TT, (C + CB - 1) / CB, B);
  dwconv1d_fwd_kernel<T><<<grid, CB, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), T_len, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it)
int dwconv1d_fwd(const void* x, const void* w, void* y, int B, int T_len, int C, int K,
                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, y, B, T_len, C, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, y, B, T_len, C, K, s);
  return (int)cudaErrorInvalidValue;
}

const char* dwconv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
