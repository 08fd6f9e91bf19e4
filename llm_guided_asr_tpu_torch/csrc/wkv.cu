// RWKV WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// Per batch row b and channel c, over t = 0 .. T-1, with w = -exp(time_decay)
// and u = time_first, the state (aa, bb, pp) stands for the sums
// A = aa * e^pp and B = bb * e^pp, kept under a running maximum pp:
//
//   ww = u + k[t];  q = max(pp, ww);  e1 = exp(pp - q);  e2 = exp(ww - q)
//   y[t] = (e1 * aa + e2 * v[t]) / (e1 * bb + e2)
//   ww = pp + w;    q = max(ww, k[t]); e1 = exp(ww - q);  e2 = exp(k[t] - q)
//   aa = e1 * aa + e2 * v[t];  bb = e1 * bb + e2;  pp = q
//
// All arithmetic is float32 with the accurate expf (never the fast-math
// __expf) and IEEE division, so that the forward agrees with the plain
// loop of ops/wkv.py to about 1e-6.
//
// wkv_fwd replaces the TPU kernel llm_guided_asr_tpu/ops/wkv.py _wkv_kernel
// (:79, called through wkv_pallas :109).  The TPU kernel keeps a whole
// [T, C] tile in VMEM and walks t on the core; here each (b, c) walks its
// own column, so nothing is staged: one thread per (b, c) carries
// (aa, bb, pp) in registers, and at every step the threads of a warp read
// and write 32 neighbouring channels (coalesced).  The loads of step t+1
// are issued before step t's arithmetic, since they do not depend on it.
//
// wkv_bwd replaces the VJP of the scan (llm_guided_asr_tpu/ops/wkv.py :179,
// jax.vjp of wkv_scan), for the state the forward starts from (aa = bb = 0,
// pp = -1e38).  The maximum cancels out of every output, since (aa, bb)
// only matter through aa * e^pp and bb * e^pp, so the kernel differentiates
// the recurrence in A and B directly and keeps every quantity under a
// running maximum as the forward does.  One thread per (b, c), two sweeps:
//
//   forward sweep: recompute the state; carry dA/dw and dB/dw (normalized
//     by e^pp as A and B are) and sum gw and gu in registers; store, per
//     step, q_t = gy[t] / (e1 * bb + e2) and r_t = u + k[t] - max into the
//     gk and gv buffers, which the reverse sweep overwrites in place;
//   reverse sweep: carry the adjoint of (A, B) under its own running
//     maximum and write gk[t] and gv[t].
//
// gw and gu are summed over the batch with one float32 atomicAdd per
// (b, c) into buffers the caller zeroed, so their last bits can change
// from run to run (B terms in another order).
//
// What bounds them on this card: neither bytes nor operations, but the
// serial chain of T steps with only B*C threads.  By bytes the forward
// moves k, v in and y out, 3*B*T*C*4 bytes (at the beam-search shape
// [5, 201, 512], 6.2 MB: 1.8 us at 3.35 TB/s); the backward reads k, v, y,
// gy and writes gk, gv, 6*B*T*C*4 bytes.  But [5, 201, 512] is 2,560
// threads, 40 blocks of 64 for 132 SMs, each thread running 201 dependent
// steps of four expf and a division; the time is T times the latency of
// one step.  Making that faster (splitting T into chunks that combine
// their states, more channels in flight per SM) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr float MIN_VALUE = -1e38f;

__global__ void __launch_bounds__(THREADS)
wkv_fwd_kernel(int B, int T, int C, const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ aa0, const float* __restrict__ bb0,
               const float* __restrict__ pp0, float* __restrict__ y,
               float* __restrict__ aa1, float* __restrict__ bb1, float* __restrict__ pp1) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C, c = idx % C;
  const size_t base = (size_t)b * T * C + c;
  const float ww_dec = w[c], uu = u[c];
  // no initial state given: the one the recurrence starts from
  float aa = aa0 ? aa0[idx] : 0.f, bb = bb0 ? bb0[idx] : 0.f, pp = pp0 ? pp0[idx] : MIN_VALUE;
  float kn = T > 0 ? k[base] : 0.f, vn = T > 0 ? v[base] : 0.f;
  for (int t = 0; t < T; ++t) {
    const float kk = kn, vv = vn;
    if (t + 1 < T) {
      kn = k[base + (size_t)(t + 1) * C];
      vn = v[base + (size_t)(t + 1) * C];
    }
    float ww = uu + kk;
    float q = fmaxf(pp, ww);
    float e1 = expf(pp - q), e2 = expf(ww - q);
    y[base + (size_t)t * C] = (e1 * aa + e2 * vv) / (e1 * bb + e2);
    ww = pp + ww_dec;
    q = fmaxf(ww, kk);
    e1 = expf(ww - q);
    e2 = expf(kk - q);
    aa = e1 * aa + e2 * vv;
    bb = e1 * bb + e2;
    pp = q;
  }
  if (aa1) {  // the final state is wanted
    aa1[idx] = aa;
    bb1[idx] = bb;
    pp1[idx] = pp;
  }
}

__global__ void __launch_bounds__(THREADS)
wkv_bwd_kernel(int B, int T, int C, const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ y, const float* __restrict__ gy,
               float* __restrict__ gw, float* __restrict__ gu, float* __restrict__ gk,
               float* __restrict__ gv) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * C) return;
  const int b = idx / C, c = idx % C;
  const size_t base = (size_t)b * T * C + c;
  const float ww_dec = w[c], uu = u[c];

  // forward sweep: ga, gb = dA/dw, dB/dw under the state's scale e^pp
  float aa = 0.f, bb = 0.f, pp = MIN_VALUE, ga = 0.f, gb = 0.f, sw = 0.f, su = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t i = base + (size_t)t * C;
    const float kk = k[i], vv = v[i], yy = y[i];
    float ww = uu + kk;
    float p = fmaxf(pp, ww);
    float e1 = expf(pp - p), e2 = expf(ww - p);
    const float qq = gy[i] / (e1 * bb + e2);  // gy / (B + e^(u+k)), times e^p
    sw += (ga - gb * yy) * e1 * qq;
    su += (vv - yy) * e2 * qq;
    gk[i] = qq;
    gv[i] = ww - p;
    ww = ww_dec + pp;
    p = fmaxf(ww, kk);
    e1 = expf(ww - p);
    e2 = expf(kk - p);
    ga = e1 * (aa + ga);
    gb = e1 * (bb + gb);
    aa = e1 * aa + e2 * vv;
    bb = e1 * bb + e2;
    pp = p;
  }
  atomicAdd(gw + c, sw);
  atomicAdd(gu + c, su);

  // reverse sweep: (aa, bb) = the adjoint of (A, B) under the scale e^pp
  aa = 0.f;
  bb = 0.f;
  pp = MIN_VALUE;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = base + (size_t)t * C;
    const float kk = k[i], vv = v[i], yy = y[i], qq = gk[i], rr = gv[i];
    float e1 = qq * expf(rr);   // gy * e^(u+k) / (B + e^(u+k))
    float e2 = expf(kk + pp);   // e^k times the adjoint's scale
    gk[i] = e1 * (vv - yy) + e2 * (aa * vv + bb);
    gv[i] = e1 + e2 * aa;
    const float ww = ww_dec + pp;
    const float www = rr - uu - kk;  // -log(B + e^(u+k)) up to the forward's scale
    const float p = fmaxf(ww, www);
    e1 = expf(ww - p);
    e2 = qq * expf(www - p);
    aa = e1 * aa + e2;
    bb = e1 * bb - e2 * yy;
    pp = p;
  }
}

int blocks(int B, int C) { return (B * C + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// y [B, T, C] and the final state (aa1, bb1, pp1) [B, C] from the initial
// state (aa0, bb0, pp0); every array float32 and contiguous.  Null state
// pointers: start from aa = bb = 0, pp = -1e38, and do not store the
// final state.
int wkv_fwd(const void* w, const void* u, const void* k, const void* v, const void* aa0,
            const void* bb0, const void* pp0, void* y, void* aa1, void* bb1, void* pp1,
            int B, int T, int C, void* stream) {
  if (B * C == 0) return 0;
  wkv_fwd_kernel<<<blocks(B, C), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      B, T, C, static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(aa0), static_cast<const float*>(bb0),
      static_cast<const float*>(pp0), static_cast<float*>(y), static_cast<float*>(aa1),
      static_cast<float*>(bb1), static_cast<float*>(pp1));
  return (int)cudaGetLastError();
}

// The backward of wkv_fwd from the initial state, for the output gradient
// gy: gk, gv [B, T, C], and gw, gu [C] summed over the batch into buffers
// the caller zeroed.  y is wkv_fwd's output.
int wkv_bwd(const void* w, const void* u, const void* k, const void* v, const void* y,
            const void* gy, void* gw, void* gu, void* gk, void* gv, int B, int T, int C,
            void* stream) {
  if (B * C == 0) return 0;
  wkv_bwd_kernel<<<blocks(B, C), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      B, T, C, static_cast<const float*>(w), static_cast<const float*>(u),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(y), static_cast<const float*>(gy), static_cast<float*>(gw),
      static_cast<float*>(gu), static_cast<float*>(gk), static_cast<float*>(gv));
  return (int)cudaGetLastError();
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
