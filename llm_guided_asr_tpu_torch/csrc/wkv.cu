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
// [T, C] tile in VMEM and walks t on the core.  What bounds it on this card
// is neither bytes nor operations (at the beam-search shape [5, 201, 512]
// it moves 6.2 MB, 1.9 us at 3.35 TB/s) but the serial chain of T steps:
// one thread per (b, c) gives 2,560 threads at beam 5 and 512 at greedy
// B = 1, for 132 SMs, each waiting on a load and four expf a step.
//
// So the forward is a chunked scan.  Per channel the decay w is a constant,
// so L steps act on the carried state in closed form: scanned from the zero
// state (0, 0, -1e38), a chunk gives its summary (a, b, p), and an incoming
// state (aa, bb, pp) crosses the chunk as
//
//   pp' = pp + w + ... + w (L times);  q = max(pp', p);
//   aa = aa*e^(pp'-q) + a*e^(p-q);  bb = bb*e^(pp'-q) + b*e^(p-q);  pp = q
//
// (exact in real arithmetic: pp_t = max(pp_{t-1} + w, k_t) is a max-plus
// scan, and A, B are linear in the state).  pp' is summed one w at a time,
// not as pp + L*w: where the carried state dominates, the scan's pp drifts
// by the rounding of L additions, and at |pp| ~ 100 (|k| up to ~100) one
// product rounds differently enough to move y past the 1e-5 tolerance
// (tests/test_torch_wkv_chunked.py emulates both in float32).  T is cut into N chunks of
// L = ceil(T/N) steps; a warp owns one chunk of 32 neighbouring channels
// (every load and store of a step coalesced).  Two kernels on one stream:
//
//   wkv_summary_kernel: every chunk but the last scans from the zero state
//     and writes its summary to a float32 workspace [B, N, 3, C];
//   wkv_fwd_kernel: chunk j folds the summaries of chunks 0 .. j-1, in
//     order, onto the initial state, rescans its own steps from the state it
//     carried in with the step above, writing y, and the last chunk stores
//     the final state.
//
// The serial chain becomes about 2*T/N steps plus at most N-1 folds, and
// the card gets N times the warps.  wkv_fwd_chunks picks N from the grid:
// the smallest power of two that gives 4 warps an SM, at most 32, with
// chunks of at least 16 steps (N = 1 skips the summary kernel: the
// training shape [16, 25, 512] runs unsplit).  Each warp issues the loads
// of its next WKV_G steps (and folds) before computing the current ones, so
// a step waits on the arithmetic, not on device memory.  Every output has
// one owner and the folds run in a fixed order: no atomics, and a repeat
// call is bitwise equal.
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
// from run to run (B terms in another order).  What bounds it: the serial
// chain of T steps with only B*C threads, not its bytes (it reads k, v, y,
// gy and writes gk, gv, 6*B*T*C*4 bytes).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;   // wkv_bwd: threads a block, one per (b, c)
constexpr int FWD_WARPS = 4;  // wkv_fwd: warps a block, one chunk of 32 channels each
constexpr int WKV_G = 8;      // steps (folds) whose loads are issued together
constexpr int MAX_CHUNKS = 32;
constexpr int MIN_CHUNK = 16;  // steps a chunk at least
constexpr float MIN_VALUE = -1e38f;

struct KV { float k, v; };
struct Summary { float a, b, p; };

// For i in [0, n): body(i, load(i)), the loads of the next WKV_G items in
// flight while the current ones are computed.
template <typename Load, typename Body>
__device__ __forceinline__ void prefetched(int n, Load load, Body body) {
  using V = decltype(load(0));
  V cur[WKV_G], nxt[WKV_G];
#pragma unroll
  for (int i = 0; i < WKV_G; ++i) cur[i] = i < n ? load(i) : V{};
  for (int g = 0; g < n; g += WKV_G) {
#pragma unroll
    for (int i = 0; i < WKV_G; ++i) nxt[i] = g + WKV_G + i < n ? load(g + WKV_G + i) : V{};
#pragma unroll
    for (int i = 0; i < WKV_G; ++i)
      if (g + i < n) body(g + i, cur[i]);
#pragma unroll
    for (int i = 0; i < WKV_G; ++i) cur[i] = nxt[i];
  }
}

// The state update of one step (the recurrence's second line).
__device__ __forceinline__ void advance(float& aa, float& bb, float& pp, float w, KV x) {
  const float ww = pp + w;
  const float q = fmaxf(ww, x.k);
  const float e1 = expf(ww - q), e2 = expf(x.k - q);
  aa = e1 * aa + e2 * x.v;
  bb = e1 * bb + e2;
  pp = q;
}

// The warp's chunk: which (b, channel, chunk j) this thread owns, and the
// chunk's rows [t0, t0 + len).  False for a lane past C or a warp past the
// grid.
struct Chunk {
  int b, c, j, t0, len;
  __device__ bool locate(int B, int T, int C, int chunks) {
    const int warp = blockIdx.x * FWD_WARPS + threadIdx.x / 32;
    const int groups = (C + 31) / 32;
    j = warp % chunks;
    const int col = warp / chunks;
    b = col / groups;
    c = (col % groups) * 32 + threadIdx.x % 32;
    const int L = (T + chunks - 1) / chunks;
    t0 = min(j * L, T);
    len = min(L, T - t0);
    return b < B && c < C;
  }
};

__global__ void __launch_bounds__(FWD_WARPS * 32)
wkv_summary_kernel(int B, int T, int C, int chunks, const float* __restrict__ w,
                   const float* __restrict__ k, const float* __restrict__ v,
                   float* __restrict__ work) {
  Chunk ch;
  if (!ch.locate(B, T, C, chunks) || ch.j == chunks - 1) return;  // the last is never folded
  const size_t base = ((size_t)ch.b * T + ch.t0) * C + ch.c;
  const float ww_dec = w[ch.c];
  float aa = 0.f, bb = 0.f, pp = MIN_VALUE;
  prefetched(
      ch.len, [&](int i) { return KV{k[base + (size_t)i * C], v[base + (size_t)i * C]}; },
      [&](int, KV x) { advance(aa, bb, pp, ww_dec, x); });
  float* out = work + ((size_t)ch.b * chunks + ch.j) * 3 * C + ch.c;
  out[0] = aa;
  out[C] = bb;
  out[2 * C] = pp;
}

__global__ void __launch_bounds__(FWD_WARPS * 32)
wkv_fwd_kernel(int B, int T, int C, int chunks, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ aa0,
               const float* __restrict__ bb0, const float* __restrict__ pp0,
               const float* __restrict__ work, float* __restrict__ y,
               float* __restrict__ aa1, float* __restrict__ bb1, float* __restrict__ pp1) {
  Chunk ch;
  if (!ch.locate(B, T, C, chunks)) return;
  const int idx = ch.b * C + ch.c;
  const float ww_dec = w[ch.c], uu = u[ch.c];
  // no initial state given: the one the recurrence starts from
  float aa = aa0 ? aa0[idx] : 0.f, bb = bb0 ? bb0[idx] : 0.f, pp = pp0 ? pp0[idx] : MIN_VALUE;

  // carry the state across chunks 0 .. j-1, in order
  const int L = (T + chunks - 1) / chunks;
  const float* sums = work + (size_t)ch.b * chunks * 3 * C + ch.c;
  prefetched(
      ch.j,
      [&](int i) {
        const float* s = sums + (size_t)i * 3 * C;
        return Summary{s[0], s[C], s[2 * C]};
      },
      [&](int i, Summary s) {
        float ww = pp;  // decayed across the chunk's steps one at a time, as the scan does
        for (int n = max(0, min(L, T - i * L)); n > 0; --n) ww += ww_dec;
        const float q = fmaxf(ww, s.p);
        const float e1 = expf(ww - q), e2 = expf(s.p - q);
        aa = e1 * aa + e2 * s.a;
        bb = e1 * bb + e2 * s.b;
        pp = q;
      });

  // rescan the chunk from the carried state, writing y
  const size_t base = ((size_t)ch.b * T + ch.t0) * C + ch.c;
  prefetched(
      ch.len, [&](int i) { return KV{k[base + (size_t)i * C], v[base + (size_t)i * C]}; },
      [&](int i, KV x) {
        const float ww = uu + x.k;
        const float q = fmaxf(pp, ww);
        const float e1 = expf(pp - q), e2 = expf(ww - q);
        y[base + (size_t)i * C] = (e1 * aa + e2 * x.v) / (e1 * bb + e2);
        advance(aa, bb, pp, ww_dec, x);
      });
  if (aa1 && ch.j == chunks - 1) {  // the final state is wanted
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

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // namespace

extern "C" {

// The chunks wkv_fwd cuts T into for this grid on the current device: the
// smallest power of two that gives 4 warps an SM, at most 32, with chunks
// of at least MIN_CHUNK steps.  Launches nothing; a negative value is a
// CUDA error code, negated.
int wkv_fwd_chunks(int B, int T, int C) {
  int sms = 0;
  const int code = sm_count(&sms);
  if (code != 0) return -code;
  const long warps = (long)B * ((C + 31) / 32);
  int n = 1;
  while (n < MAX_CHUNKS && warps * n < 4L * sms && (T + 2 * n - 1) / (2 * n) >= MIN_CHUNK) n *= 2;
  return n;
}

// y [B, T, C] and the final state (aa1, bb1, pp1) [B, C] from the initial
// state (aa0, bb0, pp0); every array float32 and contiguous.  Null state
// pointers: start from aa = bb = 0, pp = -1e38, and do not store the
// final state.  T is cut into `chunks` (1 .. 32; more than T is taken as
// T) chunks; work is a float32 workspace of 3 * B * chunks * C words (may
// be null when chunks is 1).
int wkv_fwd(const void* w, const void* u, const void* k, const void* v, const void* aa0,
            const void* bb0, const void* pp0, void* work, void* y, void* aa1, void* bb1,
            void* pp1, int chunks, int B, int T, int C, void* stream) {
  if (chunks < 1 || chunks > MAX_CHUNKS || (chunks > 1 && !work))
    return (int)cudaErrorInvalidValue;
  if (B * C == 0) return 0;
  chunks = min(chunks, max(T, 1));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps = B * ((C + 31) / 32) * chunks;
  const int grid = (warps + FWD_WARPS - 1) / FWD_WARPS;
  const float* wp = static_cast<const float*>(w);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* wk = static_cast<float*>(work);
  if (chunks > 1) {
    wkv_summary_kernel<<<grid, FWD_WARPS * 32, 0, s>>>(B, T, C, chunks, wp, kp, vp, wk);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wkv_fwd_kernel<<<grid, FWD_WARPS * 32, 0, s>>>(
      B, T, C, chunks, wp, static_cast<const float*>(u), kp, vp,
      static_cast<const float*>(aa0), static_cast<const float*>(bb0),
      static_cast<const float*>(pp0), wk, static_cast<float*>(y), static_cast<float*>(aa1),
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
