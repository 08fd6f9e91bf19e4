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
// loop of ops/wkv.py to about 1e-6.  The backward's one division,
// q_t below, is the fast one: its denominator lies in [1, T + 1], where
// that is within 2 ulp.
//
// wkv_fwd replaces the TPU kernel llm_guided_asr_tpu/ops/wkv.py _wkv_kernel
// (:79, called through wkv_pallas :109).  The TPU kernel keeps a whole
// [T, C] tile in VMEM and walks t on the core.  What bounds it on this card
// is neither bytes nor operations (at the beam-search shape [5, 201, 512]
// it moves 6.2 MB, 1.9 us at 3.35 TB/s) but the serial chain of T steps:
// one thread per (b, c) gives 2,560 threads at beam 5 and 512 at greedy
// B = 1, for 132 SMs, each waiting on a load and two expf a step (each
// max-normalized pair of exponentials has one factor e^0 = 1, exp_pair).
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
// running maximum as the forward does.  Per (b, c), two sweeps:
//
//   forward sweep: recompute the state; carry dA/dw and dB/dw (ga, gb,
//     normalized by e^pp as A and B are) and sum gw and gu; keep, per
//     step, q_t = gy[t] / (e1 * bb + e2), c_t = q_t * e2 and the step's
//     maximum p_t;
//   reverse sweep: carry the adjoint of (A, B) under its own running
//     maximum and write gk[t] and gv[t].
//
// What bounds it is the serial chain of 2*T dependent steps, not its bytes
// (k, v, y, gy in and gk, gv out, 6*B*T*C*4 bytes: 1.5 us at [16, 25, 512]).
// So the backward is staged and chunked like the forward.  A warp owns
// one chunk of 32 channels; its loads are issued BWD_G steps ahead through
// the `prefetched` ring, and c_t, q_t and p_t stay in the warp's shared
// memory between the sweeps (never a round trip through device memory).
// T is cut into N chunks (wkv_bwd_chunks: the forward's rule, with chunks
// of at most BWD_MAX_STEPS steps so that c_t, q_t and p_t fit), and four
// kernels run in order:
//
//   wkv_bwd_summary_kernel: every chunk but the last scans from the zero
//     state into (a, b, p, ga, gb), ga and gb being d(a, b)/dw;
//   wkv_bwd_chunk_kernel<false>: every chunk but the first folds those
//     summaries onto the zero state in order (across chunk i, pp decays
//     one w per step and the carried ga, gb gain the carried aa, bb once
//     per step: the L*A term of d(e^(Lw) A)/dw, added step by step as the
//     scan adds it), sweeps forward, then sweeps backward from the zero
//     adjoint into a reverse summary (a', b', p'), the adjoint at the
//     chunk's start from its own steps, under its own maximum p';
//   wkv_bwd_chunk_kernel<true>: every chunk folds the forward summaries
//     and sweeps forward (its partial gw, gu), folds the reverse
//     summaries of the later chunks from the last one down (the adjoint is
//     linear with decay e^w per step: pp decays one w per step, then the
//     summary merges in), and sweeps backward writing gk and gv;
//   wkv_bwd_sum_kernel: gw and gu, the per-(b, chunk) partials added in a
//     fixed order (batch rows in order, chunks in order within each).
//
// N = 1 (the training shape [16, 25, 512]) runs the last two only.  The
// serial chain becomes about 5*T/N steps plus the folds.  No atomics:
// every output has one owner and every sum a fixed order, so a repeat call
// is bitwise equal (tests/test_torch_wkv_bwd.py emulates the association
// in float32 against jax.vjp of wkv_scan).

#include <cuda_runtime.h>

namespace {

constexpr int FWD_WARPS = 4;  // wkv_fwd: warps a block, one chunk of 32 channels each
constexpr int BWD_WARPS = 2;  // wkv_bwd: warps a block, one chunk of 32 channels each
constexpr int BWD_MAX_STEPS = 64;  // wkv_bwd: steps a chunk at most (48 KB of shared memory a block)
constexpr int WKV_G = 8;      // wkv_fwd: steps (folds) whose loads are issued together
constexpr int BWD_G = 4;      // wkv_bwd: the same (its steps hold more in registers)
constexpr int MAX_CHUNKS = 32;
constexpr int MIN_CHUNK = 16;  // steps a chunk at least
constexpr float MIN_VALUE = -1e38f;

struct KV { float k, v; };
struct Summary { float a, b, p; };

// For i in [0, n): body(i, load(i)), the loads of the next G items in
// flight while the current ones are computed.  Whole groups of G run with
// no branch between their bodies, so the compiler can interleave the
// independent parts of neighbouring steps.
template <int G = WKV_G, typename Load, typename Body>
__device__ __forceinline__ void prefetched(int n, Load load, Body body) {
  using V = decltype(load(0));
  V cur[G], nxt[G];
#pragma unroll
  for (int i = 0; i < G; ++i) cur[i] = i < n ? load(i) : V{};
  const int full = n - n % G;
  for (int g = 0; g < full; g += G) {
#pragma unroll
    for (int i = 0; i < G; ++i) nxt[i] = g + G + i < n ? load(g + G + i) : V{};
#pragma unroll
    for (int i = 0; i < G; ++i) body(g + i, cur[i]);
#pragma unroll
    for (int i = 0; i < G; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (full + i < n) body(full + i, cur[i]);
}

// (e^(a - m), e^(b - m)) for m = max(a, b), with one exponential: the
// larger argument's factor is e^0 = 1, and b - a = -(a - b) exactly, so
// both factors are bitwise those of two expf calls.
__device__ __forceinline__ float2 exp_pair(float a, float b, float& m) {
  m = fmaxf(a, b);
  const float e = expf(-fabsf(a - b));
  return a >= b ? make_float2(1.f, e) : make_float2(e, 1.f);
}

// The state update of one step (the recurrence's second line).
__device__ __forceinline__ void advance(float& aa, float& bb, float& pp, float w, KV x) {
  float q;
  const float2 e = exp_pair(pp + w, x.k, q);
  aa = e.x * aa + e.y * x.v;
  bb = e.x * bb + e.y;
  pp = q;
}

// The warp's chunk: which (b, channel, chunk j) this thread owns, and the
// chunk's rows [t0, t0 + len).  False for a lane past C or a warp past the
// grid.
struct Chunk {
  int b, c, j, t0, len;
  template <int WARPS = FWD_WARPS>
  __device__ bool locate(int B, int T, int C, int chunks) {
    const int warp = blockIdx.x * WARPS + threadIdx.x / 32;
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
        const float2 e = exp_pair(ww, s.p, pp);
        aa = e.x * aa + e.y * s.a;
        bb = e.x * bb + e.y * s.b;
      });

  // rescan the chunk from the carried state, writing y
  const size_t base = ((size_t)ch.b * T + ch.t0) * C + ch.c;
  prefetched(
      ch.len, [&](int i) { return KV{k[base + (size_t)i * C], v[base + (size_t)i * C]}; },
      [&](int i, KV x) {
        float q;
        const float2 e = exp_pair(pp, uu + x.k, q);
        y[base + (size_t)i * C] = (e.x * aa + e.y * x.v) / (e.x * bb + e.y);
        advance(aa, bb, pp, ww_dec, x);
      });
  if (aa1 && ch.j == chunks - 1) {  // the final state is wanted
    aa1[idx] = aa;
    bb1[idx] = bb;
    pp1[idx] = pp;
  }
}

// The carried state of the backward's forward sweep: (aa, bb, pp) and
// ga, gb = dA/dw, dB/dw, all under the scale e^pp.
struct Carry {
  float aa = 0.f, bb = 0.f, pp = MIN_VALUE, ga = 0.f, gb = 0.f;
};
struct Step4 { float k, v, y, g; };
struct Step6 { float k, v, y, c, q, p; };

// What the reverse sweep needs of a step, kept in shared memory: c_t =
// gy * e^(u+k) / (B + e^(u+k)), q_t = gy / (B + e^(u+k)) under the scale
// e^p_t, and p_t.
struct Kept { float c, q, p; };

// One step of the backward's forward sweep: returns what the reverse sweep
// keeps and adds the step's terms of gw and gu.  The denominator lies in
// [1, T + 1] (one of e1, e2 is 1, and bb <= T under the running maximum),
// so the fast division is within 2 ulp there.
__device__ __forceinline__ Kept sweep_step(Carry& s, float w, float u, Step4 x, float& sw,
                                           float& su) {
  float p;
  float2 e = exp_pair(s.pp, u + x.k, p);
  const float q = __fdividef(x.g, e.x * s.bb + e.y);  // gy / (B + e^(u+k)), times e^p
  sw += (s.ga - s.gb * x.y) * e.x * q;
  su += (x.v - x.y) * e.y * q;
  const Kept kept{e.y * q, q, p};
  float p2;
  e = exp_pair(w + s.pp, x.k, p2);
  s.ga = e.x * (s.aa + s.ga);
  s.gb = e.x * (s.bb + s.gb);
  s.aa = e.x * s.aa + e.y * x.v;
  s.bb = e.x * s.bb + e.y;
  s.pp = p2;
  return kept;
}

// Steps a chunk i of `chunks` holds (0 for a chunk past T).
__device__ __forceinline__ int chunk_steps(int i, int T, int chunks) {
  const int L = (T + chunks - 1) / chunks;
  return max(0, min(L, T - i * L));
}

// The forward summaries of chunks 0 .. j-1 folded onto the zero state, in
// order: pp decays one w per step of the chunk and ga, gb gain aa, bb once
// per step, then the summary merges in under the larger maximum.
__device__ Carry fold_forward(const float* sums, int j, int T, int C, int chunks, float w) {
  Carry s;
  prefetched<BWD_G>(
      j,
      [&](int i) {
        const float* x = sums + (size_t)i * 5 * C;
        return Carry{x[0], x[C], x[2 * C], x[3 * C], x[4 * C]};
      },
      [&](int i, Carry x) {
        float ww = s.pp;
        for (int n = chunk_steps(i, T, chunks); n > 0; --n) {
          ww += w;
          s.ga += s.aa;
          s.gb += s.bb;
        }
        const float2 e = exp_pair(ww, x.pp, s.pp);
        s.aa = e.x * s.aa + e.y * x.aa;
        s.bb = e.x * s.bb + e.y * x.bb;
        s.ga = e.x * s.ga + e.y * x.ga;
        s.gb = e.x * s.gb + e.y * x.gb;
      });
  return s;
}

__global__ void __launch_bounds__(BWD_WARPS * 32)
wkv_bwd_summary_kernel(int B, int T, int C, int chunks, const float* __restrict__ w,
                       const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ sums) {
  Chunk ch;
  if (!ch.locate<BWD_WARPS>(B, T, C, chunks) || ch.j == chunks - 1) return;
  const size_t base = ((size_t)ch.b * T + ch.t0) * C + ch.c;
  const float ww_dec = w[ch.c];
  Carry s;
  prefetched<BWD_G>(
      ch.len, [&](int i) { return KV{k[base + (size_t)i * C], v[base + (size_t)i * C]}; },
      [&](int, KV x) {
        const float2 e = exp_pair(ww_dec + s.pp, x.k, s.pp);
        s.ga = e.x * (s.aa + s.ga);
        s.gb = e.x * (s.bb + s.gb);
        s.aa = e.x * s.aa + e.y * x.v;
        s.bb = e.x * s.bb + e.y;
      });
  float* out = sums + ((size_t)ch.b * chunks + ch.j) * 5 * C + ch.c;
  out[0] = s.aa;
  out[C] = s.bb;
  out[2 * C] = s.pp;
  out[3 * C] = s.ga;
  out[4 * C] = s.gb;
}

// LAST = false: the reverse summary of every chunk but the first.
// LAST = true: gk, gv of every chunk and its partial gw, gu.
// Dynamic shared memory: BWD_WARPS * 3 * L * 32 floats (c_t, q_t, p_t).
template <bool LAST>
__global__ void __launch_bounds__(BWD_WARPS * 32)
wkv_bwd_chunk_kernel(int B, int T, int C, int chunks, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ y,
                     const float* __restrict__ gy, const float* __restrict__ fwd_sums,
                     float* __restrict__ rev_sums, float* __restrict__ parts,
                     float* __restrict__ gk, float* __restrict__ gv) {
  extern __shared__ float kept_all[];
  Chunk ch;
  if (!ch.locate<BWD_WARPS>(B, T, C, chunks) || (!LAST && ch.j == 0)) return;
  const int L = (T + chunks - 1) / chunks;
  // this lane's c_t, q_t and p_t: three rows of L steps, lanes side by side
  float* kept = kept_all + (size_t)(threadIdx.x / 32) * 3 * L * 32 + threadIdx.x % 32;
  const int row = L * 32;
  const float ww_dec = w[ch.c], uu = u[ch.c];
  const size_t base = ((size_t)ch.b * T + ch.t0) * C + ch.c;

  // forward sweep from the state carried across chunks 0 .. j-1
  Carry s = fold_forward(fwd_sums + (size_t)ch.b * chunks * 5 * C + ch.c, ch.j, T, C, chunks,
                         ww_dec);
  float sw = 0.f, su = 0.f;
  prefetched<BWD_G>(
      ch.len,
      [&](int i) {
        const size_t o = base + (size_t)i * C;
        return Step4{k[o], v[o], y[o], gy[o]};
      },
      [&](int i, Step4 x) {
        const Kept q = sweep_step(s, ww_dec, uu, x, sw, su);
        kept[i * 32] = q.c;
        kept[row + i * 32] = q.q;
        kept[2 * row + i * 32] = q.p;
      });

  // the adjoint of (A, B) after the chunk's last step
  float ra = 0.f, rb = 0.f, pa = MIN_VALUE;
  if (LAST) {
    const float* rsum = rev_sums + (size_t)ch.b * chunks * 3 * C + ch.c;
    const int later = chunks - 1 - ch.j;  // chunks j+1 .. chunks-1, the last one first
    prefetched<BWD_G>(
        later,
        [&](int i) {
          const float* x = rsum + (size_t)(chunks - 1 - i) * 3 * C;
          return Summary{x[0], x[C], x[2 * C]};
        },
        [&](int i, Summary x) {
          float ww = pa;
          for (int n = chunk_steps(chunks - 1 - i, T, chunks); n > 0; --n) ww += ww_dec;
          const float2 e = exp_pair(ww, x.p, pa);
          ra = e.x * ra + e.y * x.a;
          rb = e.x * rb + e.y * x.b;
        });
  }

  // reverse sweep
  prefetched<BWD_G>(
      ch.len,
      [&](int i) {
        const int t = ch.len - 1 - i;
        const size_t o = base + (size_t)t * C;
        return Step6{k[o], v[o], y[o], kept[t * 32], kept[row + t * 32], kept[2 * row + t * 32]};
      },
      [&](int i, Step6 x) {
        if (LAST) {
          const size_t o = base + (size_t)(ch.len - 1 - i) * C;
          const float e = expf(x.k + pa);  // e^k times the adjoint's scale
          gk[o] = x.c * (x.v - x.y) + e * (ra * x.v + rb);
          gv[o] = x.c + e * ra;
        }
        // -p_t: the scale of gy / (B + e^(u+k)) is e^-p_t
        const float2 e = exp_pair(ww_dec + pa, -x.p, pa);
        ra = e.x * ra + e.y * x.q;
        rb = e.x * rb - e.y * x.q * x.y;
      });

  if (LAST) {
    float* out = parts + ((size_t)ch.b * chunks + ch.j) * 2 * C + ch.c;
    out[0] = sw;
    out[C] = su;
  } else {
    float* out = rev_sums + ((size_t)ch.b * chunks + ch.j) * 3 * C + ch.c;
    out[0] = ra;
    out[C] = rb;
    out[2 * C] = pa;
  }
}

// gw (g = 0) and gu (g = 1) of channel c: the partials [B, chunks, 2, C]
// added batch row by batch row, chunk by chunk.
__global__ void wkv_bwd_sum_kernel(int B, int C, int chunks, const float* __restrict__ parts,
                                   float* __restrict__ gw, float* __restrict__ gu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * C) return;
  const int g = idx / C, c = idx % C;
  const float* x = parts + (size_t)g * C + c;
  float acc = 0.f;
  for (int i = 0; i < B * chunks; ++i) acc += x[(size_t)i * 2 * C];
  (g == 0 ? gw : gu)[c] = acc;
}


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

// The chunks wkv_bwd cuts T into: wkv_fwd_chunks, or more where a chunk
// would hold more than BWD_MAX_STEPS steps.  Launches nothing; a negative
// value is a CUDA error code, negated.
int wkv_bwd_chunks(int B, int T, int C) {
  const int n = wkv_fwd_chunks(B, T, C);
  return n < 1 ? n : max(n, (T + BWD_MAX_STEPS - 1) / BWD_MAX_STEPS);
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
// gy: gk, gv [B, T, C], and gw, gu [C] summed over the batch.  y is
// wkv_fwd's output.  T is cut into `chunks` chunks (more than T is taken
// as T; at most BWD_MAX_STEPS steps a chunk); work is a float32 workspace
// of 10 * B * chunks * C words: the forward summaries [B, chunks, 5, C],
// the reverse ones [B, chunks, 3, C] and the partial gw, gu [B, chunks, 2,
// C].  B = 0 (or T = 0) writes gw = gu = 0.
int wkv_bwd(const void* w, const void* u, const void* k, const void* v, const void* y,
            const void* gy, void* work, void* gw, void* gu, void* gk, void* gv, int chunks,
            int B, int T, int C, void* stream) {
  chunks = min(chunks, max(T, 1));
  if (chunks < 1 || (T + chunks - 1) / chunks > BWD_MAX_STEPS || !work)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* fwd_sums = static_cast<float*>(work);
  float* rev_sums = fwd_sums + 5LL * B * chunks * C;
  float* parts = rev_sums + 3LL * B * chunks * C;
  if (B > 0) {
    const int warps = B * ((C + 31) / 32) * chunks;
    const int grid = (warps + BWD_WARPS - 1) / BWD_WARPS;
    const int L = (T + chunks - 1) / chunks;
    const size_t smem = (size_t)BWD_WARPS * 3 * L * 32 * sizeof(float);
    const float* yp = static_cast<const float*>(y);
    const float* gyp = static_cast<const float*>(gy);
    if (chunks > 1) {
      wkv_bwd_summary_kernel<<<grid, BWD_WARPS * 32, 0, s>>>(B, T, C, chunks, wp, kp, vp,
                                                              fwd_sums);
      wkv_bwd_chunk_kernel<false><<<grid, BWD_WARPS * 32, smem, s>>>(
          B, T, C, chunks, wp, up, kp, vp, yp, gyp, fwd_sums, rev_sums, parts, nullptr,
          nullptr);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    wkv_bwd_chunk_kernel<true><<<grid, BWD_WARPS * 32, smem, s>>>(
        B, T, C, chunks, wp, up, kp, vp, yp, gyp, fwd_sums, rev_sums, parts,
        static_cast<float*>(gk), static_cast<float*>(gv));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wkv_bwd_sum_kernel<<<(2 * C + 255) / 256, 256, 0, s>>>(B, C, chunks, parts,
                                                         static_cast<float*>(gw),
                                                         static_cast<float*>(gu));
  return (int)cudaGetLastError();
}

const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
