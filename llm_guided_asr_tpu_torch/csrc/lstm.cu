// The LSTM recurrence of the transducer's prediction network, the LSTM
// language model and the (VGG-)RNN encoders, forward and backward, for
// Hopper (sm_90a).
//
// Per batch row b, over t = 0 .. L-1, from h = c = 0, with the input
// projections xi = x W_ih^T [B, L, 4H] computed outside (one GEMM) and the
// gates in flax's order (i, f, g, o):
//
//   a_t = (W_hh h_{t-1} + bias) + xi_t
//   i = sigmoid(a_i), f = sigmoid(a_f), g = tanh(a_g), o = sigmoid(a_o)
//   c_t = f c_{t-1} + i g;  h_t = o tanh(c_t)
//
// It replaces no TPU kernel: the JAX package runs flax's nn.RNN over
// OptimizedLSTMCell, a lax.scan (llm_guided_asr_tpu/models/transducer.py:104,
// models/lm.py, models/extra_encoders.py).  What bounds the recurrence is
// neither bytes nor operations (at [64, 312, 320] it moves ~0.2 GB and
// does 16 GFLOP) but the chain of L steps, each a [B, H] x [H, 4H] product
// that alone fills no card; cuDNN runs a GEMM and a cell kernel a step.
//
// Batch rows never interact, so the batch is cut into row groups of 8 (or
// 16: two tiles) and each group gets its own thread-block cluster of up to
// 16 CTAs; clusters never wait on one another, so a whole batch is one
// ordinary launch.  CTA r of a cluster owns hidden units [r U, r U + U) (U
// a multiple of 4; the last CTAs' slices may be part or all past H) and
// the 4U rows of W_hh of those units, local gate row lr = g U + j for gate
// g and unit j.
//
// Forward, each step: every warp takes an (m tile of 16 gate rows, k
// chunk of the hidden width) task and sums W_hh[rows] h_{t-1}^T on the
// tensor cores (mma.sync m16n8k8, 3xTF32: x = big + small, both TF32, and
// small.big + big.small + big.big in four accumulator chains; plain TF32
// misses float32 tolerances); the chunks' partials are added in a fixed
// order, then one lane a (row, unit) adds the bias and xi_t (copied by
// cp.async two steps ahead into a ring of three slots; none for rows past
// B), updates c (kept in shared memory), writes h_t, the gates and c_t, and
// stores h_t into every CTA's copy of h (distributed shared memory,
// st.shared::cluster, four units a store).  The cluster's hardware barrier
// (barrier.cluster.arrive.release / wait.acquire) separates the steps; h
// is double-buffered, so one barrier a step suffices.
//
// Backward, t = L-1 .. 0: one lane a (row, unit) sums the CTAs' partials
// of (W_hh^T da_{t+1}) for its unit in rank order, adds dy_t, and writes da_t
// (= d xi_t) from the saved gates and cells (copied as xi is); then each CTA
// multiplies its gate rows' da_t (split into TF32 parts where it is
// written) by its slice of W_hh on the tensor cores ([H, 4U] x [4U, rows],
// 3xTF32) and stores each partial into the owner unit's CTA, in a slot of
// its own rank (no atomics: a repeat call is bitwise equal).  The weight
// gradients are GEMMs of da outside.
//
// Where W_hh lives is chosen by H alone (ops/lstm.py, RESIDENT_MAX_HIDDEN):
// up to H = 320 each CTA keeps its slice in shared memory as float32 for the
// whole sequence; wider, each CTA reads its slice from L2 every step (16.8
// MB at H = 1024 fits the 50 MB L2).  Either way W_hh is split into TF32
// parts at every step, by two integer operations a part (a copy split once
// at the start doubles the shared memory the product reads each step and
// measured slower, and does not fit at H = 320).
//
// Fragments: a thread (g = lane / 4, t = lane % 4) loads k = 4t .. 4t+3 of a
// 16-wide k block as one float4 of each operand; the block's first product
// takes k = 4t, 4t+1 at positions t, t+4 and the second 4t+2, 4t+3.  Row
// strides are 16 more than a multiple of 32 floats, so the float4 loads of
// a quarter warp hit distinct banks.  Cell arithmetic is float32 with the
// accurate expf and tanhf.
//
// The shared memory a CTA takes is sized by the caller (ops/lstm.py
// LaunchPlan.smem_bytes, from the layouts written in the kernels); the
// launchers check only that it fits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_MAX = 232448;  // the dynamic shared memory an H100 block can take
constexpr int STAGED = 7;         // backward inputs a (row, unit) a step: dy, i, f, g, o, c_t, c_{t-1}


__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }
// a row stride of at least n floats, 16 more than a multiple of 32
__host__ __device__ constexpr int ld16(int n) {
  return round16(n) % 32 == 16 ? round16(n) : round16(n) + 16;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
// every thread of every CTA of the cluster arrives (its shared and
// distributed shared stores released) and waits for all (acquired)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// v into the shared memory of cluster CTA ``rank`` at this CTA's address ``addr``
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
__device__ __forceinline__ void st_remote(uint32_t addr, int rank, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(map_rank(addr, rank)), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote2(uint32_t addr, int rank, float v0, float v1) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(map_rank(addr, rank)),
               "f"(v0), "f"(v1)
               : "memory");
}
__device__ __forceinline__ void st_remote4(uint32_t addr, int rank, uint32_t v0, uint32_t v1,
                                           uint32_t v2, uint32_t v3) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(map_rank(addr, rank)),
               "r"(v0), "r"(v1), "r"(v2), "r"(v3)
               : "memory");
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, by two integer operations on its bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The A operand of one 16-wide k block, split: rows g and g+8 of the tile,
// [product][register]
struct AFrag {
  uint32_t big[2][4], small[2][4];
};

__device__ __forceinline__ void split_a(const float4& r0, const float4& r1, AFrag& f) {
  split(r0.x, f.big[0][0], f.small[0][0]);
  split(r1.x, f.big[0][1], f.small[0][1]);
  split(r0.y, f.big[0][2], f.small[0][2]);
  split(r1.y, f.big[0][3], f.small[0][3]);
  split(r0.z, f.big[1][0], f.small[1][0]);
  split(r1.z, f.big[1][1], f.small[1][1]);
  split(r0.w, f.big[1][2], f.small[1][2]);
  split(r1.w, f.big[1][3], f.small[1][3]);
}

// A tile's sums, kept in four chains so that a warp's products do not wait
// on one another: [product of the k block][big.big, small terms]
struct Acc {
  float c[2][2][4];
};

// the block's two 3xTF32 products, B column g holding k = 4t .. 4t+3 split
// into big parts ``b`` and small parts ``s``
__device__ __forceinline__ void mma_block(Acc& a, const AFrag& f, const uint4& b, const uint4& s) {
  const uint32_t bb0[2] = {b.x, b.y}, bs0[2] = {s.x, s.y}, bb1[2] = {b.z, b.w},
                 bs1[2] = {s.z, s.w};
  mma_tf32(a.c[0][1], f.small[0], bb0);
  mma_tf32(a.c[0][1], f.big[0], bs0);
  mma_tf32(a.c[0][0], f.big[0], bb0);
  mma_tf32(a.c[1][1], f.small[1], bb1);
  mma_tf32(a.c[1][1], f.big[1], bs1);
  mma_tf32(a.c[1][0], f.big[1], bb1);
}

__device__ __forceinline__ void mma_block(Acc& a, const AFrag& f, const float4& b) {
  uint4 bb, bs;
  split(b.x, bb.x, bs.x);
  split(b.y, bb.y, bs.y);
  split(b.z, bb.z, bs.z);
  split(b.w, bb.w, bs.w);
  mma_block(a, f, bb, bs);
}

// register e of the tile's sum: (big.big of both products) + (small terms)
__device__ __forceinline__ float acc_sum(const Acc& a, int e) {
  return (a.c[0][0][e] + a.c[1][0][e]) + (a.c[0][1][e] + a.c[1][1][e]);
}

// W_hh row ``row`` (null: a unit past H), columns k .. k+3, 0 past H, from L2
__device__ __forceinline__ float4 ldg_row4(const float* row, int k, int H) {
  if (row == nullptr) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return make_float4(k < H ? __ldg(row + k) : 0.0f, k + 1 < H ? __ldg(row + k + 1) : 0.0f,
                     k + 2 < H ? __ldg(row + k + 2) : 0.0f, k + 3 < H ? __ldg(row + k + 3) : 0.0f);
}

template <bool STREAM, int NT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ w_hh,
                const float* __restrict__ bias, float* __restrict__ y,
                float* __restrict__ gates, float* __restrict__ cells, int B, int L, int H,
                int U, int KS) {
  constexpr int R = 8 * NT;  // batch rows of the cluster
  extern __shared__ __align__(16) float smem[];
  const int C = cluster_ctas(), rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x) / C * R, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));  // this CTA's units below H
  const int G4 = 4 * U, GP = G4 + 4, LD = ld16(H), MT = G4 / 16, KBLK = round16(H) / 16;
  const size_t G = 4 * (size_t)H;
  float* ws = smem;                         // [G4][LD]: W_hh rows, resident only
  float* hs = ws + (STREAM ? 0 : G4 * LD);  // [2][R][LD]: h_{t-1} of every unit
  float* bs = hs + 2 * R * LD;              // [G4]: bias
  float* part = bs + G4;                    // [KS][R][GP]: the k chunks' sums
  float* xs = part + KS * R * GP;           // [3][R][G4]: xi_t of this CTA's gate rows
  float* cs = xs + 3 * R * G4;              // [R][U]: c
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  if (!STREAM) {
    for (int idx = tid; idx < G4 * LD; idx += THREADS) {
      const int lr = idx / LD, k = idx - lr * LD, g = lr / U, j = lr - g * U;
      ws[idx] = j < nu && k < H ? w_hh[(size_t)(g * H + u0 + j) * H + k] : 0.0f;
    }
  }
  for (int idx = tid; idx < 2 * R * LD; idx += THREADS) hs[idx] = 0.0f;
  for (int lr = tid; lr < G4; lr += THREADS) {
    const int g = lr / U, j = lr - g * U;
    bs[lr] = j < nu ? bias[g * H + u0 + j] : 0.0f;
  }
  for (int idx = tid; idx < R * U; idx += THREADS) cs[idx] = 0.0f;
  for (int idx = tid; idx < 3 * R * G4; idx += THREADS) xs[idx] = 0.0f;  // rows past B stay 0
  __syncthreads();  // before any copy lands there
  // xi_t, 0 for units past H: a warp a (row, gate) run of U floats, 16 bytes
  // a copy where H % 4 == 0 (then nu % 4 == 0 too); no copies for rows past B
  const bool vec = (H & 3) == 0;
  auto prefetch = [&](int t, float* dst) {
    for (int seg = warp; seg < 4 * min(R, B - row0); seg += WARPS) {
      const int n = seg >> 2, g = seg & 3;
      const float* src = xi + ((size_t)(row0 + n) * L + t) * G + g * H + u0;
      float* d = dst + n * G4 + g * U;
      if (vec) {
        for (int j = 4 * lane; j < U; j += 128) cp_async16(d + j, src + j, j < nu);
      } else {
        for (int j = lane; j < U; j += 32) cp_async4(d + j, src + j, j < nu);
      }
    }
    cp_async_commit();
  };
  // xi of step t in ring slot t % 3, two steps ahead
  prefetch(0, xs);
  if (L > 1)
    prefetch(1, xs + R * G4);
  else
    cp_async_commit();
  cp_async_wait<1>();
  cluster_sync();  // every CTA of the cluster runs, and its h is zero

  for (int t = 0; t < L; ++t) {
    const int cur = t & 1, slot = t % 3;
    if (t + 2 < L)
      prefetch(t + 2, xs + (slot == 0 ? 2 : slot - 1) * R * G4);
    else
      cp_async_commit();  // an empty group: one group a step
    const float* hc = hs + cur * R * LD;
    for (int task = warp; task < MT * KS; task += WARPS) {
      const int m = task % MT, s = task / MT;
      const int lr0 = m * 16 + gq, lr1 = lr0 + 8;
      const float *w0 = nullptr, *w1 = nullptr;
      if (STREAM) {
        const int g0 = lr0 / U, j0 = lr0 - g0 * U, g1 = lr1 / U, j1 = lr1 - g1 * U;
        w0 = j0 < nu ? w_hh + (size_t)(g0 * H + u0 + j0) * H : nullptr;
        w1 = j1 < nu ? w_hh + (size_t)(g1 * H + u0 + j1) * H : nullptr;
      }
      Acc acc[NT] = {};
#pragma unroll 2
      for (int kb = s * KBLK / KS; kb < (s + 1) * KBLK / KS; ++kb) {
        const int k = kb * 16 + 4 * tq;
        AFrag f;
        if (STREAM)
          split_a(ldg_row4(w0, k, H), ldg_row4(w1, k, H), f);
        else
          split_a(*reinterpret_cast<const float4*>(ws + lr0 * LD + k),
                  *reinterpret_cast<const float4*>(ws + lr1 * LD + k), f);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_block(acc[nt], f, *reinterpret_cast<const float4*>(hc + (nt * 8 + gq) * LD + k));
      }
      float* p = part + s * R * GP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * tq;
        p[n * GP + lr0] = acc_sum(acc[nt], 0);
        p[(n + 1) * GP + lr0] = acc_sum(acc[nt], 1);
        p[n * GP + lr1] = acc_sum(acc[nt], 2);
        p[(n + 1) * GP + lr1] = acc_sum(acc[nt], 3);
      }
    }
    __syncthreads();
    const float* xc = xs + slot * R * G4;
    float* hn = hs + (cur ^ 1) * R * LD;
    for (int n = warp; n < R; n += WARPS) {  // a warp a batch row, a lane a unit
      const int row = row0 + n;
      for (int j0 = 0; j0 < U; j0 += 32) {
        const int j = j0 + lane;
        float h = 0.0f;
        if (j < U) {
          float a[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int lr = g * U + j;
            float pre = part[n * GP + lr];
            for (int s = 1; s < KS; ++s) pre += part[(s * R + n) * GP + lr];
            a[g] = (pre + bs[lr]) + xc[n * G4 + lr];
          }
          const float ig = sigmoid_f(a[0]), fg = sigmoid_f(a[1]), gg = tanhf(a[2]),
                      og = sigmoid_f(a[3]);
          const float c = __fadd_rn(__fmul_rn(fg, cs[n * U + j]), __fmul_rn(ig, gg));
          cs[n * U + j] = c;
          h = __fmul_rn(og, tanhf(c));
          if (j < nu && row < B) {
            const size_t r = (size_t)row * L + t;
            const int unit = u0 + j;
            y[r * H + unit] = h;
            if (gates != nullptr) {
              float* gr = gates + r * G;
              gr[unit] = ig;
              gr[H + unit] = fg;
              gr[2 * H + unit] = gg;
              gr[3 * H + unit] = og;
              cells[r * H + unit] = c;
            }
          }
        }
        if (t + 1 < L) {  // h_t into every CTA's copy, four units a store
          const uint32_t h0 = __float_as_uint(h), h1 = __shfl_down_sync(0xffffffffu, h0, 1),
                         h2 = __shfl_down_sync(0xffffffffu, h0, 2),
                         h3 = __shfl_down_sync(0xffffffffu, h0, 3);
          const uint32_t addr = smem_u32(hn + n * LD + u0 + j);
          if ((j | 3) < nu) {  // the quad's units are all below H
            if ((j & 3) == 0)
              for (int q = 0; q < C; ++q) st_remote4(addr, q, h0, h1, h2, h3);
          } else if (j < nu) {
            for (int q = 0; q < C; ++q) st_remote(addr, q, h0);
          }
        }
      }
    }
    cp_async_wait<1>();  // xi_{t+1} is in
    if (t + 1 < L) cluster_sync();
  }
}

template <bool STREAM, int NT>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ gates,
                const float* __restrict__ cells, const float* __restrict__ w_hh,
                float* __restrict__ da, int B, int L, int H, int U) {
  constexpr int R = 8 * NT, RP = R + 2;  // RP: a unit's rows in a slot, padded
  extern __shared__ __align__(16) float smem[];
  const int C = cluster_ctas(), rank = cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x) / C * R, u0 = rank * U;
  const int nu = max(0, min(U, H - u0));
  const int G4 = 4 * U, LDT = ld16(G4), MT = round16(H) / 16, KBLK = G4 / 16, RU = R * U;
  const size_t G = 4 * (size_t)H;
  const int HM = round16(H);
  float* wt = smem;  // [HM][LDT]: W_hh^T, resident only
  // [2][R][LDT]: da_t of this CTA's gate rows, split: [big, small]
  uint32_t* ds = reinterpret_cast<uint32_t*>(wt + (STREAM ? 0 : HM * LDT));
  float* sl = reinterpret_cast<float*>(ds + 2 * R * LDT);  // [2][C][U][RP]: (W_hh^T da) partials by rank
  float* st = sl + 2 * C * U * RP;                   // [3][STAGED][R][U]: a step's inputs
  float* dcs = st + 3 * STAGED * RU;                 // [R][U]: the carried cell gradient
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  if (!STREAM) {
    for (int idx = tid; idx < HM * LDT; idx += THREADS) wt[idx] = 0.0f;
    __syncthreads();
    for (int idx = tid; idx < G4 * H; idx += THREADS) {  // coalesced reads, transposed
      const int lr = idx / H, k = idx - lr * H, g = lr / U, j = lr - g * U;
      if (j < nu) wt[k * LDT + lr] = w_hh[(size_t)(g * H + u0 + j) * H + k];
    }
  }
  for (int idx = tid; idx < 2 * R * LDT; idx += THREADS) ds[idx] = 0u;
  // the slots of units past H are never stored into and are read as 0
  for (int idx = tid; idx < 2 * C * U * RP; idx += THREADS) sl[idx] = 0.0f;
  for (int idx = tid; idx < RU; idx += THREADS) dcs[idx] = 0.0f;
  for (int idx = tid; idx < 3 * STAGED * RU; idx += THREADS) st[idx] = 0.0f;  // rows past B stay 0
  __syncthreads();  // before any copy lands there
  // dy_t, the gates and c_t, c_{t-1} (0 past H and for t = 0): a warp a
  // (field, row) run of U floats; no copies for rows past B
  const bool vec = (H & 3) == 0;  // 16 bytes a copy
  auto prefetch = [&](int t, float* dst) {
    for (int seg = warp; seg < STAGED * R; seg += WARPS) {
      const int f = seg / R, n = seg - f * R, row = row0 + n, tt = f == 6 ? t - 1 : t;
      if (row >= B) continue;
      const bool rok = tt >= 0;
      const size_t r = rok ? (size_t)row * L + tt : 0;
      const float* src = f == 0 ? dy + r * H + u0
                         : f < 5 ? gates + r * G + (f - 1) * H + u0
                                 : cells + r * H + u0;
      float* d = dst + seg * U;
      if (vec) {
        for (int j = 4 * lane; j < U; j += 128) cp_async16(d + j, src + j, rok && j < nu);
      } else {
        for (int j = lane; j < U; j += 32) cp_async4(d + j, src + j, rok && j < nu);
      }
    }
    cp_async_commit();
  };
  // the inputs of step t in ring slot t % 3, two steps ahead
  prefetch(L - 1, st + (L - 1) % 3 * STAGED * RU);
  if (L > 1)
    prefetch(L - 2, st + (L - 2) % 3 * STAGED * RU);
  else
    cp_async_commit();
  cp_async_wait<1>();
  cluster_sync();

  for (int t = L - 1; t >= 0; --t) {
    const int cur = t & 1, slot = t % 3;
    if (t >= 2)
      prefetch(t - 2, st + (slot == 2 ? 0 : slot + 1) * STAGED * RU);
    else
      cp_async_commit();  // an empty group: one group a step
    const float* sc = st + slot * STAGED * RU;
    const float* sin = sl + (cur ^ 1) * C * U * RP;  // the partials of da_{t+1}
    for (int n = warp; n < R; n += WARPS) {
      const int row = row0 + n;
      for (int j = lane; j < U; j += 32) {
        const int idx = n * U + j;
        float dsum = 0.0f;
        if (t + 1 < L) {
          dsum = sin[j * RP + n];
          for (int q = 1; q < C; ++q) dsum += sin[(q * U + j) * RP + n];
        }
        const float dyt = sc[idx], ig = sc[RU + idx], fg = sc[2 * RU + idx],
                    gg = sc[3 * RU + idx], og = sc[4 * RU + idx], ct = sc[5 * RU + idx],
                    cp = sc[6 * RU + idx];
        const float tc = tanhf(ct);
        const float dh = dyt + dsum;
        const float dc = dcs[idx] + dh * og * (1.0f - tc * tc);
        dcs[idx] = dc * fg;
        const float d[4] = {dc * gg * ig * (1.0f - ig), dc * cp * fg * (1.0f - fg),
                            dc * ig * (1.0f - gg * gg), dh * tc * og * (1.0f - og)};
#pragma unroll
        for (int g = 0; g < 4; ++g) split(d[g], ds[n * LDT + g * U + j], ds[(R + n) * LDT + g * U + j]);
        if (j < nu && row < B) {
          float* dr = da + ((size_t)row * L + t) * G + u0 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) dr[g * H] = d[g];
        }
      }
    }
    __syncthreads();
    if (t > 0) {
      const uint32_t mine = smem_u32(sl + (cur * C + rank) * U * RP);  // this CTA's slot
      for (int task = warp; task < MT; task += WARPS) {
        const int k0 = task * 16 + gq, k1 = k0 + 8;
        Acc acc[NT] = {};
        for (int kb = 0; kb < KBLK; ++kb) {
          const int p = kb * 16 + 4 * tq;  // local gate rows p .. p+3
          AFrag f;
          if (STREAM) {
            float v0[4], v1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int g = (p + i) / U, j = p + i - g * U;
              const float* wr = w_hh + (size_t)(g * H + u0 + j) * H;
              v0[i] = j < nu && k0 < H ? __ldg(wr + k0) : 0.0f;
              v1[i] = j < nu && k1 < H ? __ldg(wr + k1) : 0.0f;
            }
            split_a(make_float4(v0[0], v0[1], v0[2], v0[3]),
                    make_float4(v1[0], v1[1], v1[2], v1[3]), f);
          } else {
            split_a(*reinterpret_cast<const float4*>(wt + k0 * LDT + p),
                    *reinterpret_cast<const float4*>(wt + k1 * LDT + p), f);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int o = (nt * 8 + gq) * LDT + p;
            mma_block(acc[nt], f, *reinterpret_cast<const uint4*>(ds + o),
                      *reinterpret_cast<const uint4*>(ds + R * LDT + o));
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = nt * 8 + 2 * tq;  // rows n, n+1 of units k0 and k1
          if (k0 < H) {
            const int owner = k0 / U;
            st_remote2(mine + 4u * static_cast<uint32_t>((k0 - owner * U) * RP + n), owner,
                       acc_sum(acc[nt], 0), acc_sum(acc[nt], 1));
          }
          if (k1 < H) {
            const int owner = k1 / U;
            st_remote2(mine + 4u * static_cast<uint32_t>((k1 - owner * U) * RP + n), owner,
                       acc_sum(acc[nt], 2), acc_sum(acc[nt], 3));
          }
        }
      }
    }
    cp_async_wait<1>();  // the inputs of step t-1 are in
    if (t > 0) cluster_sync();
  }
}

// The attributes a kernel instance needs (shared memory above 48 KB,
// clusters of 16), set once a device.
template <auto KERNEL>
cudaError_t prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ready[dev])) return e;
  e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Launch(int blocks, int cluster, size_t smem, void* stream) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <auto KERNEL, typename... Args>
cudaError_t launch(int blocks, int cluster, size_t smem, void* stream, Args... args) {
  cudaError_t e = prepare<KERNEL>();
  if (e != cudaSuccess) return e;
  Launch l(blocks, cluster, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, KERNEL, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Clusters of this shape the card holds at once (0: none).
template <auto KERNEL>
cudaError_t active_clusters(int cluster, size_t smem, int* n) {
  cudaError_t e = prepare<KERNEL>();
  if (e != cudaSuccess) return e;
  Launch l(cluster, cluster, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(n, KERNEL, &l.cfg);
}

bool valid_shape(int H, int cluster, int units, int n_tiles, int k_chunks) {
  return H >= 1 && cluster >= 1 && cluster <= 16 && units >= 4 && units % 4 == 0 &&
         (long long)cluster * units >= H && (n_tiles == 1 || n_tiles == 2) && k_chunks >= 1 &&
         k_chunks <= round16(H) / 16;
}

template <int V>
using Int = std::integral_constant<int, V>;

// f(Int<STREAM>, Int<NT>) for the run-time weight placement and tile count
template <typename F>
cudaError_t dispatch(int streamed, int n_tiles, F&& f) {
  switch (2 * (streamed != 0) + n_tiles - 1) {
    case 0: return f(Int<0>{}, Int<1>{});
    case 1: return f(Int<0>{}, Int<2>{});
    case 2: return f(Int<1>{}, Int<1>{});
    case 3: return f(Int<1>{}, Int<2>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The clusters of a launch plan (ops/lstm.py launch_plan) that the card
// holds at once (0: none fits), or minus a CUDA error code; ``smem`` is the
// plan's dynamic shared memory a CTA.
int lstm_max_active_clusters(int backward, int H, int cluster, int units, int n_tiles,
                             int k_chunks, int streamed, int smem) {
  if (!valid_shape(H, cluster, units, n_tiles, k_chunks) || smem < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (smem > SMEM_MAX) return 0;
  int n = 0;
  const cudaError_t e = dispatch(streamed, n_tiles, [&](auto m, auto t) {
    constexpr bool M = decltype(m)::value;
    constexpr int T = decltype(t)::value;
    return backward ? active_clusters<lstm_bwd_kernel<M, T>>(cluster, smem, &n)
                    : active_clusters<lstm_fwd_kernel<M, T>>(cluster, smem, &n);
  });
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// xi [B, L, 4H], w_hh [4H, H], bias [4H] -> y [B, L, H]; gates [B, L, 4H] and
// cells [B, L, H] are written when not null.  One launch of ceil(B / (8
// n_tiles)) clusters of ``cluster`` CTAs, each CTA ``units`` hidden units,
// the step product cut into ``k_chunks`` per gate-row tile; W_hh read from
// L2 every step when ``streamed``, ``smem`` bytes of shared memory a CTA.
int lstm_fwd(const void* xi, const void* w_hh, const void* bias, void* y, void* gates,
             void* cells, int B, int L, int H, int cluster, int units, int n_tiles,
             int k_chunks, int streamed, int smem, void* stream) {
  if (B < 1 || L < 1 || !valid_shape(H, cluster, units, n_tiles, k_chunks) || smem < 0 ||
      smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + 8 * n_tiles - 1) / (8 * n_tiles) * cluster;
  const float *x = static_cast<const float*>(xi), *w = static_cast<const float*>(w_hh),
              *b = static_cast<const float*>(bias);
  float *yy = static_cast<float*>(y), *gg = static_cast<float*>(gates),
        *cc = static_cast<float*>(cells);
  return static_cast<int>(dispatch(streamed, n_tiles, [&](auto m, auto t) {
    constexpr bool M = decltype(m)::value;
    constexpr int T = decltype(t)::value;
    return launch<lstm_fwd_kernel<M, T>>(blocks, cluster, smem, stream, x, w, b, yy, gg, cc, B,
                                         L, H, units, k_chunks);
  }));
}

// dy [B, L, H], the forward's gates [B, L, 4H] and cells [B, L, H], w_hh
// [4H, H] -> da [B, L, 4H], the gradient of the pre-activations; the plan as
// lstm_fwd's (no k chunks).
int lstm_bwd(const void* dy, const void* gates, const void* cells, const void* w_hh, void* da,
             int B, int L, int H, int cluster, int units, int n_tiles, int streamed, int smem,
             void* stream) {
  if (B < 1 || L < 1 || !valid_shape(H, cluster, units, n_tiles, 1) || smem < 0 ||
      smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + 8 * n_tiles - 1) / (8 * n_tiles) * cluster;
  const float *d = static_cast<const float*>(dy), *g = static_cast<const float*>(gates),
              *c = static_cast<const float*>(cells), *w = static_cast<const float*>(w_hh);
  float* out = static_cast<float*>(da);
  return static_cast<int>(dispatch(streamed, n_tiles, [&](auto m, auto t) {
    constexpr bool M = decltype(m)::value;
    constexpr int T = decltype(t)::value;
    return launch<lstm_bwd_kernel<M, T>>(blocks, cluster, smem, stream, d, g, c, w, out, B, L,
                                         H, units);
  }));
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
