// The LSTM recurrence of the transducer's prediction network (and of the
// LSTM language model), forward and backward, for Hopper (sm_90a).
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
// the RNNDecoder).  cuDNN runs the same recurrence as a GEMM and a cell
// kernel per position, 2 L launches a call, and the transducer's searches
// call the prediction network some 600 times a 10 s request over a
// [5, 201] label prefix.  What bounds the recurrence on this card is
// neither bytes nor operations (at [5, 201, 256] it moves ~6 MB and does
// 0.5 GFLOP) but the chain of L steps, each a [B, H] x [H, 4H] product far
// too small to fill 132 SMs.
//
// So one launch runs the whole sequence.  A persistent grid of ceil(H / 8)
// blocks, each owning 8 hidden units, keeps its 32 rows of W_hh (4 gates x
// 8 units) in shared memory for the whole call, and its units' cell states
// in its threads' registers.  Each step a block copies h_{t-1} of every
// unit from L2 (written by every block at the step before) into shared
// memory in one coalesced pass (on an H100, warps that read it from L2
// product by product took 12 us a step at B = 5), computes its
// 32 x B dot products one warp each, updates its units and writes h_t; a
// grid-wide barrier (a counter and a generation word in global memory; the
// grid is launched cooperatively, so every block is resident and the spin
// cannot deadlock) separates the steps.  With ``gates`` and ``cells`` it
// also keeps the gate activations and the cell states for the backward.
//
// The backward, from dy [B, L, H] and those saved tensors, runs t = L-1 .. 0
// the same way: each block keeps W_hh's 8 columns of its units ([8, 4H]) in
// shared memory, copies da_{t+1} of every gate row into shared memory,
// takes dh = dy_t + W_hh^T da_{t+1} for its units, and writes their da_t,
// the gradient of the pre-activations (= d xi_t); the weight gradients are
// products of da with the inputs, left to GEMMs outside.  No atomics touch
// the data: a repeat call is bitwise equal.  All arithmetic is float32 with
// the accurate expf and tanhf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNITS = 8;  // hidden units a block owns
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Every block waits until every block has arrived.  bar[0] counts the
// arrivals, bar[1] is the generation.  As cooperative groups' grid sync:
// the block's threads meet, then one thread fences (cumulatively over the
// block's stores), arrives, waits for the generation to move and fences
// again; every block's global stores before the barrier are visible to
// every block after it.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Each thread owns at most one (batch row, unit) pair of its block (a launch
// takes at most THREADS / UNITS rows): thread = b * UNITS + j.  It keeps
// that pair's cell state (forward) or carried cell gradient (backward) in a
// register, and loads the next step's inputs right after using this step's,
// so that their latency overlaps the barrier.

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ w_hh,
                const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ gates,
                float* __restrict__ cells, float* hbuf, unsigned int* bar, int B, int L, int H) {
  extern __shared__ float smem[];
  constexpr int R = 4 * UNITS;  // the W_hh rows a block keeps: row g * UNITS + j
  float* w = smem;              // [R][H]
  float* hs = w + R * H;        // [B][H]: h_{t-1} of every unit
  float* pre = hs + B * H;      // [B][R]: W_hh h_{t-1} of this block's rows
  const int u0 = blockIdx.x * UNITS;
  const int n_units = min(UNITS, H - u0);
  const size_t G = 4 * (size_t)H;
  for (int idx = threadIdx.x; idx < R * H; idx += THREADS) {
    const int r = idx / H, k = idx - r * H, g = r / UNITS, j = r - g * UNITS;
    w[idx] = j < n_units ? w_hh[(size_t)(g * H + u0 + j) * H + k] : 0.0f;
  }
  const int b = threadIdx.x / UNITS, j = threadIdx.x - b * UNITS, unit = u0 + j;
  const bool mine = b < B && j < n_units;
  float bias_r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, x_r[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c = 0.0f;
  if (mine) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      bias_r[g] = bias[g * H + unit];
      x_r[g] = xi[(size_t)b * L * G + g * H + unit];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = 0; t < L; ++t) {
    const float* hprev = hbuf + (size_t)(t & 1) * B * H;
    float* hnext = hbuf + (size_t)((t + 1) & 1) * B * H;
    if (t == 0) {
      for (int idx = threadIdx.x; idx < B * R; idx += THREADS) pre[idx] = 0.0f;
    } else {
      for (int idx = threadIdx.x; idx < B * H; idx += THREADS) hs[idx] = __ldcg(hprev + idx);
      __syncthreads();
      for (int task = warp; task < B * R; task += WARPS) {
        const int bb = task / R, r = task - bb * R;
        const float* hb = hs + (size_t)bb * H;
        const float* wr = w + (size_t)r * H;
        float acc = 0.0f;
        for (int k = lane; k < H; k += 32) acc = fmaf(hb[k], wr[k], acc);
        acc = warp_sum(acc);
        if (lane == 0) pre[task] = acc;
      }
    }
    __syncthreads();
    if (mine) {
      const size_t row = (size_t)b * L + t;
      float a[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) a[g] = (pre[b * R + g * UNITS + j] + bias_r[g]) + x_r[g];
      const float ig = sigmoid_f(a[0]), fg = sigmoid_f(a[1]), gg = tanhf(a[2]), og = sigmoid_f(a[3]);
      c = fg * c + ig * gg;
      const float h = og * tanhf(c);
      hnext[(size_t)b * H + unit] = h;
      y[row * H + unit] = h;
      if (gates != nullptr) {
        float* gr = gates + row * G;
        gr[unit] = ig;
        gr[H + unit] = fg;
        gr[2 * H + unit] = gg;
        gr[3 * H + unit] = og;
        cells[row * H + unit] = c;
      }
      if (t + 1 < L) {
#pragma unroll
        for (int g = 0; g < 4; ++g) x_r[g] = xi[(row + 1) * G + g * H + unit];
      }
    }
    if (t + 1 < L) grid_barrier(bar);
  }
}

__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ gates,
                const float* __restrict__ cells, const float* __restrict__ w_hh, float* da,
                unsigned int* bar, int B, int L, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* wt = smem;              // [UNITS][4H]: wt[j][r] = W_hh[r][u0 + j]
  float* ds = wt + UNITS * G;    // [B][4H]: da_{t+1} of every gate row
  float* dhn = ds + B * G;       // [B][UNITS]: (W_hh^T da_{t+1}) of this block's units
  const int u0 = blockIdx.x * UNITS;
  const int n_units = min(UNITS, H - u0);
  for (int idx = threadIdx.x; idx < UNITS * G; idx += THREADS) {
    const int jj = idx / G, r = idx - jj * G;
    wt[idx] = jj < n_units ? w_hh[(size_t)r * H + u0 + jj] : 0.0f;
  }
  const int b = threadIdx.x / UNITS, j = threadIdx.x - b * UNITS, unit = u0 + j;
  const bool mine = b < B && j < n_units;
  // this step's gates, cell, previous cell and output gradient
  float gt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ct = 0.0f, cp = 0.0f, dyt = 0.0f, dc_carry = 0.0f;
  if (mine) {
    const size_t row = (size_t)b * L + L - 1;
#pragma unroll
    for (int g = 0; g < 4; ++g) gt[g] = gates[row * G + g * H + unit];
    ct = cells[row * H + unit];
    cp = L > 1 ? cells[(row - 1) * H + unit] : 0.0f;
    dyt = dy[row * H + unit];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = L - 1; t >= 0; --t) {
    if (t == L - 1) {
      for (int idx = threadIdx.x; idx < B * UNITS; idx += THREADS) dhn[idx] = 0.0f;
    } else {
      for (int idx = threadIdx.x; idx < B * G; idx += THREADS) {
        const int bb = idx / G;
        ds[idx] = __ldcg(da + ((size_t)bb * L + t + 1) * G + (idx - bb * G));
      }
      __syncthreads();
      for (int task = warp; task < B * UNITS; task += WARPS) {
        const int bb = task / UNITS, jj = task - bb * UNITS;
        const float* dn = ds + (size_t)bb * G;
        const float* wr = wt + (size_t)jj * G;
        float acc = 0.0f;
        for (int r = lane; r < G; r += 32) acc = fmaf(dn[r], wr[r], acc);
        acc = warp_sum(acc);
        if (lane == 0) dhn[task] = acc;
      }
    }
    __syncthreads();
    if (mine) {
      const size_t row = (size_t)b * L + t;
      const float ig = gt[0], fg = gt[1], gg = gt[2], og = gt[3];
      const float tc = tanhf(ct);
      const float dh = dyt + dhn[b * UNITS + j];
      const float dc = dc_carry + dh * og * (1.0f - tc * tc);
      dc_carry = dc * fg;
      float* dr = da + row * G;
      dr[unit] = dc * gg * ig * (1.0f - ig);
      dr[H + unit] = dc * cp * fg * (1.0f - fg);
      dr[2 * H + unit] = dc * ig * (1.0f - gg * gg);
      dr[3 * H + unit] = dh * tc * og * (1.0f - og);
      if (t > 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gt[g] = gates[(row - 1) * G + g * H + unit];
        ct = cp;
        cp = t > 1 ? cells[(row - 2) * H + unit] : 0.0f;
        dyt = dy[(row - 1) * H + unit];
      }
    }
    if (t > 0) grid_barrier(bar);
  }
}

int blocks_for(int H) { return (H + UNITS - 1) / UNITS; }

// Dynamic shared memory (floats) of each kernel: the W_hh slice, fixed by
// H, and per batch row the staged h (forward) or da (backward) and the
// block's own sums.
size_t fwd_per_row(size_t H) { return H + 4 * UNITS; }
size_t bwd_per_row(size_t H) { return 4 * H + UNITS; }
size_t fwd_smem(size_t B, size_t H) { return 4 * UNITS * H + B * fwd_per_row(H); }
size_t bwd_smem(size_t B, size_t H) { return UNITS * 4 * H + B * bwd_per_row(H); }

template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int blocks, size_t smem, void** args,
                               void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                                    dim3(blocks), dim3(THREADS), args, smem,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most batch rows one launch of lstm_fwd (backward = 0) or lstm_bwd
// (1) takes at hidden width H within ``limit`` bytes of dynamic shared
// memory (0: not even one); the wrapper cuts a larger batch into launches
// of at most this many rows.  A thread owns one (row, unit) pair, so a
// launch takes at most THREADS / UNITS rows.
int lstm_max_rows(int H, int limit, int backward) {
  if (H < 1 || limit < 1) return 0;
  const size_t floats = (size_t)limit / sizeof(float);
  const size_t fixed = 4 * UNITS * (size_t)H;
  if (fixed >= floats) return 0;
  const size_t rows = (floats - fixed) / (backward ? bwd_per_row(H) : fwd_per_row(H));
  return rows > THREADS / UNITS ? THREADS / UNITS : static_cast<int>(rows);
}

// xi [B, L, 4H], w_hh [4H, H], bias [4H] -> y [B, L, H]; gates [B, L, 4H] and
// cells [B, L, H] are written when not null.  hbuf: 2 * B * H floats of
// scratch; bar: 2 unsigned ints, zero.
int lstm_fwd(const void* xi, const void* w_hh, const void* bias, void* y, void* gates,
             void* cells, void* hbuf, void* bar, int B, int L, int H, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem(B, H) * sizeof(float);
  void* args[] = {&xi, &w_hh, &bias, &y, &gates, &cells, &hbuf, &bar, &B, &L, &H};
  return static_cast<int>(launch_cooperative(lstm_fwd_kernel, blocks_for(H), smem, args, stream));
}

// dy [B, L, H], the forward's gates [B, L, 4H] and cells [B, L, H], w_hh
// [4H, H] -> da [B, L, 4H], the gradient of the pre-activations.  bar: 2
// unsigned ints, zero.
int lstm_bwd(const void* dy, const void* gates, const void* cells, const void* w_hh, void* da,
             void* bar, int B, int L, int H, void* stream) {
  if (B < 1 || L < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(B, H) * sizeof(float);
  void* args[] = {&dy, &gates, &cells, &w_hh, &da, &bar, &B, &L, &H};
  return static_cast<int>(launch_cooperative(lstm_bwd_kernel, blocks_for(H), smem, args, stream));
}

const char* lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
