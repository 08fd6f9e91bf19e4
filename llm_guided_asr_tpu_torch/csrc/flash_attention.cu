// Flash self-attention with a validity mask over the frames, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of the library flash attention that
// llm_guided_asr_tpu/models/transformer.py FlashSelfAttention calls (:490),
// in jax/experimental/pallas/ops/tpu/flash_attention.py:
//   _flash_attention_kernel      (forward, through _flash_attention_impl)
//   _flash_attention_dkv_kernel  (dK, dV, through _flash_attention_bwd_dkv)
//   _flash_attention_dq_kernel   (dQ, through _flash_attention_bwd_dq)
// For one (b, h), with valid = valid[b, :] (1 = a frame, 0 = a pad):
//
//   P[i, j] = softmax_j over the valid keys of (q_i . k_j * scale)
//   out_i   = sum_j P[i, j] v_j      for a valid query row, 0 for a pad row
//   lse_i   = log sum_j exp(q_i . k_j * scale) over the valid keys, 0 for a pad row
//
// The module hands the TPU library the mask as SegmentIds (frames in segment
// 1, pads in segment 0, T padded to a multiple of 128) and zeroes the pad
// query rows afterwards; the valid query rows see exactly the valid keys, so
// this is the same function.  Here the mask is read directly and T needs no
// padding: a tile of keys (or queries) with no valid entry is skipped whole,
// and inside a tile masked keys get no probability.
//
// Forward (the FlashAttention-2 loop): one block per (tile of ROWS query
// rows, head, batch row, key split); key tiles stream through shared memory
// under an online softmax with float32 statistics, so the [T, T] scores
// never leave registers.  The saved lse is the natural-log log-sum-exp the
// backward reads.  At a small grid (B = 1 serving: 120 blocks of 64 rows for
// 4 heads of 1874 frames, under one block per SM) the key range is split
// over 2-8 blocks per query tile, each writing its unnormalized partial
// output and (max, sum) to a float32 workspace, and a second kernel merges
// the splits in their fixed order: every output element still has one
// owner, and a repeat call is bitwise identical.
//
// Backward (the FlashAttention-2 split, scores recomputed from the saved
// log-sum-exp; delta_i = out_i . dout_i comes from the caller, as the library
// takes it from XLA), two kernels that replace _flash_attention_dkv_kernel
// and _flash_attention_dq_kernel:
//   dkv  one block per (tile of keys, head, batch row), key-major: dk_j and
//        dv_j accumulate in registers over all query tiles;
//   dq   one block per (tile of query rows, head, batch row), query-major:
//        dq_i = sum_j ds_ij k_j.
// Every output element has one owner, so there are no atomics and a repeat
// call is bitwise identical.
//
// What bounds them on this card: operations.  Per (b, h) and pair of valid
// frames the forward does 4*DK FLOPs (scores, P.v), the dK/dV kernel 8*DK
// (scores and dP recomputed, dV, dK) and the dQ kernel 6*DK (scores, dP,
// dQ), while moving O(T*DK) elements: at the training shape (B=8, H=4,
// T=1874, DK=64) the forward is 2.9e10 FLOP and dK/dV 5.8e10 against
// ~25 MB.  All seven products (forward S = Q K^T and O = P V; backward S,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K) run on the tensor cores
// with mma.sync m16n8k8 TF32 and the 3xTF32 split: each f32 operand becomes
// big = tf32(x) and small = tf32(x - big), and small.big + big.small +
// big.big in an f32 accumulator gives float32 accuracy (plain TF32 keeps
// ~10 bits and misses the forward's 2e-5 and the gradients' 1e-4
// tolerances).  Three TF32 products at 495 TFLOP/s make 165 TFLOP/s of
// f32-accurate products, 2.46x the CUDA-core peak.  To feed them: 16-row
// warp tiles whose score tiles stay in registers and feed the next product
// directly (see the fragment note below), the streamed operand split once a
// tile into shared big / small arrays that every warp reads (the split costs
// as many instructions as the products it feeds), 16-byte-padded shared rows
// that both fragment patterns read without bank conflicts, and cp.async
// copies of the next tile while this one multiplies.  The forward keeps a
// warp's split q fragments in registers for the whole key loop at DK = 64.
// bf16 inputs are exact in TF32, so their small parts and the products on
// them are dropped; P and dS keep the split.

#include <math.h>

#include "tensor_core.cuh"

namespace {

__device__ __forceinline__ bool is_valid(const int* __restrict__ valid_b, int i, int T_len) {
  return i < T_len && valid_b[i] != 0;
}

// ---------------------------------------------------------------------------
// tensor-core products with the 3xTF32 split (every kernel)
// ---------------------------------------------------------------------------
//
// Every product is a sum of mma.sync m16n8k8 TF32 tiles (A 16x8 row-major,
// B 8x8 column-major, C 16x8 in f32).  With g = lane / 4 and t = lane % 4 a
// thread holds A (g, t) (g+8, t) (g, t+4) (g+8, t+4), B (k t, n g) (k t+4,
// n g) and C (g, 2t) (g, 2t+1) (g+8, 2t) (g+8, 2t+1).  A product whose A
// operand is a C tile of the previous one (P in the forward, P^T and dS^T in
// the key-major kernel, dS in the query-major one) takes the k index in the order
// 2t, 2t+1 instead of t, t+4: the sum over k is the same, a C tile is then
// an A fragment as it stands (no shuffle, no shared-memory round trip), and
// the B fragment reads rows k0 + 2t and k0 + 2t + 1 of its tile.
//
// The split costs three instructions an element (cvt, sub, cvt), as many as
// the products it feeds, so each element is split once where it is shared:
// the streamed tile, the B operand of every warp, is split into big and
// small shared arrays once per tile by the thread that copied it, in the
// middle of the previous tile's products (double-buffered, so the split
// overlaps other warps' tensor-core work); the A operands (a warp's own 16
// rows, and the P / dS tiles in registers) are split as they are loaded.
// Each tile's products go into a fresh C tile that is then added to the
// running sum in f32: the tensor cores' accumulation truncates, and over
// 1874 frames a single running C tile drifts by ~2e-5 of the result; per
// tile the drift stays at the rounding of f32.

constexpr int BW = 4;            // warps per block
constexpr int BT = BW * 32;      // threads per block
constexpr float LOG2E = 1.4426950408889634f;

// Tiles for head dim DK: a block owns ROWS rows (keys in dK/dV, queries in
// the forward and dQ), 16 per warp row; the other operand streams in
// tiles of STREAM rows.  A warp owns 16 of the block's rows and DW = 64 output
// columns, so at DK = 128 (256) two (four) warps share their rows and each
// recomputes the scores of those rows: nothing crosses warps, and a thread's
// accumulators stay at 2 x 32 + 32 floats for every DK.  Shared rows are
// padded by 16 bytes: LD (raw, in elements of T) and LDF (split, 4-byte
// words) are then 4 mod 32 words, so both fragment patterns (rows g, columns
// t; rows 2t, columns g) hit 32 distinct banks.  A float32 tile lands (by
// cp.async) in its big array and is split in place; a bf16 tile lands in a
// raw array and is widened into big (its small part is 0 and not stored).
// Shared memory in float32: 103 KiB at DK = 64 (two blocks an SM), 163 and
// 166 KiB at 256 and 128, plus a byte a tile for the tile mask.
template <typename T, int DK>
struct Tiles {
  static constexpr int DW = 64;
  static constexpr int WD = DK / DW;
  static constexpr int WM = BW / WD;
  static constexpr int ROWS = 16 * WM;
  static constexpr int STREAM = DK == 256 ? 16 : 32;
  static constexpr int NS = STREAM / 8;         // n tiles of the scores
  static constexpr int LD = DK + 16 / (int)sizeof(T);
  static constexpr int LDF = DK + 4;
  static constexpr int RAW = STREAM * LD;       // elements of a raw streamed tile
  static constexpr int SPLIT = STREAM * LDF;    // words of a split streamed tile
  static constexpr bool EXACT = sizeof(T) == 2; // bf16 values are exact in TF32
  // [ROWS][LD] x 2 own rows; big, small (float32) or raw (bf16) [buffer][2]
  // streamed tiles; three [2][STREAM] rows of per-row values; the tile mask
  static constexpr size_t fixed_bytes() {
    return 2 * ROWS * LD * sizeof(T) + 4 * SPLIT * sizeof(uint32_t) +
           (EXACT ? 4 * RAW * sizeof(T) : 4 * SPLIT * sizeof(uint32_t)) +
           2 * STREAM * (2 * sizeof(float) + sizeof(int));
  }
  static size_t smem_bytes(int T_len) {
    return fixed_bytes() + ((T_len + STREAM - 1) / STREAM + 15) / 16 * 16;
  }
};

// the kernels' shared arrays, carved as Tiles lays them out
template <typename T, int DK>
struct TileSmem {
  using C = Tiles<T, DK>;
  T* own0;             // [ROWS][LD]: k (dK/dV) or q (forward, dQ)
  T* own1;             // [ROWS][LD]: v or dout (unused by the forward)
  uint32_t* big_base;  // [2 buffers][2 operands][SPLIT]
  uint32_t* small_base;
  T* raw_base;         // bf16 only: [2][2][RAW]
  float* row0;         // [2][STREAM]: lse (dK/dV)
  float* row1;         // [2][STREAM]: delta (dK/dV)
  int* mask;           // [2][STREAM]: the streamed rows' mask
  unsigned char* tiles;  // [n_tiles]: 1 where a streamed tile holds a valid frame
  __device__ TileSmem(unsigned char* p) {
    own0 = reinterpret_cast<T*>(p);
    own1 = own0 + C::ROWS * C::LD;
    big_base = reinterpret_cast<uint32_t*>(own1 + C::ROWS * C::LD);
    small_base = big_base + 4 * C::SPLIT;
    raw_base = reinterpret_cast<T*>(small_base);  // the bf16 layout has no small arrays
    unsigned char* rows = reinterpret_cast<unsigned char*>(big_base + 4 * C::SPLIT) +
                          (C::EXACT ? 4 * C::RAW * sizeof(T) : 4 * C::SPLIT * sizeof(uint32_t));
    row0 = reinterpret_cast<float*>(rows);
    row1 = row0 + 2 * C::STREAM;
    mask = reinterpret_cast<int*>(row1 + 2 * C::STREAM);
    tiles = reinterpret_cast<unsigned char*>(mask + 2 * C::STREAM);
  }
  __device__ uint32_t* big(int buf, int op) const { return big_base + (2 * buf + op) * C::SPLIT; }
  __device__ uint32_t* small(int buf, int op) const {
    return small_base + (2 * buf + op) * C::SPLIT;
  }
  // where the streamed tile lands: in place in big (float32) or raw (bf16)
  __device__ T* landing(int buf, int op) const {
    return C::EXACT ? raw_base + (2 * buf + op) * C::RAW : reinterpret_cast<T*>(big(buf, op));
  }
};

// rows [r0, r0 + ROWS) of a [T, DK] slab into a raw shared tile of row
// stride LD by 16-byte cp.async; rows past T are zero-filled (nothing is
// read).  A thread copies chunks idx = threadIdx.x + k * BT.
template <typename T, int DK, int LD, int ROWS>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src, int r0, int T_len, T* dst) {
  constexpr int E = 16 / (int)sizeof(T), CPR = DK / E;  // elements and chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += BT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r0 + r < T_len;
    cp_async16(dst + r * LD + c * E, src + (size_t)(ok ? r0 + r : 0) * DK + c * E, ok);
  }
}

// a landed streamed tile into its big / small arrays; a thread splits the
// chunks it copied (copy_rows' assignment), which its own cp.async wait has
// landed.  float32 is read and rewritten in place through the same words.
template <typename T, int DK>
__device__ __forceinline__ void split_rows(const T* raw, uint32_t* big, uint32_t* small) {
  using C = Tiles<T, DK>;
  constexpr int E = 16 / (int)sizeof(T), CPR = DK / E;
  for (int idx = threadIdx.x; idx < C::STREAM * CPR; idx += BT) {
    const int r = idx / CPR, c = idx % CPR;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const int o = r * C::LDF + c * E + e;
      float x[4];
      if (C::EXACT) {
        const T* src = raw + r * C::LD + c * E + e;
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = to_f32(src[i]);
      } else {
        const uint4 w = *reinterpret_cast<const uint4*>(big + o);
        x[0] = __uint_as_float(w.x), x[1] = __uint_as_float(w.y);
        x[2] = __uint_as_float(w.z), x[3] = __uint_as_float(w.w);
      }
      uint4 b4, s4;
      split_tf32<C::EXACT>(x[0], b4.x, s4.x);
      split_tf32<C::EXACT>(x[1], b4.y, s4.y);
      split_tf32<C::EXACT>(x[2], b4.z, s4.z);
      split_tf32<C::EXACT>(x[3], b4.w, s4.w);
      *reinterpret_cast<uint4*>(big + o) = b4;
      if (!C::EXACT) *reinterpret_cast<uint4*>(small + o) = s4;
    }
  }
}

// the tile mask: tiles[n] = 1 where rows [n STREAM, (n + 1) STREAM) hold a
// valid frame; ends with a block barrier
template <int STREAM>
__device__ __forceinline__ void mark_tiles(const int* __restrict__ valid_b, int T_len,
                                           unsigned char* tiles) {
  const int n_tiles = (T_len + STREAM - 1) / STREAM;
  for (int n = threadIdx.x; n < n_tiles; n += BT) tiles[n] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < T_len; i += BT)
    if (valid_b[i] != 0) tiles[i / STREAM] = 1;  // every writer stores the same value
  __syncthreads();
}

// the first tile start >= from that holds a valid frame, or T_len
template <int STREAM>
__device__ __forceinline__ int next_tile(const unsigned char* tiles, int from, int T_len) {
  for (int t0 = from; t0 < T_len; t0 += STREAM)
    if (tiles[t0 / STREAM]) return t0;
  return T_len;
}

// S (16 rows x STREAM) = A rows . B rows and dP likewise, over DK: rows
// [r0, r0 + 16) of the raw tiles sa / sa2 against every row of the split
// streamed tiles b / b2
template <typename T, int DK>
__device__ __forceinline__ void scores_and_dp(const T* sa, const uint32_t* bb, const uint32_t* bs,
                                              const T* sa2, const uint32_t* b2b,
                                              const uint32_t* b2s, int r0, int lane,
                                              float (&s)[Tiles<T, DK>::NS][4],
                                              float (&dp)[Tiles<T, DK>::NS][4]) {
  using C = Tiles<T, DK>;
#pragma unroll
  for (int n = 0; n < C::NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DK; k0 += 8) {
    uint32_t ab[4], as[4], a2b[4], a2s[4];
    load_a<C::EXACT, C::LD>(sa, r0, k0, lane, ab, as);
    load_a<C::EXACT, C::LD>(sa2, r0, k0, lane, a2b, a2s);
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      uint32_t fb[2], fs[2];
      load_b_t<C::EXACT, C::LDF>(bb, bs, n * 8, k0, lane, fb, fs);
      mma_3xtf32<C::EXACT, C::EXACT>(s[n], ab, as, fb, fs);
      load_b_t<C::EXACT, C::LDF>(b2b, b2s, n * 8, k0, lane, fb, fs);
      mma_3xtf32<C::EXACT, C::EXACT>(dp[n], a2b, a2s, fb, fs);
    }
  }
}

// acc (16 rows x DW columns from d0) += X (16 x STREAM, C tiles) . tile
// (STREAM x DK, split); X is P^T, dS^T or dS, the tile dout, q or k.  The
// tile's products go into a fresh C tile, added to acc in f32.
template <typename T, int DK>
__device__ __forceinline__ void accumulate(const float (&x)[Tiles<T, DK>::NS][4],
                                           const uint32_t* big, const uint32_t* small, int d0,
                                           int lane, float (&acc)[Tiles<T, DK>::DW / 8][4]) {
  using C = Tiles<T, DK>;
  float part[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::NS; ++kk) {
    uint32_t ab[4], as[4];
    c_as_a(x[kk], ab, as);
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n) {
      uint32_t fb[2], fs[2];
      load_b_perm<C::EXACT, C::LDF>(big, small, kk * 8, d0 + n * 8, lane, fb, fs);
      mma_3xtf32<false, C::EXACT>(part[n], ab, as, fb, fs);
    }
  }
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// rows [r0, r0 + 16) x columns [d0, d0 + DW) of a [T, DK] output from C tiles
template <typename T, int DK>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int r0, int d0, int T_len,
                                           int lane, const float (&acc)[Tiles<T, DK>::DW / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= T_len) continue;
#pragma unroll
    for (int n = 0; n < Tiles<T, DK>::DW / 8; ++n) {
      T* p = dst + (size_t)r * DK + d0 + n * 8 + 2 * t;
      p[0] = from_f32<T>(acc[n][2 * half]);
      p[1] = from_f32<T>(acc[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
//
// One block per (tile of ROWS query rows, head, batch row, key split), warps
// as in the dQ kernel; the split's key tiles (k and v split into big and
// small arrays, the key mask) stream through two buffers in the same way.
// Per key tile: S = Q K^T; masked keys -inf; the running row max m and the
// lane's part of the row sum l in base 2 (the max over the quad of lanes that
// shares a row, by two shuffles; the sum's quad reduction waits for the
// end); P = 2^(S scale log2(e) - m); O = O alpha + P V, with alpha =
// 2^(m_old - m) and P V in a fresh C tile.  At DK = 64 the warp's 16 q rows
// are split into TF32 fragments once and stay in 64 registers; at 128 and
// 256 they are split from the shared q tile per key tile, as in dQ.

// S (16 rows x STREAM) = Q rows [r0, r0 + 16) . every row of the split key
// tile, over DK; the A fragments from registers (QF = DK / 8) or split from
// the raw q tile as they are loaded (QF = 1)
template <typename T, int DK, int QF>
__device__ __forceinline__ void qk_scores(const uint32_t (&qb)[QF][4], const uint32_t (&qs)[QF][4],
                                          const T* sq, const uint32_t* kb, const uint32_t* ks,
                                          int r0, int lane, float (&s)[Tiles<T, DK>::NS][4]) {
  using C = Tiles<T, DK>;
#pragma unroll
  for (int n = 0; n < C::NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DK; k0 += 8) {
    uint32_t ab[4], as[4];
    if constexpr (QF == DK / 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[e] = qb[k0 / 8][e], as[e] = qs[k0 / 8][e];
    } else {
      load_a<C::EXACT, C::LD>(sq, r0, k0, lane, ab, as);
    }
#pragma unroll
    for (int n = 0; n < C::NS; ++n) {
      uint32_t fb[2], fs[2];
      load_b_t<C::EXACT, C::LDF>(kb, ks, n * 8, k0, lane, fb, fs);
      mma_3xtf32<C::EXACT, C::EXACT>(s[n], ab, as, fb, fs);
    }
  }
}

constexpr float LN2 = 0.6931471805599453f;

// work == nullptr (one split): out and lse.  Otherwise split s of S writes
// its unnormalized output rows (float32 [S][B H T][DK]) and its base-2 (max,
// sum) pairs (float32 [S][B H T][2], after the outputs) to work, for
// flash_fwd_merge_kernel.
template <typename T, int DK>
__global__ void __launch_bounds__(BT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ valid, T* __restrict__ out, float* __restrict__ lse,
                 float* __restrict__ work, int splits, int H, int T_len, float scale) {
  using C = Tiles<T, DK>;
  constexpr int QF = DK == 64 ? DK / 8 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem<T, DK> sm(smem_raw);  // own rows: q; streamed operands: 0 = k, 1 = v

  const int i0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp % C::WM) * 16;  // the warp's query rows in the tile
  const int d0 = (warp / C::WM) * C::DW;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;
  // the split's keys: tiles [split n / splits, (split + 1) n / splits)
  const int n_tiles = (T_len + C::STREAM - 1) / C::STREAM;
  const int j_begin = split * n_tiles / splits * C::STREAM;
  const int j_end = min(T_len, (split + 1) * n_tiles / splits * C::STREAM);

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8: running max, base 2
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  float acc[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // a tile of pad rows only is written as zeros without reading a key
  const bool any_q = __syncthreads_or(tid < C::ROWS && is_valid(valid_b, i0 + tid, T_len));
  if (any_q) {
    auto load_tile = [&](int j0, int buf) {
      copy_rows<T, DK, C::LD, C::STREAM>(k + base, j0, T_len, sm.landing(buf, 0));
      copy_rows<T, DK, C::LD, C::STREAM>(v + base, j0, T_len, sm.landing(buf, 1));
      if (tid < C::STREAM) {
        const bool ok = j0 + tid < T_len;
        cp_async4(sm.mask + buf * C::STREAM + tid, valid_b + (ok ? j0 + tid : 0), ok);
      }
      cp_async_commit();
    };
    auto split_tile = [&](int buf) {
      cp_async_wait_all();
      split_rows<T, DK>(sm.landing(buf, 0), sm.big(buf, 0), sm.small(buf, 0));
      split_rows<T, DK>(sm.landing(buf, 1), sm.big(buf, 1), sm.small(buf, 1));
    };
    copy_rows<T, DK, C::LD, C::ROWS>(q + base, i0, T_len, sm.own0);
    cp_async_commit();
    // masked keys take no probability: tiles of them are skipped whole
    mark_tiles<C::STREAM>(valid_b, T_len, sm.tiles);
    int j0 = next_tile<C::STREAM>(sm.tiles, j_begin, j_end);
    if (j0 < j_end) load_tile(j0, 0);
    split_tile(0);  // waits for q too
    __syncthreads();
    uint32_t qb[QF][4], qs[QF][4];
    if constexpr (QF == DK / 8) {
#pragma unroll
      for (int kk = 0; kk < QF; ++kk)
        load_a<C::EXACT, C::LD>(sm.own0, r0, kk * 8, lane, qb[kk], qs[kk]);
    }
    const float sl2 = scale * LOG2E;
    for (int buf = 0; j0 < j_end; buf ^= 1) {
      __syncthreads();
      const int j_next = next_tile<C::STREAM>(sm.tiles, j0 + C::STREAM, j_end);
      if (j_next < j_end) load_tile(j_next, buf ^ 1);

      float s[C::NS][4];  // S, then P
      qk_scores<T, DK, QF>(qb, qs, sm.own0, sm.big(buf, 0), sm.small(buf, 0), r0, lane, s);
      // every processed tile holds a valid key, so the new maxima are finite
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const int2 kv = *reinterpret_cast<const int2*>(sm.mask + buf * C::STREAM + n * 8 +
                                                       2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ((e & 1) ? kv.y : kv.x) != 0 ? s[n][e] * sl2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = quad_max(mx[half]);
        alpha[half] = exp2_approx(m[half] - mx[half]);  // 0 on the first tile
        m[half] = mx[half];
        l[half] *= alpha[half];
      }
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
          l[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      if (j_next < j_end) split_tile(buf ^ 1);
      accumulate<T, DK>(s, sm.big(buf, 1), sm.small(buf, 1), d0, lane, acc);  // O += P V
      j0 = j_next;
    }
  }

  const int g = lane >> 2, t = lane & 3;
  const size_t rows_all = (size_t)gridDim.z / splits * H * T_len;  // B H T
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + g + 8 * half;
    if (i >= T_len) continue;
    const float l_row = quad_sum(l[half]);
    if (work == nullptr) {
      const bool ok = is_valid(valid_b, i, T_len);  // implies any_q, so l_row >= 1
      const float inv_l = ok ? 1.f / l_row : 0.f;
      T* p = out + base + (size_t)i * DK + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n) {
        p[n * 8] = from_f32<T>(acc[n][2 * half] * inv_l);
        p[n * 8 + 1] = from_f32<T>(acc[n][2 * half + 1] * inv_l);
      }
      if (lse != nullptr && d0 == 0 && t == 0)
        lse[row_base + i] = ok ? (m[half] + log2f(l_row)) * LN2 : 0.f;
    } else {
      const size_t row = split * rows_all + row_base + i;
      float* p = work + row * DK + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n)
        *reinterpret_cast<float2*>(p + n * 8) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
      if (d0 == 0 && t == 0)
        *reinterpret_cast<float2*>(work + splits * rows_all * DK + 2 * row) =
            make_float2(m[half], l_row);
    }
  }
}

// The splits of flash_fwd_kernel merged in their fixed order, one warp a
// row: out = sum_s O_s 2^(m_s - M) / L, L = sum_s l_s 2^(m_s - M), M the
// largest m_s (a split with no valid key has m_s = -inf and adds 0).
template <typename T, int DK>
__global__ void __launch_bounds__(BT)
flash_fwd_merge_kernel(const float* __restrict__ work, const int* __restrict__ valid,
                       T* __restrict__ out, float* __restrict__ lse, int splits, int B, int H,
                       int T_len) {
  const size_t rows_all = (size_t)B * H * T_len;
  const size_t row = (size_t)blockIdx.x * BW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows_all) return;
  const int i = (int)(row % T_len);
  const int b = (int)(row / ((size_t)H * T_len));
  float o[DK / 32];
#pragma unroll
  for (int c = 0; c < DK / 32; ++c) o[c] = 0.f;
  float m_all = -INFINITY, l_all = 0.f;
  const bool ok = valid[(size_t)b * T_len + i] != 0;  // a valid row has its own key
  if (ok) {
    const float2* ml = reinterpret_cast<const float2*>(work + splits * rows_all * DK);
    for (int s = 0; s < splits; ++s) m_all = fmaxf(m_all, ml[s * rows_all + row].x);
    for (int s = 0; s < splits; ++s) {
      const float2 st = ml[s * rows_all + row];
      const float wgt = exp2f(st.x - m_all);
      l_all += wgt * st.y;
      const float* src = work + (s * rows_all + row) * DK;
#pragma unroll
      for (int c = 0; c < DK / 32; ++c) o[c] += wgt * src[c * 32 + lane];
    }
  }
  const float inv_l = ok ? 1.f / l_all : 0.f;
#pragma unroll
  for (int c = 0; c < DK / 32; ++c) out[row * DK + c * 32 + lane] = from_f32<T>(o[c] * inv_l);
  if (lse != nullptr && lane == 0) lse[row] = ok ? (m_all + log2f(l_all)) * LN2 : 0.f;
}

// ---------------------------------------------------------------------------
// backward, key-major: dk and dv
// ---------------------------------------------------------------------------
//
// One block per (tile of ROWS keys, head, batch row).  Warp (wm, wd) owns
// keys [16 wm, 16 wm + 16) of the tile and output columns [64 wd, 64 wd + 64).
// Query tiles stream through two buffers: at the top of a tile one barrier
// publishes its split q and dout (and lse, delta, mask); the next valid
// tile's cp.async copy starts; S^T = K Q^T and dP^T = V dO^T (C tiles in
// registers), P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale;
// the thread waits for its own chunks of the next tile and splits them; then
// dV += P^T dO and dK += dS^T Q, the accumulators in registers throughout.

template <typename T, int DK>
__global__ void __launch_bounds__(BT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ valid, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk_out, T* __restrict__ dv_out, int H, int T_len,
                     float scale) {
  using C = Tiles<T, DK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem<T, DK> sm(smem_raw);  // own rows: k, v; streamed operands: 0 = q, 1 = dout

  const int j0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp % C::WM) * 16;     // the warp's keys in the tile
  const int d0 = (warp / C::WM) * C::DW;  // the warp's output columns
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;

  float acc_k[C::DW / 8][4], acc_v[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  // masked keys take no probability: a tile of them gets zero gradients
  const bool any_k = __syncthreads_or(tid < C::ROWS && is_valid(valid_b, j0 + tid, T_len));
  if (any_k) {
    const bool key_ok[2] = {is_valid(valid_b, j0 + r0 + (lane >> 2), T_len),
                            is_valid(valid_b, j0 + r0 + (lane >> 2) + 8, T_len)};
    auto load_tile = [&](int i0, int buf) {
      copy_rows<T, DK, C::LD, C::STREAM>(q + base, i0, T_len, sm.landing(buf, 0));
      copy_rows<T, DK, C::LD, C::STREAM>(dout + base, i0, T_len, sm.landing(buf, 1));
      if (tid < C::STREAM) {
        const bool ok = i0 + tid < T_len;
        const size_t src = ok ? row_base + i0 + tid : row_base;
        cp_async4(sm.row0 + buf * C::STREAM + tid, lse + src, ok);
        cp_async4(sm.row1 + buf * C::STREAM + tid, delta + src, ok);
        cp_async4(sm.mask + buf * C::STREAM + tid, valid_b + (ok ? i0 + tid : 0), ok);
      }
      cp_async_commit();
    };
    auto split_tile = [&](int buf) {
      cp_async_wait_all();
      split_rows<T, DK>(sm.landing(buf, 0), sm.big(buf, 0), sm.small(buf, 0));
      split_rows<T, DK>(sm.landing(buf, 1), sm.big(buf, 1), sm.small(buf, 1));
    };
    copy_rows<T, DK, C::LD, C::ROWS>(k + base, j0, T_len, sm.own0);
    copy_rows<T, DK, C::LD, C::ROWS>(v + base, j0, T_len, sm.own1);
    cp_async_commit();
    // pad query rows carry no gradient: tiles of them are skipped whole
    mark_tiles<C::STREAM>(valid_b, T_len, sm.tiles);
    int i0 = next_tile<C::STREAM>(sm.tiles, 0, T_len);
    if (i0 < T_len) load_tile(i0, 0);
    split_tile(0);  // waits for k and v too
    const float sl2 = scale * LOG2E;
    for (int buf = 0; i0 < T_len; buf ^= 1) {
      // publishes this tile's split arrays and rows; every warp is done with
      // the other buffer, which the next tile now takes
      __syncthreads();
      const int i_next = next_tile<C::STREAM>(sm.tiles, i0 + C::STREAM, T_len);
      if (i_next < T_len) load_tile(i_next, buf ^ 1);

      float st[C::NS][4], dpt[C::NS][4];  // S^T and dP^T, then P^T and dS^T
      scores_and_dp<T, DK>(sm.own0, sm.big(buf, 0), sm.small(buf, 0), sm.own1, sm.big(buf, 1),
                           sm.small(buf, 1), r0, lane, st, dpt);
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const int col = buf * C::STREAM + n * 8 + 2 * (lane & 3);
        const float2 l2 = *reinterpret_cast<const float2*>(sm.row0 + col);
        const float2 dl = *reinterpret_cast<const float2*>(sm.row1 + col);
        const int2 qv = *reinterpret_cast<const int2*>(sm.mask + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = key_ok[e >> 1] && ((e & 1) ? qv.y : qv.x) != 0;
          const float l = (e & 1) ? l2.y : l2.x, dlt = (e & 1) ? dl.y : dl.x;
          const float p = ok ? exp2_approx(fmaf(st[n][e], sl2, -l * LOG2E)) : 0.f;
          dpt[n][e] = ok ? p * (dpt[n][e] - dlt) * scale : 0.f;
          st[n][e] = p;
        }
      }
      if (i_next < T_len) split_tile(buf ^ 1);
      accumulate<T, DK>(st, sm.big(buf, 1), sm.small(buf, 1), d0, lane, acc_v);   // dV += P^T dO
      accumulate<T, DK>(dpt, sm.big(buf, 0), sm.small(buf, 0), d0, lane, acc_k);  // dK += dS^T Q
      i0 = i_next;
    }
  }
  store_rows<T, DK>(dk_out + base, j0 + r0, d0, T_len, lane, acc_k);
  store_rows<T, DK>(dv_out + base, j0 + r0, d0, T_len, lane, acc_v);
}

// ---------------------------------------------------------------------------
// backward, query-major: dq
// ---------------------------------------------------------------------------
//
// One block per (tile of ROWS query rows, head, batch row), warps as in the
// key-major kernel over query rows; key tiles (k and v split as above, the
// key mask) stream through two buffers in the same way.  Per key tile:
// S = Q K^T, dP = dO V^T, dS = P (dP - delta) scale, dQ += dS K.

template <typename T, int DK>
__global__ void __launch_bounds__(BT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ valid, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int T_len, float scale) {
  using C = Tiles<T, DK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileSmem<T, DK> sm(smem_raw);  // own rows: q, dout; streamed operands: 0 = k, 1 = v

  const int i0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (warp % C::WM) * 16;  // the warp's query rows in the tile
  const int d0 = (warp / C::WM) * C::DW;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * DK;
  const int* valid_b = valid + (size_t)b * T_len;

  bool row_ok[2];
  float nl2[2], dlt[2];  // -lse log2(e) and delta of rows g and g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + (lane >> 2) + 8 * half;
    row_ok[half] = is_valid(valid_b, i, T_len);
    nl2[half] = row_ok[half] ? -lse[row_base + i] * LOG2E : 0.f;
    dlt[half] = row_ok[half] ? delta[row_base + i] : 0.f;
  }
  float acc[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // a tile of pad rows only is written as zeros without reading a key
  const bool any_q = __syncthreads_or(tid < C::ROWS && is_valid(valid_b, i0 + tid, T_len));
  if (any_q) {
    auto load_tile = [&](int j0, int buf) {
      copy_rows<T, DK, C::LD, C::STREAM>(k + base, j0, T_len, sm.landing(buf, 0));
      copy_rows<T, DK, C::LD, C::STREAM>(v + base, j0, T_len, sm.landing(buf, 1));
      if (tid < C::STREAM) {
        const bool ok = j0 + tid < T_len;
        cp_async4(sm.mask + buf * C::STREAM + tid, valid_b + (ok ? j0 + tid : 0), ok);
      }
      cp_async_commit();
    };
    auto split_tile = [&](int buf) {
      cp_async_wait_all();
      split_rows<T, DK>(sm.landing(buf, 0), sm.big(buf, 0), sm.small(buf, 0));
      split_rows<T, DK>(sm.landing(buf, 1), sm.big(buf, 1), sm.small(buf, 1));
    };
    copy_rows<T, DK, C::LD, C::ROWS>(q + base, i0, T_len, sm.own0);
    copy_rows<T, DK, C::LD, C::ROWS>(dout + base, i0, T_len, sm.own1);
    cp_async_commit();
    // masked keys take no probability: tiles of them are skipped whole
    mark_tiles<C::STREAM>(valid_b, T_len, sm.tiles);
    int j0 = next_tile<C::STREAM>(sm.tiles, 0, T_len);
    if (j0 < T_len) load_tile(j0, 0);
    split_tile(0);  // waits for q and dout too
    const float sl2 = scale * LOG2E;
    for (int buf = 0; j0 < T_len; buf ^= 1) {
      __syncthreads();
      const int j_next = next_tile<C::STREAM>(sm.tiles, j0 + C::STREAM, T_len);
      if (j_next < T_len) load_tile(j_next, buf ^ 1);

      float s[C::NS][4], dp[C::NS][4];  // S and dP, then dS in dp
      scores_and_dp<T, DK>(sm.own0, sm.big(buf, 0), sm.small(buf, 0), sm.own1, sm.big(buf, 1),
                           sm.small(buf, 1), r0, lane, s, dp);
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
        const int2 kv = *reinterpret_cast<const int2*>(sm.mask + buf * C::STREAM + n * 8 +
                                                       2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok[e >> 1] && ((e & 1) ? kv.y : kv.x) != 0;
          const float p = ok ? exp2_approx(fmaf(s[n][e], sl2, nl2[e >> 1])) : 0.f;
          dp[n][e] = ok ? p * (dp[n][e] - dlt[e >> 1]) * scale : 0.f;
        }
      }
      if (j_next < T_len) split_tile(buf ^ 1);
      accumulate<T, DK>(dp, sm.big(buf, 0), sm.small(buf, 0), d0, lane, acc);  // dQ += dS K
      j0 = j_next;
    }
  }
  store_rows<T, DK>(dq + base, i0 + r0, d0, T_len, lane, acc);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// key splits of the forward: as many as keep every block of the grid in one
// wave of resident blocks (B = 1 serving fills the card), at most MAX_SPLITS
// and at most one per key tile; a negative value is minus a CUDA error code
constexpr int MAX_SPLITS = 8;

template <typename T, int DK>
int fwd_splits(int B, int H, int T_len) {
  using C = Tiles<T, DK>;
  const size_t smem = C::smem_bytes(T_len);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DK>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_kernel<T, DK>, BT, smem);
  if (e != cudaSuccess) return -(int)e;
  const long blocks = (long)B * H * ((T_len + C::ROWS - 1) / C::ROWS);
  const long n_tiles = (T_len + C::STREAM - 1) / C::STREAM;
  long splits = (long)per_sm * sms / (blocks > 0 ? blocks : 1);
  splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
  splits = splits < n_tiles ? splits : n_tiles;
  return (int)(splits > 1 ? splits : 1);
}

template <typename T, int DK>
int launch_fwd(const void* q, const void* k, const void* v, const void* valid, void* out,
               void* lse, void* work, int splits, int B, int H, int T_len, float scale,
               cudaStream_t stream) {
  using C = Tiles<T, DK>;
  if (splits < 1 || (splits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(T_len);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + C::ROWS - 1) / C::ROWS, H, B * splits);
  flash_fwd_kernel<T, DK><<<grid, BT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<T*>(out), static_cast<float*>(lse),
      splits > 1 ? static_cast<float*>(work) : nullptr, splits, H, T_len, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t rows_all = (size_t)B * H * T_len;
  flash_fwd_merge_kernel<T, DK><<<(unsigned)((rows_all + BW - 1) / BW), BT, 0, stream>>>(
      static_cast<const float*>(work), static_cast<const int*>(valid), static_cast<T*>(out),
      static_cast<float*>(lse), splits, B, H, T_len);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_dkv(const void* q, const void* k, const void* v, const void* valid, const void* dout,
               const void* lse, const void* delta, void* dk_out, void* dv_out, int B, int H,
               int T_len, float scale, cudaStream_t stream) {
  using C = Tiles<T, DK>;
  const size_t smem = C::smem_bytes(T_len);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + C::ROWS - 1) / C::ROWS, H, B);
  flash_bwd_dkv_kernel<T, DK><<<grid, BT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), H, T_len, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_dq(const void* q, const void* k, const void* v, const void* valid, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H, int T_len, float scale,
              cudaStream_t stream) {
  using C = Tiles<T, DK>;
  const size_t smem = C::smem_bytes(T_len);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T_len + C::ROWS - 1) / C::ROWS, H, B);
  flash_bwd_dq_kernel<T, DK><<<grid, BT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), H,
      T_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One dispatch over (dtype, head dim) for each entry point: dtype 0 =
// float32, 1 = bfloat16; dk 64, 128 or 256; anything else is refused.
#define FLASH_DISPATCH(LAUNCH, ...)                                   \
  if (dtype == 0) {                                                   \
    if (dk == 64) return LAUNCH<float, 64>(__VA_ARGS__);              \
    if (dk == 128) return LAUNCH<float, 128>(__VA_ARGS__);            \
    if (dk == 256) return LAUNCH<float, 256>(__VA_ARGS__);            \
  } else if (dtype == 1) {                                            \
    if (dk == 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);      \
    if (dk == 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);    \
    if (dk == 256) return LAUNCH<__nv_bfloat16, 256>(__VA_ARGS__);    \
  }                                                                   \
  return (int)cudaErrorInvalidValue;

extern "C" {

// The number of key splits flash_attention_fwd takes for this shape on the
// current device (>= 1), or minus a CUDA error code.
int flash_attention_fwd_splits(int B, int H, int T_len, int dk, int dtype) {
  if ((dk != 64 && dk != 128 && dk != 256) || (dtype != 0 && dtype != 1))
    return -(int)cudaErrorInvalidValue;
  FLASH_DISPATCH(fwd_splits, B, H, T_len)
}

// q, k, v, out: [B, H, T, dk] in dtype; valid: int32 [B, T]; lse: float32
// [B, H, T] or null (not written); work: float32 [splits, B, H, T, dk + 2]
// when splits > 1 (else unused; may be null).
int flash_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                        void* out, void* lse, void* work, int splits, int B, int H, int T_len,
                        int dk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_fwd, q, k, v, valid, out, lse, work, splits, B, H, T_len, scale, s)
}

// dk_out, dv_out for the output gradient dout, given the forward's lse and
// delta = rowsum(out * dout), both float32 [B, H, T].
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* valid,
                            const void* dout, const void* lse, const void* delta, void* dk_out,
                            void* dv_out, int B, int H, int T_len, int dk, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dkv, q, k, v, valid, dout, lse, delta, dk_out, dv_out, B, H, T_len,
                 scale, s)
}

// dq for the output gradient dout, from the same lse and delta.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* valid,
                           const void* dout, const void* lse, const void* delta, void* dq, int B,
                           int H, int T_len, int dk, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(launch_dq, q, k, v, valid, dout, lse, delta, dq, B, H, T_len, scale, s)
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
