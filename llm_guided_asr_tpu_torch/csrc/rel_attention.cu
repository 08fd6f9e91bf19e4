// Relative-position (Transformer-XL) self-attention, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of llm_guided_asr_tpu/ops/rel_attention.py:
// _fwd_kernel (called through _fwd_call) and _bwd_kernel (called through
// _vjp_bwd).  For one (b, h):
//
//   s[i,j]  = (qu_i . k_j + qv_i . p_{(T-1)-i+j}) * scale   p: [2T-1, dk], row T-1 = offset 0
//   P[i,j]  = softmax_j(mask_j(s[i,:]))                     mask: kv_valid[b,j]
//   out_i   = sum_j keep_ij / (1-rate) * P[i,j] v_j         keep: the hash of dropout_keep
//
// Masked keys score -1e30 after the scale (as the TPU kernel does), so a
// batch row whose keys are all masked averages v over all T keys; keys past
// T are excluded outright.  Attention-prob dropout re-derives the TPU
// kernel's counter hash of (seed, head, batch, i, j) bit for bit, after the
// pre-dropout normaliser, so the forward and the backward drop the same
// probabilities without storing a mask.
//
// What bounds them on this card: operations.  The forward does 6*T*T*dk
// FLOPs per (b, h) (two score products and P.v), the backward 16*T*T*dk
// (the two score products recomputed, dP, dV, dK, dQu, dQv and dp), while
// moving O(T*dk) elements.  Every product runs on the tensor cores as
// mma.sync m16n8k8 TF32 with the 3xTF32 split (tensor_core.cuh): float32
// accuracy at 165 TFLOP/s, against 67 on the CUDA cores.  Each tile's
// products go into a fresh C tile added to the running sum in f32 (the
// tensor cores' accumulation truncates).  With one block of four warps an
// SM the products waited on latency (a warp per scheduler); the kernels
// therefore keep most shared tiles raw, splitting each element as its
// fragment loads (a few ALU instructions against a tile's ~2,600 cycles of
// mma.sync), so that two blocks fit an SM: 102-110 KB of shared memory at
// dk 64 instead of 158-218 KB.  Only tiles that every warp reads many times
// and that fit the budget (the forward's key and value tiles, the
// key-major kernel's query tiles) are split once when stored.
//
// The positional term is a band product.  A warp's 16 query rows i and a
// tile's BK keys j touch the 16 + BK - 1 positional rows
// p[(T-1)-(i0+15)+j0 ...], so the warp multiplies its 16 qv rows against
// those rows (a [16, 16 + BK] band, (16 + BK) / BK of the positional
// product) into a per-warp scratch tile, and reads it skewed:
// s2[ii][jj] = band[ii][(15 - ii) + jj].  The block streams the union of
// its warps' rows (ROWS + BK of them) through a ring that gains BK rows a
// key tile.  The backward uses the same skew three more times: dQv =
// band(dS) . P_rows (dS written skewed into the scratch), and on the
// key-major side the positional scores (one block-wide band, queries by
// positional rows) and dp = band(dS^T)^T . Qv, a [ROWS + BQ, dk] band per
// query tile kept in registers as a ring of 16-row C tiles.
//
// Forward: one block per (tile of ROWS query rows, head, batch row, key
// split); the online softmax runs in base 2 with float32 statistics and
// the natural-log lse is stored for the backward.  At a small grid (B = 1
// serving) the key range is split over several blocks per query tile, each
// writing its unnormalized output and (max, sum) to a float32 workspace,
// and a merge kernel combines the splits in their fixed order: a repeat
// call is bitwise equal.
//
// Backward (the FlashAttention-2 split, scores recomputed from the saved
// lse), four kernels in one entry point:
//   delta      delta_i = dout_i . out_i (= rowsum(dP o P) with dropout too,
//              since the normaliser is the pre-dropout one);
//   key-major  one block per (tile of ROWS keys, head, batch row): dk and
//              dv in registers over all query tiles (streamed last to
//              first, BQ at a time), and the block's dp rows, flushed as
//              the band slides past them into a float32 workspace of
//              per-block partials;
//   query-major one block per (tile of ROWS queries, head, batch row): dqu
//              and dqv;
//   dp reduce  dp[h, r] = the sum of the partials over the batch rows and
//              key tiles, in a fixed order.
// Every output element has one owner and no atomics are used, so a repeat
// call is bitwise equal.
//
// Tiles stream through one shared buffer: a tile's global loads are issued
// into registers before the previous tile's products and stored after
// them, so the loads overlap the tensor-core work.  Head dims up to
// 128 are padded to DK = 32, 64 or 128 with zero columns as they load;
// dk == DK with aligned operands loads 16 (8 for bf16) bytes a chunk.
// bf16 inputs are exact in TF32: their small parts and the products on
// them are dropped, while P and dS keep the split.

#include <limits.h>
#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int BW = 4;            // warps per block
constexpr int BT = BW * 32;      // threads per block
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED2 = MASKED * LOG2E;  // a masked key's score in base 2

// A warp owns 16 rows and DW output columns; at DK = 128 two warps share
// their rows (each recomputes the rows' scores), so a thread's accumulators
// stay at 32 floats.  Split shared rows are DK + 4 words: 4 mod 32, so both
// fragment patterns hit 32 distinct banks.
template <typename T, int DK>
struct Cfg {
  static constexpr int DW = DK < 64 ? DK : 64;
  static constexpr int WD = DK / DW;
  static constexpr int WM = BW / WD;
  static constexpr int ROWS = 16 * WM;
  static constexpr int LDF = DK + 4;
  static constexpr bool EXACT = sizeof(T) == 2;
  static constexpr int PLANES = EXACT ? 1 : 2;     // big (and small)
  static constexpr int BK = DK == 128 ? 16 : 32;   // keys per streamed tile (query-major kernels)
  static constexpr int BQ = 16;                    // queries per streamed tile (key-major)
  __host__ __device__ static constexpr size_t words(int rows) { return (size_t)PLANES * rows * LDF; }
  // a raw tile (split as its fragments load): rows of LDR elements, 16
  // bytes of padding, 4 mod 32 words again
  static constexpr int LDR = DK + 16 / (int)sizeof(T);
  __host__ __device__ static constexpr size_t raw_words(int rows) {
    return (size_t)rows * LDR * sizeof(T) / 4;
  }
};

// Shared tiles.  Every fragment element is read through elem(row, col),
// which gives its TF32 big and small parts: a Split tile was split once as
// it was stored (big and small planes of LD words a row; small aliases big
// for bf16, whose small parts are 0 and never read); a Raw tile holds the
// values as loaded and splits them as they are read, in half the shared
// memory; a Ring maps a window's rows onto the positional ring.
template <int LD, bool EXACT_>
struct Split {
  static constexpr bool EXACT = EXACT_;
  uint32_t* big;
  uint32_t* small;
  __device__ __forceinline__ void elem(int r, int c, uint32_t& b, uint32_t& s) const {
    b = big[r * LD + c];
    s = EXACT ? 0u : small[r * LD + c];
  }
};

template <typename T, int LD, bool EXACT_ = sizeof(T) == 2>
struct Raw {
  static constexpr bool EXACT = EXACT_;
  T* p;
  __device__ __forceinline__ void elem(int r, int c, uint32_t& b, uint32_t& s) const {
    split_tf32<EXACT>(to_f32(p[r * LD + c]), b, s);
  }
};

// The positional ring: a block's window of W positional rows [rb, rb + W)
// slides up STEP rows a tile; global row r lives in slot (r - rb0) % W,
// rb0 the first window's start.  A Ring views the rows from ring offset
// off (0 <= off < W; rows r < W).
template <class Tile, int W>
struct Ring {
  static constexpr bool EXACT = Tile::EXACT;
  Tile tile;
  int off;
  __device__ __forceinline__ void elem(int r, int c, uint32_t& b, uint32_t& s) const {
    const int slot = off + r;
    tile.elem(slot < W ? slot : slot - W, c, b, s);
  }
};

template <typename T, int DK>
using SplitTile = Split<Cfg<T, DK>::LDF, Cfg<T, DK>::EXACT>;
template <typename T, int DK>
using RawTile = Raw<T, Cfg<T, DK>::LDR>;

template <typename T, int DK>
__device__ __forceinline__ SplitTile<T, DK> carve(uint32_t*& p, int rows) {
  using C = Cfg<T, DK>;
  SplitTile<T, DK> s{p, C::EXACT ? p : p + rows * C::LDF};
  p += C::words(rows);
  return s;
}

template <typename T, int DK>
__device__ __forceinline__ RawTile<T, DK> carve_raw(uint32_t*& p, int rows) {
  RawTile<T, DK> s{reinterpret_cast<T*>(p)};
  p += Cfg<T, DK>::raw_words(rows);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The TPU kernel's dropout_keep_mask, one element: uint32 arithmetic wraps
// exactly as jnp.uint32 does.  cell = seed + h*0x927C1 + b*0x68E31DA5.
__device__ __forceinline__ bool dropout_keep(uint32_t cell, int i, int j, uint32_t threshold) {
  uint32_t x = (uint32_t)i * 0x9E3779B1u + (uint32_t)j * 0x85EBCA77u;
  x ^= cell;
  x = (x ^ (x >> 15)) * 0x2C1B3C6Du;
  x = (x ^ (x >> 12)) * 0x297A2D39u;
  x ^= x >> 15;
  return x >= threshold;
}

__device__ __forceinline__ uint32_t dropout_cell(uint32_t seed, int h, int b) {
  return seed + (uint32_t)h * 0x927C1u + (uint32_t)b * 0x68E31DA5u;
}

struct Dropout {
  uint32_t seed;       // the int32 seed's bits
  uint32_t threshold;  // uint32(rate * 2^32); 0 keeps everything
  float inv_keep;      // 1 / (1 - rate)
};

// key state in a tile: 2 = valid, 1 = masked (-1e30), 0 = past T
__device__ __forceinline__ int key_state(const int* __restrict__ valid_b, int j, int T_len) {
  return j < T_len ? (valid_b[j] != 0 ? 2 : 1) : 0;
}

// ---------------------------------------------------------------------------
// loading rows: global -> registers -> split shared tile
// ---------------------------------------------------------------------------

template <typename T> struct Raw4;  // 4 consecutive elements as loaded
template <> struct Raw4<float> { float4 v; };
template <> struct Raw4<__nv_bfloat16> { uint2 v; };

__device__ __forceinline__ void to4(const Raw4<float>& r, float (&x)[4]) {
  x[0] = r.v.x, x[1] = r.v.y, x[2] = r.v.z, x[3] = r.v.w;
}
__device__ __forceinline__ void to4(const Raw4<__nv_bfloat16>& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.v.x << 16), x[1] = __uint_as_float(r.v.x & 0xFFFF0000u);
  x[2] = __uint_as_float(r.v.y << 16), x[3] = __uint_as_float(r.v.y & 0xFFFF0000u);
}

// elements [c, c + 4) of one row of dk elements; 0 where the row is not ok
// or the column is past dk.  vec: dk is the padded width and the row is
// aligned, so the four are one vector load.
__device__ __forceinline__ Raw4<float> load4(const float* row, int c, int dk, bool ok, bool vec) {
  Raw4<float> r;
  if (vec) {
    r.v = ok ? *reinterpret_cast<const float4*>(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    r.v.x = ok && c < dk ? row[c] : 0.f;
    r.v.y = ok && c + 1 < dk ? row[c + 1] : 0.f;
    r.v.z = ok && c + 2 < dk ? row[c + 2] : 0.f;
    r.v.w = ok && c + 3 < dk ? row[c + 3] : 0.f;
  }
  return r;
}
__device__ __forceinline__ Raw4<__nv_bfloat16> load4(const __nv_bfloat16* row, int c, int dk,
                                                     bool ok, bool vec) {
  Raw4<__nv_bfloat16> r;
  if (vec) {
    r.v = ok ? *reinterpret_cast<const uint2*>(row + c) : make_uint2(0u, 0u);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(row);
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = ok && c + i < dk ? s[c + i] : 0u;
    r.v = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  return r;
}

// NR rows of a [n_rows, dk] slab held in registers: a thread loads chunks
// idx = threadIdx.x + k BT (row idx / CPR, columns 4 (idx % CPR)); rows
// outside [0, n_rows) are 0.  store() puts them in a shared tile (split
// once for a Split tile, as they are for a Raw one), local row r going to
// row slot(r).
template <typename T, int DK, int NR>
struct Rows {
  static constexpr int CPR = DK / 4, N = NR * CPR / BT;
  static_assert(NR * CPR % BT == 0, "rows must fill the block's chunks");
  Raw4<T> c[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, int r0, int n_rows, int dk,
                                       bool vec) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * BT, r = r0 + idx / CPR;
      const bool ok = r >= 0 && r < n_rows;
      c[k] = load4(src + (size_t)(ok ? r : 0) * dk, 4 * (idx % CPR), dk, ok, vec);
    }
  }
  template <typename Slot>
  __device__ __forceinline__ void store(SplitTile<T, DK> dst, Slot slot) const {
    using C = Cfg<T, DK>;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * BT;
      const int o = slot(idx / CPR) * C::LDF + 4 * (idx % CPR);
      float x[4];
      to4(c[k], x);
      uint4 b4, s4;
      split_tf32<C::EXACT>(x[0], b4.x, s4.x);
      split_tf32<C::EXACT>(x[1], b4.y, s4.y);
      split_tf32<C::EXACT>(x[2], b4.z, s4.z);
      split_tf32<C::EXACT>(x[3], b4.w, s4.w);
      *reinterpret_cast<uint4*>(dst.big + o) = b4;
      if (!C::EXACT) *reinterpret_cast<uint4*>(dst.small + o) = s4;
    }
  }
  __device__ __forceinline__ void store(SplitTile<T, DK> dst) const {
    store(dst, [](int r) { return r; });
  }
  // as they are, into a raw tile (row stride LDR elements)
  template <typename Slot>
  __device__ __forceinline__ void store(RawTile<T, DK> dst, Slot slot) const {
    using C = Cfg<T, DK>;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * BT;
      *reinterpret_cast<decltype(c[k].v)*>(dst.p + slot(idx / CPR) * C::LDR + 4 * (idx % CPR)) =
          c[k].v;
    }
  }
  __device__ __forceinline__ void store(RawTile<T, DK> dst) const {
    store(dst, [](int r) { return r; });
  }
};

// ---------------------------------------------------------------------------
// fragments and products
// ---------------------------------------------------------------------------

// A fragment: rows [r0, r0 + 16) x columns [c0, c0 + 8) of a tile
template <class Tile>
__device__ __forceinline__ void frag_a(const Tile& a, int r0, int c0, int lane, uint32_t (&ab)[4],
                                       uint32_t (&as)[4]) {
  const int r = r0 + (lane >> 2), c = c0 + (lane & 3);
  a.elem(r, c, ab[0], as[0]);
  a.elem(r + 8, c, ab[1], as[1]);
  a.elem(r, c + 4, ab[2], as[2]);
  a.elem(r + 8, c + 4, ab[3], as[3]);
}

// the same in the permuted k order (2t, 2t+1), whose two columns are
// neighbours: one 64-bit load a row and plane (even LD)
template <int LD, bool EX>
__device__ __forceinline__ void frag_a_perm(const Split<LD, EX>& a, int r0, int c0, int lane,
                                            uint32_t (&ab)[4], uint32_t (&as)[4]) {
  static_assert(!EX && LD % 2 == 0, "a split band in f32 words");
  const int o = (r0 + (lane >> 2)) * LD + c0 + 2 * (lane & 3);
  const uint2 b0 = *reinterpret_cast<const uint2*>(a.big + o);
  const uint2 b1 = *reinterpret_cast<const uint2*>(a.big + o + 8 * LD);
  const uint2 s0 = *reinterpret_cast<const uint2*>(a.small + o);
  const uint2 s1 = *reinterpret_cast<const uint2*>(a.small + o + 8 * LD);
  ab[0] = b0.x, ab[1] = b1.x, ab[2] = b0.y, ab[3] = b1.y;
  as[0] = s0.x, as[1] = s1.x, as[2] = s0.y, as[3] = s1.y;
}
template <int LD>
__device__ __forceinline__ void frag_a_perm(const Raw<float, LD, false>& a, int r0, int c0,
                                            int lane, uint32_t (&ab)[4], uint32_t (&as)[4]) {
  static_assert(LD % 2 == 0, "float2 rows");
  const int o = (r0 + (lane >> 2)) * LD + c0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(a.p + o);
  const float2 x1 = *reinterpret_cast<const float2*>(a.p + o + 8 * LD);
  split_tf32<false>(x0.x, ab[0], as[0]);
  split_tf32<false>(x1.x, ab[1], as[1]);
  split_tf32<false>(x0.y, ab[2], as[2]);
  split_tf32<false>(x1.y, ab[3], as[3]);
}

// B fragment of tile^T: n = tile rows [n0, n0 + 8), k = tile columns [k0, k0 + 8)
template <class Tile>
__device__ __forceinline__ void frag_b_t(const Tile& b, int n0, int k0, int lane,
                                         uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const int r = n0 + (lane >> 2), c = k0 + (lane & 3);
  b.elem(r, c, bb[0], bs[0]);
  b.elem(r, c + 4, bb[1], bs[1]);
}

// B fragment of the tile itself: k = tile rows [k0, k0 + 8) in the order
// 2t, 2t+1, n = tile columns [n0, n0 + 8)
template <class Tile>
__device__ __forceinline__ void frag_b_perm(const Tile& b, int k0, int n0, int lane,
                                            uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  const int r = k0 + 2 * (lane & 3), c = n0 + (lane >> 2);
  b.elem(r, c, bb[0], bs[0]);
  b.elem(r + 1, c, bb[1], bs[1]);
}

// c (16 x NN*8) = A rows [r0, r0 + 16) . B rows [n0, n0 + NN*8)^T over DK,
// fresh accumulators
template <int DK, int NN, class A, class B>
__device__ __forceinline__ void qk_product(const A& a, int r0, const B& b, int n0, int lane,
                                           float (&c)[NN][4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DK; k0 += 8) {
    uint32_t ab[4], as[4];
    frag_a(a, r0, k0, lane, ab, as);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t fb[2], fs[2];
      frag_b_t(b, n0 + n * 8, k0, lane, fb, fs);
      mma_3xtf32<A::EXACT, B::EXACT>(c[n], ab, as, fb, fs);
    }
  }
}

// acc (16 x DW columns from d0) += X (16 x NK*8) . B rows [0, NK*8); X is a
// C tile per k tile (P, P^T, dS, dS^T in registers) or rows of a tile (the
// dS band), both in the permuted k order.  The products go into a fresh C
// tile, added to acc in f32.
template <int NK, int DW, class X, class B>
__device__ __forceinline__ void accumulate(const X& x, const B& b, int d0, int lane,
                                           float (&acc)[DW / 8][4]) {
  float part[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ab[4], as[4];
    if constexpr (std::is_array<X>::value) c_as_a(x[kk], ab, as);
    else frag_a_perm(x, 0, kk * 8, lane, ab, as);
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      uint32_t fb[2], fs[2];
      frag_b_perm(b, kk * 8, d0 + n * 8, lane, fb, fs);
      mma_3xtf32<false, B::EXACT>(part[n], ab, as, fb, fs);
    }
  }
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// band (16 x NB*8) = qv rows [r0, r0 + 16) . the positional rows of a ring
// window ^T, over DK, written to a per-warp f32 scratch of row stride SLD;
// each lane's ring row of an n tile is found once, not once a k step
template <int DK, int NB, int SLD, class A, typename T, int LD, bool EX, int W>
__device__ __forceinline__ void band_to_scratch(const A& qv, int r0,
                                                const Ring<Raw<T, LD, EX>, W>& ring, int lane,
                                                float* sc) {
  const int g = lane >> 2, t = lane & 3;
  float c[NB][4];
  const T* row[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
    const int slot = ring.off + n * 8 + g;
    row[n] = ring.tile.p + (slot < W ? slot : slot - W) * LD + t;
  }
#pragma unroll
  for (int k0 = 0; k0 < DK; k0 += 8) {
    uint32_t ab[4], as[4];
    frag_a(qv, r0, k0, lane, ab, as);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      uint32_t fb[2], fs[2];
      split_tf32<EX>(to_f32(row[n][k0]), fb[0], fs[0]);
      split_tf32<EX>(to_f32(row[n][k0 + 4]), fb[1], fs[1]);
      mma_3xtf32<A::EXACT, EX>(c[n], ab, as, fb, fs);
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    sc[g * SLD + n * 8 + 2 * t] = c[n][0];
    sc[g * SLD + n * 8 + 2 * t + 1] = c[n][1];
    sc[(g + 8) * SLD + n * 8 + 2 * t] = c[n][2];
    sc[(g + 8) * SLD + n * 8 + 2 * t + 1] = c[n][3];
  }
}

// s[ii][jj] += band[ii][(15 - ii) + jj] (C layout of s: rows g, g + 8)
template <int NS, int SLD>
__device__ __forceinline__ void add_skewed(const float* sc, int lane, float (&s)[NS][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = g + 8 * (e >> 1), jj = n * 8 + 2 * t + (e & 1);
      s[n][e] += sc[ii * SLD + (15 - ii) + jj];
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
//
// Per key tile: band = qv . P_rows^T into the warp's scratch; S = qu K^T
// plus the band read skewed; masked keys -1e30 (base 2: MASKED2), keys past
// T -inf; the running row max m and the lane's part of the row sum l in base
// 2 (the pre-dropout normaliser); P = 2^(S scale log2(e) - m), dropped by
// the hash; O = O alpha + P V, P V in a fresh C tile.

template <typename T, int DK>
struct FwdSmem {
  using C = Cfg<T, DK>;
  static constexpr int BK = C::BK, W = C::ROWS + BK, NB = (16 + BK) / 8, SLD = 16 + BK + 4;
  static constexpr size_t bytes() {
    return 4 * (2 * C::raw_words(C::ROWS) + 2 * C::words(BK) + C::raw_words(W) + BW * 16 * SLD +
                BK);
  }
};

// work == nullptr (one split): out and lse.  Otherwise split s writes its
// unnormalized output rows (float32 [S][B H T][dk]) and its base-2 (max,
// sum) pairs (float32 [S][B H T][2], after the outputs) for the merge.
template <typename T, int DK>
__global__ void __launch_bounds__(BT)
rel_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ p, const int* __restrict__ kv_valid,
               T* __restrict__ out, float* __restrict__ lse, float* __restrict__ work, int splits,
               int H, int T_len, int dk, float scale, Dropout drop, bool vec) {
  using C = Cfg<T, DK>;
  using S = FwdSmem<T, DK>;
  constexpr int BK = S::BK, NS = BK / 8, W = S::W, SLD = S::SLD;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cur = smem;
  // the block's own rows and the positional ring raw (split as their
  // fragments load), the key tiles split once, so that two blocks fit an SM
  const auto s_qu = carve_raw<T, DK>(cur, C::ROWS), s_qv = carve_raw<T, DK>(cur, C::ROWS);
  const auto s_k = carve<T, DK>(cur, BK), s_v = carve<T, DK>(cur, BK);
  const auto s_p = carve_raw<T, DK>(cur, W);
  float* scratch = reinterpret_cast<float*>(cur);
  int* s_key = reinterpret_cast<int*>(scratch + BW * 16 * SLD);

  const int i0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16;     // the warp's query rows in the tile
  const int d0 = (warp / C::WM) * C::DW;  // the warp's output columns
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * dk;
  const int n_pos = 2 * T_len - 1;
  const T* p_h = p + (size_t)h * n_pos * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const uint32_t cell = dropout_cell(drop.seed, h, b);
  float* sc = scratch + warp * 16 * SLD;
  // the split's keys: tiles [split n / splits, (split + 1) n / splits)
  const int n_tiles = (T_len + BK - 1) / BK;
  const int j_begin = split * n_tiles / splits * BK;
  const int j_end = min(T_len, (split + 1) * n_tiles / splits * BK);
  // positional rows (T-1)-i+j of the first tile start at rb0; the warp's
  // band starts ROWS - 16 - r0 rows above the block's window
  const int rb0 = (T_len - 1) - (i0 + C::ROWS - 1) + j_begin;
  const int band0 = C::ROWS - 16 - r0;

  {
    Rows<T, DK, C::ROWS> a;
    a.load(qu + base, i0, T_len, dk, vec);
    a.store(s_qu);
    a.load(qv + base, i0, T_len, dk, vec);
    a.store(s_qv);
    Rows<T, DK, BK> kv;
    kv.load(k + base, j_begin, T_len, dk, vec);
    kv.store(s_k);
    kv.load(v + base, j_begin, T_len, dk, vec);
    kv.store(s_v);
    Rows<T, DK, W> pr;
    pr.load(p_h, rb0, n_pos, dk, vec);
    pr.store(s_p);
    if (tid < BK) s_key[tid] = key_state(valid_b, j_begin + tid, T_len);
  }
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8: running max, base 2
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  float acc[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int j0 = j_begin; j0 < j_end; j0 += BK) {
    const int off = j0 - j_begin;  // ring offset of this tile's window
    const bool more = j0 + BK < j_end;
    Rows<T, DK, BK> nk, nv, np;
    int nkey = 0;
    if (more) {  // the next tile's rows, into registers while this one multiplies
      nk.load(k + base, j0 + BK, T_len, dk, vec);
      nv.load(v + base, j0 + BK, T_len, dk, vec);
      np.load(p_h, rb0 + off + W, n_pos, dk, vec);
      if (tid < BK) nkey = key_state(valid_b, j0 + BK + tid, T_len);
    }

    band_to_scratch<DK, S::NB, SLD>(s_qv, r0, Ring<RawTile<T, DK>, W>{s_p, (off + band0) % W},
                                    lane, sc);
    __syncwarp();
    float s[NS][4];  // S, then P
    qk_product<DK, NS>(s_qu, r0, s_k, 0, lane, s);
    add_skewed<NS, SLD>(sc, lane, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int2 ks = *reinterpret_cast<const int2*>(s_key + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = (e & 1) ? ks.y : ks.x;
        s[n][e] = st == 2 ? s[n][e] * sl2 : (st == 1 ? MASKED2 : -INFINITY);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = quad_max(mx[half]);  // finite: the tile holds a key < T
      alpha[half] = exp2_approx(m[half] - mx[half]);  // 0 on the first tile
      m[half] = mx[half];
      l[half] *= alpha[half];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2_approx(s[n][e] - m[e >> 1]);
        l[e >> 1] += pe;
        if (drop.threshold != 0u) {
          const int i = i0 + r0 + g + 8 * (e >> 1), j = j0 + n * 8 + 2 * t + (e & 1);
          pe = dropout_keep(cell, i, j, drop.threshold) ? pe * drop.inv_keep : 0.f;
        }
        s[n][e] = pe;
      }
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    accumulate<NS, C::DW>(s, s_v, d0, lane, acc);  // O += P V

    __syncthreads();  // every warp is done with this tile
    if (more) {
      nk.store(s_k);
      nv.store(s_v);
      np.store(s_p, [&](int r) { return (off + W + r) % W; });
      if (tid < BK) s_key[tid] = nkey;
      __syncthreads();
    }
  }

  const size_t rows_all = (size_t)gridDim.z / splits * H * T_len;  // B H T
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + g + 8 * half;
    if (i >= T_len) continue;
    const float l_row = quad_sum(l[half]);
    if (work == nullptr) {
      const float inv_l = 1.f / l_row;
      T* o = out + base + (size_t)i * dk;
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n) {
        const int d = d0 + n * 8 + 2 * t;
        if (d < dk) o[d] = from_f32<T>(acc[n][2 * half] * inv_l);
        if (d + 1 < dk) o[d + 1] = from_f32<T>(acc[n][2 * half + 1] * inv_l);
      }
      if (lse != nullptr && d0 == 0 && t == 0)
        lse[row_base + i] = (m[half] + log2f(l_row)) * LN2;
    } else {
      const size_t row = split * rows_all + row_base + i;
      float* o = work + row * dk;
#pragma unroll
      for (int n = 0; n < C::DW / 8; ++n) {
        const int d = d0 + n * 8 + 2 * t;
        if (d < dk) o[d] = acc[n][2 * half];
        if (d + 1 < dk) o[d + 1] = acc[n][2 * half + 1];
      }
      if (d0 == 0 && t == 0)
        *reinterpret_cast<float2*>(work + splits * rows_all * dk + 2 * row) =
            make_float2(m[half], l_row);
    }
  }
}

// The splits of rel_fwd_kernel merged in their fixed order, one warp a row:
// out = sum_s O_s 2^(m_s - M) / L, L = sum_s l_s 2^(m_s - M), M the largest
// m_s (every split holds a key < T, so every m_s is finite).
template <typename T>
__global__ void __launch_bounds__(BT)
rel_fwd_merge_kernel(const float* __restrict__ work, T* __restrict__ out,
                     float* __restrict__ lse, int splits, size_t rows_all, int dk) {
  const size_t row = (size_t)blockIdx.x * BW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows_all) return;
  const float2* ml = reinterpret_cast<const float2*>(work + splits * rows_all * dk);
  float m_all = -INFINITY, l_all = 0.f;
  for (int s = 0; s < splits; ++s) m_all = fmaxf(m_all, ml[s * rows_all + row].x);
  for (int s = 0; s < splits; ++s) {
    const float2 st = ml[s * rows_all + row];
    l_all += exp2f(st.x - m_all) * st.y;
  }
  const float inv_l = 1.f / l_all;
  for (int d = lane; d < dk; d += 32) {
    float o = 0.f;
    for (int s = 0; s < splits; ++s)
      o += exp2f(ml[s * rows_all + row].x - m_all) * work[(s * rows_all + row) * dk + d];
    out[row * dk + d] = from_f32<T>(o * inv_l);
  }
  if (lse != nullptr && lane == 0) lse[row] = (m_all + log2f(l_all)) * LN2;
}

// ---------------------------------------------------------------------------
// backward: delta_i = dout_i . out_i, one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BT)
rel_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
                 long long rows, int dk) {
  const long long row = (long long)blockIdx.x * BW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * dk;
  const T* g = dout + row * dk;
  float s = 0.f;
  for (int d = lane; d < dk; d += 32) s = fmaf(to_f32(o[d]), to_f32(g[d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// backward, query-major: dqu and dqv
// ---------------------------------------------------------------------------
//
// One block per (tile of ROWS query rows, head, batch row); key tiles of BK
// stream as in the forward.  Per tile: S (qu K^T + the skewed band), dP =
// dO V^T, P = 2^(S scale log2(e) - lse log2(e)), dS = P (keep dP / (1 -
// rate) - delta) scale at valid keys and 0 elsewhere (a masked key's score
// is a constant); dQu += dS K; dS is written skewed into the warp's scratch
// as a [16, 16 + BK] band, and dQv += band(dS) P_rows.  Every tile is kept
// raw and split as its fragments load, so that two blocks fit an SM.

template <typename T, int DK>
struct BwdQSmem {
  using C = Cfg<T, DK>;
  static constexpr int BK = C::BK, W = C::ROWS + BK, NB = (16 + BK) / 8, SLD = 16 + BK + 4;
  static constexpr size_t bytes() {
    return 4 * (3 * C::raw_words(C::ROWS) + 2 * C::raw_words(BK) + C::raw_words(W) +
                BW * 16 * SLD + BK);
  }
};

template <typename T, int DK>
__global__ void __launch_bounds__(BT)
rel_bwd_q_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ p,
                 const int* __restrict__ kv_valid, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dqu, T* __restrict__ dqv, int H, int T_len, int dk, float scale,
                 Dropout drop, bool vec) {
  using C = Cfg<T, DK>;
  using S = BwdQSmem<T, DK>;
  constexpr int BK = S::BK, NS = BK / 8, W = S::W, SLD = S::SLD, NB = S::NB;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cur = smem;
  const auto s_qu = carve_raw<T, DK>(cur, C::ROWS), s_qv = carve_raw<T, DK>(cur, C::ROWS);
  const auto s_do = carve_raw<T, DK>(cur, C::ROWS);
  const auto s_k = carve_raw<T, DK>(cur, BK), s_v = carve_raw<T, DK>(cur, BK);
  const auto s_p = carve_raw<T, DK>(cur, W);
  float* scratch = reinterpret_cast<float*>(cur);
  int* s_key = reinterpret_cast<int*>(scratch + BW * 16 * SLD);

  const int i0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16;
  const int d0 = (warp / C::WM) * C::DW;
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * dk;
  const int n_pos = 2 * T_len - 1;
  const T* p_h = p + (size_t)h * n_pos * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const uint32_t cell = dropout_cell(drop.seed, h, b);
  // the warp's scratch: the S band, then the dS band
  float* sc = scratch + warp * 16 * SLD;
  const Raw<float, SLD, false> x_band{sc};
  const int rb0 = (T_len - 1) - (i0 + C::ROWS - 1);
  const int band0 = C::ROWS - 16 - r0;

  {
    Rows<T, DK, C::ROWS> a;
    a.load(qu + base, i0, T_len, dk, vec);
    a.store(s_qu);
    a.load(qv + base, i0, T_len, dk, vec);
    a.store(s_qv);
    a.load(dout + base, i0, T_len, dk, vec);
    a.store(s_do);
    Rows<T, DK, BK> kv;
    kv.load(k + base, 0, T_len, dk, vec);
    kv.store(s_k);
    kv.load(v + base, 0, T_len, dk, vec);
    kv.store(s_v);
    Rows<T, DK, W> pr;
    pr.load(p_h, rb0, n_pos, dk, vec);
    pr.store(s_p);
    if (tid < BK) s_key[tid] = key_state(valid_b, tid, T_len);
  }
  bool row_ok[2];
  float nl2[2], dlt[2];  // -lse log2(e) and delta of rows g and g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + g + 8 * half;
    row_ok[half] = i < T_len;
    nl2[half] = row_ok[half] ? -lse[row_base + i] * LOG2E : 0.f;
    dlt[half] = row_ok[half] ? delta[row_base + i] : 0.f;
  }
  float acc_u[C::DW / 8][4], acc_p[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_u[n][e] = acc_p[n][e] = 0.f;
  const float sl2 = scale * LOG2E;
  __syncthreads();

  for (int j0 = 0; j0 < T_len; j0 += BK) {
    const bool more = j0 + BK < T_len;
    Rows<T, DK, BK> nk, nv, np;
    int nkey = 0;
    if (more) {
      nk.load(k + base, j0 + BK, T_len, dk, vec);
      nv.load(v + base, j0 + BK, T_len, dk, vec);
      np.load(p_h, rb0 + j0 + W, n_pos, dk, vec);
      if (tid < BK) nkey = key_state(valid_b, j0 + BK + tid, T_len);
    }

    const Ring<RawTile<T, DK>, W> band{s_p, (j0 + band0) % W};  // the warp's positional rows
    band_to_scratch<DK, NB, SLD>(s_qv, r0, band, lane, sc);
    __syncwarp();
    float s[NS][4], dp[NS][4];  // S and dP, then dS in dp
    qk_product<DK, NS>(s_qu, r0, s_k, 0, lane, s);
    add_skewed<NS, SLD>(sc, lane, s);
    qk_product<DK, NS>(s_do, r0, s_v, 0, lane, dp);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int2 ks = *reinterpret_cast<const int2*>(s_key + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok[e >> 1] && ((e & 1) ? ks.y : ks.x) == 2;
        float dpd = dp[n][e];
        if (drop.threshold != 0u) {
          const int i = i0 + r0 + g + 8 * (e >> 1), j = j0 + n * 8 + 2 * t + (e & 1);
          dpd = dropout_keep(cell, i, j, drop.threshold) ? dpd * drop.inv_keep : 0.f;
        }
        const float pr = ok ? exp2_approx(fmaf(s[n][e], sl2, nl2[e >> 1])) : 0.f;
        dp[n][e] = ok ? pr * (dpd - dlt[e >> 1]) * scale : 0.f;
      }
    }
    accumulate<NS, C::DW>(dp, s_k, d0, lane, acc_u);  // dQu += dS K
    __syncwarp();  // the S band is read; the scratch now takes the dS band
    // band(dS)[ii][c] = dS[ii][c - (15 - ii)], 0 outside [15 - ii, 15 - ii + BK)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = g + 8 * (e >> 1), c = (15 - ii) + n * 8 + 2 * t + (e & 1);
        sc[ii * SLD + c] = dp[n][e];
      }
    {
      const int ii = lane >> 1;
#pragma unroll
      for (int z = 8 * (lane & 1); z < 8 * (lane & 1) + 8; ++z)
        sc[ii * SLD + (z < 15 - ii ? z : z + BK)] = 0.f;
    }
    __syncwarp();
    accumulate<NB, C::DW>(x_band, band, d0, lane, acc_p);  // dQv += band(dS) P_rows

    __syncthreads();
    if (more) {
      nk.store(s_k);
      nv.store(s_v);
      np.store(s_p, [&](int r) { return (j0 + W + r) % W; });
      if (tid < BK) s_key[tid] = nkey;
      __syncthreads();
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r0 + g + 8 * half;
    if (i >= T_len) continue;
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n) {
      const int d = d0 + n * 8 + 2 * t;
      const size_t o = base + (size_t)i * dk + d;
      if (d < dk) dqu[o] = from_f32<T>(acc_u[n][2 * half]), dqv[o] = from_f32<T>(acc_p[n][2 * half]);
      if (d + 1 < dk)
        dqu[o + 1] = from_f32<T>(acc_u[n][2 * half + 1]),
        dqv[o + 1] = from_f32<T>(acc_p[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, key-major: dk, dv and the block's dp partial
// ---------------------------------------------------------------------------
//
// One block per (tile of ROWS keys, head, batch row); warp (wm, wd) owns
// keys [16 wm, 16 wm + 16) and output columns [64 wd, ...).  Query tiles of
// BQ = 16 stream from the last to the first, so the positional window
// [rb, rb + W), W = ROWS + BQ, slides up BQ rows a tile (rb = (T-1) -
// (i0+BQ-1) + j0).  Per tile:
//   SB[ii][c]  = qv_ii . p_{rb + c}: the block's band, its (c) columns in
//                n tiles spread over the warps, in a shared f32 tile;
//   S^T        = K Qu^T + SB read skewed (c = (BQ-1-ii) + jj), dP^T = V dO^T;
//   P^T, dS^T  as in the query-major kernel (a masked key's probability is
//                0, or 1/T in a batch row with no valid key; its dS is 0);
//   dV += P^T dO (dropped P), dK += dS^T Qu;
//   X[c][ii]   = dS^T[jj][ii] at c = (BQ-1-ii) + jj (split once; the other
//                entries are 0 for good), and the dp band Y = X Qv: W / 16
//                C tiles of 16 positional rows per warp (a warp owns DK / 4
//                columns), held in registers as a ring; after each tile the
//                lowest BQ rows are complete and go to the block's partial,
//                and the ring shifts.
// The block's partial holds NR = nq BQ + ROWS positional rows from
// rb_first = T - nq BQ + j0, every one written once.

template <typename T, int DK>
struct BwdKvSmem {
  using C = Cfg<T, DK>;
  static constexpr int BQ = C::BQ, W = C::ROWS + BQ, MW = W / 16;
  static constexpr int NSB = (C::ROWS + BQ) / 8;  // band n tiles: columns [0, ROWS + BQ)
  static constexpr int NPB = (NSB + BW - 1) / BW;  // band n tiles per warp, at most
  static constexpr int NPW = DK / 8 / BW;          // dp n tiles per warp
  static constexpr int LDSB = 101;                // (LDSB - 1) = 4 mod 32: skewed reads conflict-free
  static constexpr int LDX = BQ + 4;
  static constexpr size_t bytes() {
    return 4 * (2 * C::raw_words(C::ROWS) + 3 * C::words(BQ) + C::raw_words(W) + BQ * LDSB +
                2 * W * LDX + 2 * BQ);
  }
};

template <typename T, int DK>
__global__ void __launch_bounds__(BT)
rel_bwd_kv_kernel(const T* __restrict__ qu, const T* __restrict__ qv, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ p,
                  const int* __restrict__ kv_valid, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk_out, T* __restrict__ dv_out, float* __restrict__ dp_part,
                  int H, int T_len, int dk, float scale, Dropout drop, bool vec) {
  using C = Cfg<T, DK>;
  using S = BwdKvSmem<T, DK>;
  constexpr int BQ = S::BQ, NS = BQ / 8, W = S::W, MW = S::MW, LDSB = S::LDSB, LDX = S::LDX;
  constexpr int NPW = S::NPW;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* cur = smem;
  // the block's k and v rows and the positional ring raw (split as their
  // fragments load), so that two blocks fit an SM; the query tiles split
  const auto s_k = carve_raw<T, DK>(cur, C::ROWS), s_v = carve_raw<T, DK>(cur, C::ROWS);
  const auto s_qu = carve<T, DK>(cur, BQ), s_qv = carve<T, DK>(cur, BQ);
  const auto s_do = carve<T, DK>(cur, BQ);
  const auto s_p = carve_raw<T, DK>(cur, W);
  float* sb = reinterpret_cast<float*>(cur);
  uint32_t* xb = cur + BQ * LDSB;
  uint32_t* xs = xb + W * LDX;
  const Split<LDX, false> x_band{xb, xs};  // X, split once by its writer
  float* s_lse = reinterpret_cast<float*>(xs + W * LDX);
  float* s_delta = s_lse + BQ;

  const int j0 = blockIdx.x * C::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % C::WM) * 16;     // the warp's keys in the tile
  const int d0 = (warp / C::WM) * C::DW;  // the warp's output columns
  const size_t row_base = ((size_t)b * H + h) * T_len;
  const size_t base = row_base * dk;
  const int n_pos = 2 * T_len - 1;
  const T* p_h = p + (size_t)h * n_pos * dk;
  const int* valid_b = kv_valid + (size_t)b * T_len;
  const uint32_t cell = dropout_cell(drop.seed, h, b);
  const int nq = (T_len + BQ - 1) / BQ;
  const int rb0 = T_len - nq * BQ + j0;  // the first (last query) tile's window
  const int NR = nq * BQ + C::ROWS;
  float* part = dp_part + ((size_t)(b * H + h) * gridDim.x + blockIdx.x) * NR * DK;

  // a batch row with no valid key spreads every query over all T keys
  int any = 0;
  for (int j = tid; j < T_len; j += BT) any |= valid_b[j] != 0;
  const bool none_valid = !__syncthreads_or(any);
  const float p_masked = none_valid ? 1.f / (float)T_len : 0.f;
  int kst[2];  // key state of rows g and g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) kst[half] = key_state(valid_b, j0 + r0 + g + 8 * half, T_len);

  for (int idx = tid; idx < 2 * W * LDX; idx += BT) xb[idx] = 0u;  // X's unused entries stay 0
  {
    Rows<T, DK, C::ROWS> a;
    a.load(k + base, j0, T_len, dk, vec);
    a.store(s_k);
    a.load(v + base, j0, T_len, dk, vec);
    a.store(s_v);
    const int i0 = (nq - 1) * BQ;
    Rows<T, DK, BQ> q;
    q.load(qu + base, i0, T_len, dk, vec);
    q.store(s_qu);
    q.load(qv + base, i0, T_len, dk, vec);
    q.store(s_qv);
    q.load(dout + base, i0, T_len, dk, vec);
    q.store(s_do);
    Rows<T, DK, W> pr;
    pr.load(p_h, rb0, n_pos, dk, vec);
    pr.store(s_p);
    if (tid < BQ) {
      const bool ok = i0 + tid < T_len;
      s_lse[tid] = ok ? lse[row_base + i0 + tid] : 0.f;
      s_delta[tid] = ok ? delta[row_base + i0 + tid] : 0.f;
    }
  }
  float acc_k[C::DW / 8][4], acc_v[C::DW / 8][4];
#pragma unroll
  for (int n = 0; n < C::DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  float ring[MW][NPW][4];  // the dp band: rows [16 m, 16 m + 16) of the window
#pragma unroll
  for (int mm = 0; mm < MW; ++mm)
#pragma unroll
    for (int n = 0; n < NPW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ring[mm][n][e] = 0.f;
  const float sl2 = scale * LOG2E;
  const int c_dp = warp * NPW * 8;  // the warp's dp columns
  __syncthreads();

  for (int tile = 0; tile < nq; ++tile) {
    const int i0 = (nq - 1 - tile) * BQ;
    const int off = tile * BQ;  // ring offset of this window
    const bool more = tile + 1 < nq;
    Rows<T, DK, BQ> nqu, nqv, ndo, np;
    float nlse = 0.f, ndelta = 0.f;
    if (more) {
      const int i1 = i0 - BQ;
      nqu.load(qu + base, i1, T_len, dk, vec);
      nqv.load(qv + base, i1, T_len, dk, vec);
      ndo.load(dout + base, i1, T_len, dk, vec);
      np.load(p_h, rb0 + off + W, n_pos, dk, vec);
      if (tid < BQ) nlse = lse[row_base + i1 + tid], ndelta = delta[row_base + i1 + tid];
    }

    // SB = qv rows of the tile . positional rows [rb, rb + W)^T; warp w takes
    // the band's n tiles w, w + BW, ...
    {
      float c[S::NPB][4];
      const T* row[S::NPB];  // this lane's positional row of each n tile
#pragma unroll
      for (int q = 0; q < S::NPB; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
        row[q] = s_p.p + ((off + (warp + q * BW) * 8 + g) % W) * C::LDR + t;
      }
#pragma unroll
      for (int k0 = 0; k0 < DK; k0 += 8) {
        uint32_t ab[4], as[4];
        frag_a(s_qv, 0, k0, lane, ab, as);
#pragma unroll
        for (int q = 0; q < S::NPB; ++q) {
          if (warp + q * BW < S::NSB) {
            uint32_t fb[2], fs[2];
            split_tf32<C::EXACT>(to_f32(row[q][k0]), fb[0], fs[0]);
            split_tf32<C::EXACT>(to_f32(row[q][k0 + 4]), fb[1], fs[1]);
            mma_3xtf32<C::EXACT, C::EXACT>(c[q], ab, as, fb, fs);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < S::NPB; ++q) {
        const int n = warp + q * BW;
        if (n < S::NSB) {
          sb[g * LDSB + n * 8 + 2 * t] = c[q][0];
          sb[g * LDSB + n * 8 + 2 * t + 1] = c[q][1];
          sb[(g + 8) * LDSB + n * 8 + 2 * t] = c[q][2];
          sb[(g + 8) * LDSB + n * 8 + 2 * t + 1] = c[q][3];
        }
      }
    }
    __syncthreads();

    float st[NS][4], dpt[NS][4];  // S^T and dP^T, then P^T (dropped) and dS^T
    qk_product<DK, NS>(s_k, r0, s_qu, 0, lane, st);
    qk_product<DK, NS>(s_v, r0, s_do, 0, lane, dpt);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = r0 + g + 8 * (e >> 1), ii = n * 8 + 2 * t + (e & 1);
        const int i = i0 + ii, j = j0 + jj;
        const int ks = kst[e >> 1];
        const bool in = i < T_len && ks != 0;
        const float s = st[n][e] + sb[ii * LDSB + (BQ - 1 - ii) + jj];
        float pr = ks == 2 ? exp2_approx(fmaf(s, sl2, -s_lse[ii] * LOG2E)) : p_masked;
        float dpd = dpt[n][e], pd = pr;
        if (drop.threshold != 0u) {
          const bool keep = dropout_keep(cell, i, j, drop.threshold);
          pd = keep ? pr * drop.inv_keep : 0.f;
          dpd = keep ? dpd * drop.inv_keep : 0.f;
        }
        dpt[n][e] = in && ks == 2 ? pr * (dpd - s_delta[ii]) * scale : 0.f;
        st[n][e] = in ? pd : 0.f;
      }
    accumulate<NS, C::DW>(st, s_do, d0, lane, acc_v);   // dV += P^T dO
    accumulate<NS, C::DW>(dpt, s_qu, d0, lane, acc_k);  // dK += dS^T Qu
    if (d0 == 0) {  // X[c][ii] = dS^T[jj][ii], c = (BQ-1-ii) + jj
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = r0 + g + 8 * (e >> 1), ii = n * 8 + 2 * t + (e & 1);
          const int o = ((BQ - 1 - ii) + jj) * LDX + ii;
          split_tf32<false>(dpt[n][e], xb[o], xs[o]);
        }
    }
    __syncthreads();

    // the dp band: ring[mm] += X rows [16 mm, 16 mm + 16) . Qv (the warp's
    // columns), the Qv fragments loaded once for all m tiles
    uint32_t qb[NS][NPW][2], qs[NS][NPW][2];
#pragma unroll
    for (int kk = 0; kk < NS; ++kk)
#pragma unroll
      for (int n = 0; n < NPW; ++n)
        frag_b_perm(s_qv, kk * 8, c_dp + n * 8, lane, qb[kk][n], qs[kk][n]);
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      float y[NPW][4];
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ab[4], as[4];
        frag_a_perm(x_band, 16 * mm, kk * 8, lane, ab, as);
#pragma unroll
        for (int n = 0; n < NPW; ++n) mma_3xtf32<false, C::EXACT>(y[n], ab, as, qb[kk][n], qs[kk][n]);
      }
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ring[mm][n][e] += y[n][e];
    }
    // rows [off, off + 16) of the block's partial are complete (16 = BQ)
    const int last = more ? 1 : MW;
#pragma unroll
    for (int mm = 0; mm < MW; ++mm) {
      if (mm < last) {
#pragma unroll
        for (int n = 0; n < NPW; ++n) {
          float* o = part + (size_t)(off + 16 * mm + g) * DK + c_dp + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(o) = make_float2(ring[mm][n][0], ring[mm][n][1]);
          *reinterpret_cast<float2*>(o + 8 * DK) = make_float2(ring[mm][n][2], ring[mm][n][3]);
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < MW; ++mm)
#pragma unroll
      for (int n = 0; n < NPW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ring[mm][n][e] = mm + 1 < MW ? ring[mm + 1][n][e] : 0.f;

    __syncthreads();
    if (more) {
      nqu.store(s_qu);
      nqv.store(s_qv);
      ndo.store(s_do);
      np.store(s_p, [&](int r) { return (off + W + r) % W; });
      if (tid < BQ) s_lse[tid] = nlse, s_delta[tid] = ndelta;
      __syncthreads();
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + r0 + g + 8 * half;
    if (j >= T_len) continue;
#pragma unroll
    for (int n = 0; n < C::DW / 8; ++n) {
      const int d = d0 + n * 8 + 2 * t;
      const size_t o = base + (size_t)j * dk + d;
      if (d < dk) dk_out[o] = from_f32<T>(acc_k[n][2 * half]), dv_out[o] = from_f32<T>(acc_v[n][2 * half]);
      if (d + 1 < dk)
        dk_out[o + 1] = from_f32<T>(acc_k[n][2 * half + 1]),
        dv_out[o + 1] = from_f32<T>(acc_v[n][2 * half + 1]);
    }
  }
}

// dp[h, r, d] = the sum over the key tiles jb, then the batch rows b, of
// the partials that hold row r (local row r - (T - nq BQ + jb ROWS)), in
// that fixed order; one thread per (head, row, 4 columns).  The batch loop
// is unrolled so that its independent loads are in flight together.
__global__ void __launch_bounds__(BT)
rel_dp_reduce_kernel(const float* __restrict__ dp_part, float* __restrict__ dp, int B, int H,
                     int T_len, int dk, int DK, int ROWS, int BQ) {
  const int n_pos = 2 * T_len - 1, c4 = DK / 4;
  const long long idx = (long long)blockIdx.x * BT + threadIdx.x;
  if (idx >= (long long)H * n_pos * c4) return;
  const int d = (int)(idx % c4) * 4;
  const int r = (int)(idx / c4 % n_pos);
  const int h = (int)(idx / ((long long)c4 * n_pos));
  const int nq = (T_len + BQ - 1) / BQ, nkb = (T_len + ROWS - 1) / ROWS, NR = nq * BQ + ROWS;
  const int first = T_len - nq * BQ;
  const size_t b_stride = (size_t)H * nkb * NR * DK;  // one batch row's partials
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int jb = 0; jb < nkb; ++jb) {
    const int lr = r - (first + jb * ROWS);
    if (lr < 0 || lr >= NR) continue;
    const float* src = dp_part + (((size_t)h * nkb + jb) * NR + lr) * DK + d;
#pragma unroll 8
    for (int b = 0; b < B; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(src + b * b_stride);
      s.x += x.x, s.y += x.y, s.z += x.z, s.w += x.w;
    }
  }
  float* o = dp + ((size_t)h * n_pos + r) * dk + d;
  if (d < dk) o[0] = s.x;
  if (d + 1 < dk) o[1] = s.y;
  if (d + 2 < dk) o[2] = s.z;
  if (d + 3 < dk) o[3] = s.w;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DK>
bool vector_loads(int dk, std::initializer_list<const void*> ptrs) {
  if (dk != DK) return false;
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) != 0) return false;
  return true;
}

// key splits of the forward: as many as keep every block of the grid in one
// wave of resident blocks (B = 1 serving), at most MAX_SPLITS and at most
// one per key tile; a negative value is minus a CUDA error code
constexpr int MAX_SPLITS = 8;

template <typename T, int DK>
int fwd_splits(int B, int H, int T_len) {
  using C = Cfg<T, DK>;
  const size_t smem = FwdSmem<T, DK>::bytes();
  cudaError_t e = allow_smem(rel_fwd_kernel<T, DK>, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rel_fwd_kernel<T, DK>, BT, smem);
  if (e != cudaSuccess) return -(int)e;
  const long blocks = (long)B * H * ((T_len + C::ROWS - 1) / C::ROWS);
  const long n_tiles = (T_len + C::BK - 1) / C::BK;
  long splits = (long)per_sm * sms / (blocks > 0 ? blocks : 1);
  splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
  splits = splits < n_tiles ? splits : n_tiles;
  return (int)(splits > 1 ? splits : 1);
}

template <typename T, int DK>
int launch_fwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const void* kv_valid, void* out, void* lse, void* work, int splits, int B, int H,
               int T_len, int dk, float scale, Dropout drop, cudaStream_t stream) {
  using C = Cfg<T, DK>;
  if (splits < 1 || (splits > 1 && work == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = FwdSmem<T, DK>::bytes();
  cudaError_t e = allow_smem(rel_fwd_kernel<T, DK>, smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = vector_loads<T, DK>(dk, {qu, qv, k, v, p});
  dim3 grid((T_len + C::ROWS - 1) / C::ROWS, H, B * splits);
  rel_fwd_kernel<T, DK><<<grid, BT, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), static_cast<const int*>(kv_valid),
      static_cast<T*>(out), static_cast<float*>(lse),
      splits > 1 ? static_cast<float*>(work) : nullptr, splits, H, T_len, dk, scale, drop, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t rows_all = (size_t)B * H * T_len;
  rel_fwd_merge_kernel<T><<<(unsigned)((rows_all + BW - 1) / BW), BT, 0, stream>>>(
      static_cast<const float*>(work), static_cast<T*>(out), static_cast<float*>(lse), splits,
      rows_all, dk);
  return (int)cudaGetLastError();
}

// float32 words of the backward's dp partials, or -1 past INT_MAX
template <typename T, int DK>
int bwd_workspace(int B, int H, int T_len) {
  using C = Cfg<T, DK>;
  const long long nq = (T_len + C::BQ - 1) / C::BQ, nkb = (T_len + C::ROWS - 1) / C::ROWS;
  const long long words = (long long)B * H * nkb * (nq * C::BQ + C::ROWS) * DK;
  return words <= INT_MAX ? (int)words : -1;
}

template <typename T, int DK>
int launch_bwd(const void* qu, const void* qv, const void* k, const void* v, const void* p,
               const void* kv_valid, const void* out, const void* lse, const void* dout,
               void* delta, void* dqu, void* dqv, void* dk_out, void* dv_out, void* dp,
               void* work, int B, int H, int T_len, int dk, float scale, Dropout drop,
               cudaStream_t stream) {
  using C = Cfg<T, DK>;
  const T* qu_ = static_cast<const T*>(qu);
  const T* qv_ = static_cast<const T*>(qv);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* p_ = static_cast<const T*>(p);
  const T* dout_ = static_cast<const T*>(dout);
  const int* valid_ = static_cast<const int*>(kv_valid);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  const bool vec = vector_loads<T, DK>(dk, {qu, qv, k, v, p, dout});

  const long long rows = (long long)B * H * T_len;
  rel_delta_kernel<T><<<(unsigned)((rows + BW - 1) / BW), BT, 0, stream>>>(
      static_cast<const T*>(out), dout_, delta_, rows, dk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = BwdKvSmem<T, DK>::bytes();
  e = allow_smem(rel_bwd_kv_kernel<T, DK>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_kv((T_len + C::ROWS - 1) / C::ROWS, H, B);
  rel_bwd_kv_kernel<T, DK><<<grid_kv, BT, smem_kv, stream>>>(
      qu_, qv_, k_, v_, p_, valid_, dout_, lse_, delta_, static_cast<T*>(dk_out),
      static_cast<T*>(dv_out), static_cast<float*>(work), H, T_len, dk, scale, drop, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_q = BwdQSmem<T, DK>::bytes();
  e = allow_smem(rel_bwd_q_kernel<T, DK>, smem_q);
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q((T_len + C::ROWS - 1) / C::ROWS, H, B);
  rel_bwd_q_kernel<T, DK><<<grid_q, BT, smem_q, stream>>>(
      qu_, qv_, k_, v_, p_, valid_, dout_, lse_, delta_, static_cast<T*>(dqu),
      static_cast<T*>(dqv), H, T_len, dk, scale, drop, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long n_dp = (long long)H * (2 * T_len - 1) * (DK / 4);
  rel_dp_reduce_kernel<<<(unsigned)((n_dp + BT - 1) / BT), BT, 0, stream>>>(
      static_cast<const float*>(work), static_cast<float*>(dp), B, H, T_len, dk, DK, C::ROWS,
      C::BQ);
  return (int)cudaGetLastError();
}

Dropout make_dropout(int seed, unsigned int threshold, float inv_keep) {
  Dropout d;
  d.seed = (uint32_t)seed;
  d.threshold = (uint32_t)threshold;
  d.inv_keep = inv_keep;
  return d;
}

}  // namespace

// One dispatch over (dtype, padded head dim) for each entry point: dtype 0
// = float32, 1 = bfloat16; dk <= 32, 64 or 128 (padded with zero columns);
// anything else is refused.
#define REL_DISPATCH(LAUNCH, ...)                                     \
  if (dk >= 1 && dtype == 0) {                                        \
    if (dk <= 32) return LAUNCH<float, 32>(__VA_ARGS__);              \
    if (dk <= 64) return LAUNCH<float, 64>(__VA_ARGS__);              \
    if (dk <= 128) return LAUNCH<float, 128>(__VA_ARGS__);            \
  } else if (dk >= 1 && dtype == 1) {                                 \
    if (dk <= 32) return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);      \
    if (dk <= 64) return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);      \
    if (dk <= 128) return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);    \
  }

extern "C" {

// The number of key splits rel_attention_fwd takes for this shape on the
// current device (>= 1), or minus a CUDA error code.
int rel_attention_fwd_splits(int B, int H, int T_len, int dk, int dtype) {
  REL_DISPATCH(fwd_splits, B, H, T_len)
  return -(int)cudaErrorInvalidValue;
}

// The float32 words of rel_attention_bwd's workspace (the dp partials), or
// -1 for a shape the kernel does not take.
int rel_attention_bwd_workspace(int B, int H, int T_len, int dk, int dtype) {
  REL_DISPATCH(bwd_workspace, B, H, T_len)
  return -1;
}

// qu, qv, k, v, out: [B, H, T, dk]; p: [H, 2T-1, dk]; kv_valid: int32 [B, T];
// lse: float32 [B, H, T] or null (not written); work: float32 [splits, B, H,
// T, dk + 2] when splits > 1 (else unused; may be null).  dtype: 0 =
// float32, 1 = bfloat16 (all float operands share it).  Dropout keeps a
// probability when its hash is >= threshold (= uint32(rate * 2^32); 0 keeps
// all) and scales the kept ones by inv_keep.
int rel_attention_fwd(const void* qu, const void* qv, const void* k, const void* v,
                      const void* p, const void* kv_valid, void* out, void* lse, void* work,
                      int splits, int B, int H, int T_len, int dk, float scale, int seed,
                      unsigned int threshold, float inv_keep, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
  REL_DISPATCH(launch_fwd, qu, qv, k, v, p, kv_valid, out, lse, work, splits, B, H, T_len, dk,
               scale, drop, s)
  return (int)cudaErrorInvalidValue;
}

// The backward of rel_attention_fwd: four kernels on one stream (delta,
// key-major, query-major, dp reduction).  out, dout, dqu, dqv, dk_out,
// dv_out: [B, H, T, dk] in dtype; lse, delta (scratch): float32 [B, H, T];
// dp: float32 [H, 2T-1, dk], summed over the batch (every element written);
// work: float32 scratch of rel_attention_bwd_workspace words.
int rel_attention_bwd(const void* qu, const void* qv, const void* k, const void* v,
                      const void* p, const void* kv_valid, const void* out, const void* lse,
                      const void* dout, void* delta, void* dqu, void* dqv, void* dk_out,
                      void* dv_out, void* dp, void* work, int B, int H, int T_len, int dk,
                      float scale, int seed, unsigned int threshold, float inv_keep, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop = make_dropout(seed, threshold, inv_keep);
  REL_DISPATCH(launch_bwd, qu, qv, k, v, p, kv_valid, out, lse, dout, delta, dqu, dqv, dk_out,
               dv_out, dp, work, B, H, T_len, dk, scale, drop, s)
  return (int)cudaErrorInvalidValue;
}

const char* rel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
