// Flash attention backward for Hopper on the tensor cores: dQ, dK and dV of
// the forward in flash_attention.cu from q, k, v, the forward's output o,
// the output's gradient dO and the forward's per-row log-sum-exp, fp32 or
// bf16 in (fp32 sums), the inputs' type out.
//
// The gradient of the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention), which has no custom_vjp: the JAX model trains through
// XLA's attention under jax.value_and_grad. The port's forward runs its
// kernel on the card, so its gradient is this kernel. Same masks as the
// forward: causal or not, the one-sided window q - k < window, query row i
// at absolute position i + q_offset, keys at or beyond sk_valid masked,
// query head h reading KV head h / (Hq / Hkv). A row with no valid key had
// output 0 and gets gradient 0 (its log-sum-exp is -inf; every P of it is
// masked to 0 before any use, so no inf or NaN reaches a product).
//
// With P = exp(scale S - lse) recomputed from S = Q K^T and the stored lse:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),  Delta = rowsum(dO o),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// What bounds it on an H100: at qwen2-0.5b's training shape (14/2 heads of
// 64, B = 8, S = 512, causal) in bf16, bytes (q, k, v, o, dO read once and
// dQ, dK, dV written once: 33.8 MB, 0.0101 ms) just above the five
// products' 9.4 GFLOP at the bf16 peak (0.0095 ms); in fp32 (3xTF32),
// operations. In practice the latency of each tile's chain (products, 4,096
// exps on the multi-function units, staging) with two warpgroups an SM.
// What the design does about it:
// * Every product runs on the tensor cores through wgmma (sm_90a): bf16 as
//   m64nNk16 with fp32 accumulators, fp32 as 3xTF32 (each operand split
//   into its TF32 rounding hi and the rest lo, hi*hi + hi*lo + lo*hi), as
//   the forward does. Every instance but fp32 at head_dim 128 (below)
//   issues wgmma, in the kernels bwd_dq_wgmma and bwd_dkdv_wgmma.
// * S and dP (S^T and dP^T in the key pass) are mma_ss on tiles that are
//   K-major as they lie (D contiguous), S committed first so that P's exps
//   run while dP is on the tensor cores. P and dS go from the accumulator
//   registers straight into the A operand of the next product (mma_rs /
//   mma_rs_tb), so no score tile touches shared memory. bf16 P and dS are
//   rounded to bf16 once: each gradient sums at most Sk or Sq such terms of
//   random sign, ~2^-9 of its scale, inside the tolerance's 2^-8 of the
//   largest gradient (the forward splits P into a high and a low part for
//   its 1e-5 absolute tolerance; the backward needs no split). fp32 feeds
//   them as TF32 hi and lo parts. The B operand that a product reads along
//   the tile's rows (K in dQ += dS K; Q and dO in dK += dS^T Q and dV +=
//   P^T dO) is the same shared tile read N-major in bf16; TF32 wgmma takes
//   K-major B only, so fp32 also stores it transposed, the rows of each
//   group of 8 in the order 0 2 4 6 1 3 5 7 of the TF32 A fragment's
//   columns, as the forward stores V. In fp32 the key pass adds each
//   tile's dK and dV products to its sums in fp32 registers: summed on the
//   tensor cores across ~56 tiles, dV drifted past the fp32 tolerance.
// * Two passes and no atomics, so the gradient is the same bits on every
//   run (a restarted training run is bit-identical). bwd_delta first writes
//   Delta for every row. The dQ pass owns 64 packed rows of one KV head's
//   group (row r = position r / g, head r % g, the forward's packing) and
//   walks the key tiles they see: 3 products a tile. The dK/dV pass owns
//   one key tile of one KV head and walks the packed query rows of the g
//   heads that see it, in a fixed order: 4 products a tile, and dK and dV
//   of the KV head sum in registers, with no per-head partials and no
//   third pass. So S and dP are computed twice, seven products where the
//   bound counts five; one pass would need per-key-tile dQ partials, ~66 MB
//   of fp32 written and read at the training shape.
// * The two passes run at once, dK/dV on the caller's stream and dQ on a
//   second one: the key pass has one block per (key tile, KV head, batch),
//   128 at the training shape, and under the causal mask the first key
//   tile sees 8x the rows of the last, so most of its blocks finish early
//   and dQ's blocks take their multiprocessors. Both grids run the tiles
//   with the most work first across all (batch, KV head); in the key pass
//   two warpgroups split a block's query tiles (every other one, the same
//   trip count, a padding tile of no rows where the count is odd) and add
//   their dK and dV in shared memory in warpgroup order. fp32 at head_dim
//   64 has one warpgroup: Q, dO and their transposes in two parts take
//   133,120 bytes a warpgroup beside K and V's 65,536.
// * The next tile (K and V in the dQ pass, Q and dO with their rows' lse
//   and Delta in the key pass) is loaded into registers while this one is
//   multiplied, and stored (split in fp32) once the products have read the
//   last; fp32 at head_dim 64 and bf16 at 128 have no room in registers for
//   it and copy each tile after its products (fp32 64's key pass spills a
//   little).
// * head_dim 128 (codeqwen1.5-7b, internvl2-76b, deepseek-67b,
//   llama4-scout). bf16: a warpgroup's dK and dV of its 64 keys at 64 x 128
//   fp32 would take 128 registers a thread beside S, dP and the P and dS
//   fragments, past 255; so the key pass splits D, not the query tiles,
//   across its two warpgroups: both walk every query tile of the block,
//   staged once by all 256 threads, both form S^T and dP^T over the whole
//   D (the same products twice), and warpgroup w adds columns 64 w.. of dV
//   and dK (64 registers a thread for the two), read from the Q and dO
//   tiles by a descriptor offset; no merge. The dQ pass keeps one
//   warpgroup and its 64 x 128 accumulator. fp32: the 3xTF32 tiles do not
//   fit (the key pass's K, V, Q and dO in two parts alone are 262,144
//   bytes, past a block's 232,448), so fp32 at 128 runs bwd_dkdv_simt and
//   bwd_dq_simt on the CUDA cores: every tile held once in fp32, its rows
//   padded to 129 floats, the same masks, exps and fixed order of sums.
// * Masks only in tiles cut by the diagonal, the window's edge, sk_valid
//   or the last row; P with ex2.approx on scores pre-scaled by log2 e, as
//   the forward computes it.
//
// Layout: q, o, dO, dQ (B, Sq, Hq, D); k, v, dK, dV (B, Sk, Hkv, D), read
// and written through element strides for the batch, sequence and head
// axes (the last axis contiguous, rows 16-byte aligned); lse and the Delta
// scratch (B, Hq, Sq) fp32 contiguous. Grids are 1-D: (tile, KV head,
// batch) with the tile slowest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;  // packed query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

struct Str {
  long long b, s, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Str sq_, sk_, sv_, so_, sdo_, sdq_, sdk_, sdv_;
  int B, Sq, Sk, Hq, Hkv, g, rows;  // rows: packed query rows Sq * g
  int causal, window, q_offset, sk_valid;
  float scale;
};

// fp32 runs 3xTF32 (hi and lo parts in shared memory), bf16 one product.
template <typename T>
struct Op {
  using type = TF32;
  static constexpr int parts = 2;
};
template <>
struct Op<__nv_bfloat16> {
  using type = BF16;
  static constexpr int parts = 1;
};

template <typename T, int D>
struct Tile {
  static constexpr int E = 16 / sizeof(T);       // elements per 16-byte chunk
  static constexpr int CPR = D / E;              // chunks per row
  static constexpr int NL = CPR / 2;             // chunks of a 64-row tile
                                                 // per thread of 128
  static constexpr int parts = Op<T>::parts;
  static constexpr bool F32 = parts == 2;
  static constexpr int QB = 64 * D * sizeof(T);  // one part of 64 rows
  static constexpr int LBO_T = D * 16 + 16;      // transposed: a row chunk,
                                                 // padded against conflicts
  static constexpr int TB = 64 / 4 * LBO_T;      // one part, transposed
  static constexpr int KS = D * sizeof(T) / 32;  // k-steps over D
  static constexpr int KR = 64 * sizeof(T) / 32; // k-steps over 64 rows
  // Whether a tile's next chunks wait in registers while this one is
  // multiplied: not for fp32 at head_dim 64 (64 registers a thread beside
  // the accumulators and the TF32 fragments) nor at 128 (the dQ pass's
  // 64-register accumulator). Else NR chunks at a time.
  static constexpr bool PREFETCH = !(F32 && D == 64) && D < 128;
  static constexpr int NR = PREFETCH || NL < 4 ? NL : 4;
  static_assert(CPR >= 2, "two threads a row");
};

__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? __ldg(static_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// Chunk c of row r of a [chunk][64 rows][16 B] tile; fp32 is split into its
// TF32 parts, the low one ``part`` bytes after the high one.
template <typename T>
__device__ __forceinline__ void store_chunk(uint8_t* base, int part, uint4 x,
                                            int c, int r) {
  const int off = chunk_offset(c, r, 64);
  if constexpr (Op<T>::parts == 2) {
    uint4 lo;
    *reinterpret_cast<uint4*>(base + off) = split4(x, lo);
    *reinterpret_cast<uint4*>(base + part + off) = lo;
  } else {
    *reinterpret_cast<uint4*>(base + off) = x;
  }
}

// fp32: chunk c of row r (tile-local) stored transposed, a D x 64 tile
// K-major along the 64 rows, in chunks of 4 rows LBO_T bytes apart, the rows
// of each group of 8 in the order 0 2 4 6 1 3 5 7; the low part TB on.
template <int D>
__device__ __forceinline__ void store_t(uint8_t* base, uint4 x, int c,
                                        int r) {
  using L = Tile<float, D>;
  const int d0 = c * 4;
  const int rp = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
  const int off = (rp >> 2) * L::LBO_T + (rp & 3) * 4;
  const float v[4] = {__uint_as_float(x.x), __uint_as_float(x.y),
                      __uint_as_float(x.z), __uint_as_float(x.w)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, lo;
    split(v[e], hi, lo);
    *reinterpret_cast<float*>(base + off + (d0 + e) * 16) = hi;
    *reinterpret_cast<float*>(base + L::TB + off + (d0 + e) * 16) = lo;
  }
}

// Dot product of two 16-byte vectors: 4 fp32 or 8 bf16 lanes (a bf16 value
// is the top half of an fp32 with the same bits).
__device__ __forceinline__ float dot16(uint4 x, uint4 y, float) {
  float s = __uint_as_float(x.x) * __uint_as_float(y.x);
  s = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), s);
  s = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), s);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), s);
}
__device__ __forceinline__ float dot_bf16x2(uint32_t x, uint32_t y, float s) {
  s = fmaf(__uint_as_float(x << 16), __uint_as_float(y << 16), s);
  return fmaf(__uint_as_float(x & 0xffff0000u),
              __uint_as_float(y & 0xffff0000u), s);
}
__device__ __forceinline__ float dot16(uint4 x, uint4 y, __nv_bfloat16) {
  float s = dot_bf16x2(x.x, y.x, 0.f);
  s = dot_bf16x2(x.y, y.y, s);
  s = dot_bf16x2(x.z, y.z, s);
  return dot_bf16x2(x.w, y.w, s);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ bool visible(const Args& a, int pos, int key) {
  return key < a.sk_valid && (!a.causal || key <= pos) &&
         (a.window <= 0 || pos - key < a.window);
}

// Barrier of one warpgroup's 128 threads (ids 1 + warpgroup; 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// A 64 x 64 accumulator (x[4 i + {0, 1}]: row ra, columns 8 i + 2 t + {0,
// 1}; x[4 i + {2, 3}]: row ra + 8) as the A operand of a product over its
// columns: bf16, k-steps of 16 columns; TF32, k-steps of 8 as a high and a
// low part, columns 2 t and 2 t + 1 as the fragment's t and t + 4.
template <typename T>
__device__ __forceinline__ void fragments(const float (&x)[32],
                                          uint32_t (&hi)[Tile<T, 16>::KR][4],
                                          uint32_t (&lo)[Tile<T, 16>::KR][4]) {
  constexpr int KR = Tile<T, 16>::KR;
#pragma unroll
  for (int ks = 0; ks < KR; ++ks) {
    if constexpr (Op<T>::parts == 2) {
      const float p4[4] = {x[4 * ks], x[4 * ks + 2], x[4 * ks + 1],
                           x[4 * ks + 3]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float h, l;
        split(p4[r], h, l);
        hi[ks][r] = __float_as_uint(h);
        lo[ks][r] = __float_as_uint(l);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // r = 0: row ra, columns 16 ks + 2 t, + 1; 1: row ra + 8; 2, 3:
        // the same 8 columns on
        const int i = 8 * ks + (r >> 1) * 4 + (r & 1) * 2;
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[i], x[i + 1]);
        hi[ks][r] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  }
}

// acc (64 x D) += A (64 x 64, fragments) B, B the 64 x D tile at ``bt``:
// bf16 the tile as it lies read N-major, fp32 its transposed copy in two
// parts (3xTF32).
template <typename T, int D>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 2],
                                         const uint32_t (&hi)[Tile<T, D>::KR][4],
                                         const uint32_t (&lo)[Tile<T, D>::KR][4],
                                         uint64_t bt) {
  using L = Tile<T, D>;
  using OT = typename Op<T>::type;
#pragma unroll
  for (int ks = 0; ks < L::KR; ++ks) {
    if constexpr (L::F32) {
      const int off = ks * 2 * L::LBO_T;
      mma_rs<OT, D>(acc, hi[ks], desc_at(bt, off), 1);
      mma_rs<OT, D>(acc, hi[ks], desc_at(bt, L::TB + off), 1);
      mma_rs<OT, D>(acc, lo[ks], desc_at(bt, off), 1);
    } else {
      mma_rs_tb<OT, D>(acc, hi[ks], desc_at(bt, ks * 2 * 128), 1);
    }
  }
}

// acc (64 x 64) += A B^T over D, both [chunk][64 rows][16 B] tiles at ``at``
// and ``bt`` (3xTF32 in fp32: the low parts QB on).
template <typename T, int D>
__device__ __forceinline__ void mma_d(float (&acc)[32], uint64_t at,
                                      uint64_t bt) {
  using L = Tile<T, D>;
  using OT = typename Op<T>::type;
#pragma unroll
  for (int ks = 0; ks < L::KS; ++ks) {
    const int off = ks * 2 * 64 * 16;  // two chunks of 64 rows
    mma_ss<OT, 64>(acc, desc_at(at, off), desc_at(bt, off), 1);
    if constexpr (L::F32) {
      mma_ss<OT, 64>(acc, desc_at(at, off), desc_at(bt, L::QB + off), 1);
      mma_ss<OT, 64>(acc, desc_at(at, L::QB + off), desc_at(bt, off), 1);
    }
  }
}

// Delta = rowsum(dO o) of every query row (B, Sq, Hq) into the (B, Hq, Sq)
// scratch: CPR lanes a row, one 16-byte chunk each of o and dO, summed in a
// fixed tree.
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_delta(Args a) {
  using L = Tile<T, D>;
  constexpr int E = L::E, CPR = L::CPR, RPW = 32 / CPR;  // rows a warp
  const long long n = static_cast<long long>(a.B) * a.Sq * a.Hq;
  const int lane = threadIdx.x & 31, sub = lane % CPR;
  const long long warps = static_cast<long long>(gridDim.x) * 8;
  for (long long w = blockIdx.x * 8LL + (threadIdx.x >> 5); w * RPW < n;
       w += warps) {
    const long long r = w * RPW + lane / CPR;
    const bool ok = r < n;
    const int h = static_cast<int>(r % a.Hq);
    const long long bs = r / a.Hq;
    const int pos = static_cast<int>(bs % a.Sq), b = static_cast<int>(bs / a.Sq);
    const T* op = static_cast<const T*>(a.o) + b * a.so_.b + pos * a.so_.s +
                  h * a.so_.h + sub * E;
    const T* dp = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                  pos * a.sdo_.s + h * a.sdo_.h + sub * E;
    float x = dot16(load16(dp, ok), load16(op, ok), T());
#pragma unroll
    for (int m = CPR / 2; m > 0; m >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, m);
    if (ok && sub == 0)
      a.delta[(static_cast<long long>(b) * a.Hq + h) * a.Sq + pos] = x;
  }
}

// Shared memory of the dQ pass: Q, dO, K and V tiles (each in its parts),
// in fp32 K^T, then each row's lse (base 2) and Delta.
template <typename T, int D>
struct DQ {
  using L = Tile<T, D>;
  static constexpr int TILE = L::parts * L::QB;
  static constexpr int AUX = 4 * TILE + (L::F32 ? L::parts * L::TB : 0);
  static constexpr size_t smem = AUX + (64 + 64) * 4;
  static_assert(smem <= 232448, "a block's shared memory on an H100");
};

// dQ pass. Grid (packed row tiles x Hkv x B), one warpgroup: a block owns
// 64 packed rows of one KV head's group and walks the key tiles they see.
// The grid runs every (batch, KV head)'s last row tiles (under the causal
// mask the longest key ranges) first.
template <typename T, int D>
__global__ void __launch_bounds__(128) bwd_dq_wgmma(Args a) {
  using L = Tile<T, D>;
  using Z = DQ<T, D>;
  constexpr int E = L::E;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* dOs = smem + Z::TILE;
  uint8_t* KVs = smem + 2 * Z::TILE;  // K, V (, K^T)
  float* lse_s = reinterpret_cast<float*>(smem + Z::AUX);
  float* dl_s = lse_s + 64;

  const int heads = a.Hkv * a.B, hb = blockIdx.x % heads;
  const int tile = (a.rows + BM - 1) / BM - 1 - blockIdx.x / heads;
  const int hk = hb % a.Hkv, b = hb / a.Hkv, g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = tile * BM;
  const int pos_lo = r0 / g + a.q_offset;
  const int pos_hi = (min(r0 + BM, a.rows) - 1) / g + a.q_offset;
  const int k_end = a.causal ? min(a.sk_valid, pos_hi + 1) : a.sk_valid;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  // This thread stages key (and row) lr of each tile, chunks c0, c0 + 2, ...
  const int lr = tid & 63, c0 = tid >> 6;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk_.b + hk * a.sk_.h +
                lr * a.sk_.s + c0 * E;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_.b + hk * a.sv_.h +
                lr * a.sv_.s + c0 * E;
  // through registers, fp32 split into TF32 parts and K also transposed
  uint4 kx[L::NR], vx[L::NR];
  auto load_kv = [&](int kt, int i0) {
    const bool ok = kt + lr < k_end;
#pragma unroll
    for (int i = 0; i < L::NR; ++i) {
      kx[i] = load16(kb + kt * a.sk_.s + 2 * (i0 + i) * E, ok);
      vx[i] = load16(vb + kt * a.sv_.s + 2 * (i0 + i) * E, ok);
    }
  };
  auto store_kv = [&](int i0) {
#pragma unroll
    for (int i = 0; i < L::NR; ++i) {
      const int c = c0 + 2 * (i0 + i);
      store_chunk<T>(KVs, L::QB, kx[i], c, lr);
      store_chunk<T>(KVs + Z::TILE, L::QB, vx[i], c, lr);
      if constexpr (L::F32) store_t<D>(KVs + 2 * Z::TILE, kx[i], c, lr);
    }
  };
  auto stage_kv = [&](int kt) {
#pragma unroll
    for (int i0 = 0; i0 < L::NL; i0 += L::NR) {
      if (!L::PREFETCH || i0 > 0) load_kv(kt, i0);
      store_kv(i0);
    }
  };
  // the first K/V tile's loads in flight beside Q's and dO's
  if (L::PREFETCH && ntiles > 0) load_kv(k_begin, 0);
  {
    const int pr = r0 + lr;
    const bool ok = pr < a.rows;
    const long long pos = pr / g, head = hk * g + pr % g;
    const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + pos * a.sq_.s +
                  head * a.sq_.h + c0 * E;
    const T* dp = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                  pos * a.sdo_.s + head * a.sdo_.h + c0 * E;
    uint4 qx[L::NL], dx[L::NL];
#pragma unroll
    for (int i = 0; i < L::NL; ++i) {
      qx[i] = load16(qp + 2 * i * E, ok);
      dx[i] = load16(dp + 2 * i * E, ok);
    }
    if (c0 == 0) {
      // the row's lse in base 2 (+inf past the end: p = 0) and Delta
      const long long idx = (static_cast<long long>(b) * a.Hq + head) * a.Sq + pos;
      lse_s[lr] = ok ? a.lse[idx] * LOG2E : INFINITY;
      dl_s[lr] = ok ? a.delta[idx] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < L::NL; ++i) {
      store_chunk<T>(Qs, L::QB, qx[i], c0 + 2 * i, lr);
      store_chunk<T>(dOs, L::QB, dx[i], c0 + 2 * i, lr);
    }
  }
  if (ntiles > 0) stage_kv(k_begin);
  fence_smem_to_async();
  __syncthreads();

  // this thread's rows of the accumulators: ra and ra + 8
  const int ra = 16 * warp + (lane >> 2), t = lane & 3;
  const int pos_a = (r0 + ra) / g + a.q_offset;
  const int pos_b = (r0 + ra + 8) / g + a.q_offset;
  const float l2a = lse_s[ra], l2b = lse_s[ra + 8];
  const float dla = dl_s[ra], dlb = dl_s[ra + 8];
  const float sl2 = a.scale * LOG2E;
  const uint64_t dq = desc(Qs, 64 * 16), ddo = desc(dOs, 64 * 16);
  const uint64_t dk = desc(KVs, 64 * 16), dv = desc(KVs + Z::TILE, 64 * 16);
  // K as the B operand of dS K: bf16 N-major as it lies, fp32 K^T
  const uint64_t dkn = L::F32 ? desc(KVs + 2 * Z::TILE, L::LBO_T)
                              : desc(KVs, 128, 64 * 16);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int kt = k_begin + j * BN;
    const bool more = j + 1 < ntiles;
    if (L::PREFETCH && more) load_kv(kt + BN, 0);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin<32>(s);
    pin<32>(dp);
    fence();
    mma_d<T, D>(s, dq, dk);
    commit();
    mma_d<T, D>(dp, ddo, dv);
    commit();
    wait<1>();  // S; dP still on the tensor cores
    pin<32>(s);

    // P, masked where the tile is not wholly visible
    const bool full = (!a.causal || kt + BN - 1 <= pos_lo) &&
                      kt + BN <= a.sk_valid &&
                      (a.window <= 0 || pos_hi - kt < a.window);
    auto probs = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          const int key = kt + 8 * i + 2 * t + j2;
          const int ia = 4 * i + j2, ib = ia + 2;
          s[ia] = ex2(fmaf(s[ia], sl2, -l2a));
          s[ib] = ex2(fmaf(s[ib], sl2, -l2b));
          if (decltype(masked)::value) {
            if (!visible(a, pos_a, key)) s[ia] = 0.f;
            if (!visible(a, pos_b, key)) s[ib] = 0.f;
          }
        }
      }
    };
    if (full)
      probs(std::false_type());
    else
      probs(std::true_type());
    wait<0>();
    pin<32>(dp);
    // dS = P (dP - Delta)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - ((i & 2) ? dlb : dla);
    uint32_t fh[L::KR][4], fl[L::KR][4];
    fragments<T>(s, fh, fl);
    pin<D / 2>(acc);
    fence();
    mma_rows<T, D>(acc, fh, fl, dkn);
    commit();
    wait<0>();
    pin<D / 2>(acc);
    pin<L::KR>(fh);
    if constexpr (L::F32) pin<L::KR>(fl);

    if (more) {
      __syncthreads();  // the products have read this tile
      stage_kv(kt + BN);
      fence_smem_to_async();
      __syncthreads();
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = r0 + ra + 8 * half;
    if (pr >= a.rows) continue;
    T* p = static_cast<T*>(a.dq) + b * a.sdq_.b + (pr / g) * a.sdq_.s +
           (hk * g + pr % g) * a.sdq_.h;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store_pair(p + 8 * i + 2 * t, acc[4 * i + 2 * half] * a.scale,
                 acc[4 * i + 2 * half + 1] * a.scale);
  }
}

// Shared memory of the dK/dV pass: K and V (each in its parts), then each
// warpgroup's region (SPLIT_D: one region the warpgroups share): Q and dO
// tiles, in fp32 their transposes, and each row's lse (base 2) and Delta
// side by side; at the end the warpgroups' dK and dV meet in the
// warpgroups' regions (not SPLIT_D: each writes its own columns).
template <typename T, int D>
struct KV {
  using L = Tile<T, D>;
  static constexpr bool SPLIT_D = !L::F32 && D == 128;  // warpgroups split D
  static constexpr int W = L::F32 && D == 64 ? 1 : 2;  // warpgroups
  static constexpr int THREADS = 128 * W;
  static constexpr int DW = SPLIT_D ? D / W : D;       // a warpgroup's columns
  static constexpr int STEP = SPLIT_D ? 1 : W;         // tiles a warpgroup skips
  static constexpr int STAGE = SPLIT_D ? THREADS : 128;  // threads staging a tile
  static constexpr int CS = STAGE / 64;                // a thread's chunk step
  static constexpr int NQ = L::CPR / CS;               // chunks a thread stages
  static constexpr int NR = L::PREFETCH || NQ < 4 ? NQ : 4;
  static constexpr int TILE = L::parts * L::QB;
  static constexpr int WO = 2 * TILE;                  // warpgroups' regions
  static constexpr int AUX = 2 * TILE + (L::F32 ? 2 * L::parts * L::TB : 0);
  static constexpr int WB = AUX + 128 * 4;             // a warpgroup's region
  static constexpr int REGIONS = SPLIT_D ? 1 : W;
  static constexpr int MERGE = SPLIT_D ? 0 : (W - 1) * 128 * D * 4;
  static constexpr size_t smem =
      WO + (REGIONS * WB > MERGE ? REGIONS * WB : MERGE);
  static_assert(smem <= 232448, "a block's shared memory on an H100");
  static_assert(L::CPR % CS == 0, "a thread's chunks cover the row");
};

// dK/dV pass. Grid (key tiles x Hkv x B): a block owns 64 keys of one KV
// head and walks the packed query rows of its group that see them, W
// warpgroups taking every W-th tile of 64 rows (SPLIT_D: every tile, each
// warpgroup its DW columns). The grid runs every (batch, KV head)'s first
// key tiles (under the causal mask the most rows) first.
template <typename T, int D>
__global__ void __launch_bounds__(KV<T, D>::THREADS) bwd_dkdv_wgmma(Args a) {
  using L = Tile<T, D>;
  using Z = KV<T, D>;
  constexpr int E = L::E, W = Z::W;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + Z::TILE;
  uint8_t* Ws = smem + Z::WO + (Z::SPLIT_D ? 0 : wg) * Z::WB;

  const int heads = a.Hkv * a.B, hb = blockIdx.x % heads;
  const int kt = blockIdx.x / heads * BN;
  const int hk = hb % a.Hkv, b = hb / a.Hkv, g = a.g;
  // the packed rows that can see a key of the tile
  const int key_last = min(kt + BN, a.sk_valid) - 1;
  int row_begin = 0, row_end = kt < a.sk_valid ? a.rows : 0;
  if (a.causal) row_begin = max(0, kt - a.q_offset) * g;
  if (a.window > 0)
    row_end = min(row_end, max(0, key_last + a.window - a.q_offset) * g);
  const int nt = row_end > row_begin ? (row_end - row_begin + BM - 1) / BM : 0;
  // the same for every warpgroup
  const int niter = (nt + Z::STEP - 1) / Z::STEP;
  const int first = Z::SPLIT_D ? 0 : wg;  // this warpgroup's first tile

  // K and V, every thread a share
  for (int idx = tid; idx < 64 * L::CPR; idx += Z::THREADS) {
    const int r = idx & 63, c = idx >> 6;
    const bool ok = kt + r < a.Sk;
    const uint4 kx = load16(static_cast<const T*>(a.k) + b * a.sk_.b +
                                (kt + r) * a.sk_.s + hk * a.sk_.h + c * E, ok);
    const uint4 vx = load16(static_cast<const T*>(a.v) + b * a.sv_.b +
                                (kt + r) * a.sv_.s + hk * a.sv_.h + c * E, ok);
    store_chunk<T>(Ks, L::QB, kx, c, r);
    store_chunk<T>(Vs, L::QB, vx, c, r);
  }

  // This thread stages row lr of its warpgroup's tiles (SPLIT_D: of the
  // block's), chunks c0, c0 + CS, ... A row is valid for jt < nt and below
  // rows; an invalid one reads nothing (zeros) and is masked.
  const int st = Z::SPLIT_D ? tid : wt, lr = st & 63, c0 = st >> 6;
  // through registers, fp32 split into TF32 parts and also transposed
  uint4 qx[Z::NR], ox[Z::NR];
  float lx = 0.f, dx = 0.f;
  auto load_q = [&](int jt, int i0) {
    const int pr = row_begin + jt * BM + lr;
    const bool ok = jt < nt && pr < a.rows;
    const long long pos = ok ? pr / g : 0, head = ok ? hk * g + pr % g : 0;
    const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + pos * a.sq_.s +
                  head * a.sq_.h + c0 * E;
    const T* op = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                  pos * a.sdo_.s + head * a.sdo_.h + c0 * E;
#pragma unroll
    for (int i = 0; i < Z::NR; ++i) {
      qx[i] = load16(qp + Z::CS * (i0 + i) * E, ok);
      ox[i] = load16(op + Z::CS * (i0 + i) * E, ok);
    }
    if (i0 == 0) {
      const long long idx = (static_cast<long long>(b) * a.Hq + head) * a.Sq + pos;
      lx = ok ? a.lse[idx] * LOG2E : 0.f;
      dx = ok ? a.delta[idx] : 0.f;
    }
  };
  auto store_q = [&](int i0) {
#pragma unroll
    for (int i = 0; i < Z::NR; ++i) {
      const int c = c0 + Z::CS * (i0 + i);
      store_chunk<T>(Ws, L::QB, qx[i], c, lr);
      store_chunk<T>(Ws + Z::TILE, L::QB, ox[i], c, lr);
      if constexpr (L::F32) {
        store_t<D>(Ws + 2 * Z::TILE, qx[i], c, lr);
        store_t<D>(Ws + 2 * Z::TILE + L::parts * L::TB, ox[i], c, lr);
      }
    }
    if (i0 == 0 && c0 == 0)
      *reinterpret_cast<float2*>(Ws + Z::AUX + 8 * lr) = make_float2(lx, dx);
  };
  auto stage_q = [&](int jt) {
#pragma unroll
    for (int i0 = 0; i0 < Z::NQ; i0 += Z::NR) {
      if (!L::PREFETCH || i0 > 0) load_q(jt, i0);
      store_q(i0);
    }
  };
  // the barrier of the threads that share a Q/dO region
  auto region_sync = [&]() {
    if constexpr (Z::SPLIT_D)
      __syncthreads();
    else
      wg_sync(wg);
  };
  if (niter > 0) {
    if (L::PREFETCH) load_q(first, 0);
    stage_q(first);
  }
  fence_smem_to_async();
  __syncthreads();

  // this thread's keys of the accumulators: ra and ra + 8
  const int ra = 16 * warp + (lane >> 2), t = lane & 3;
  const int key_a = kt + ra, key_b = key_a + 8;
  const float sl2 = a.scale * LOG2E;
  const uint64_t dka = desc(Ks, 64 * 16), dva = desc(Vs, 64 * 16);
  const uint64_t dqb = desc(Ws, 64 * 16), ddob = desc(Ws + Z::TILE, 64 * 16);
  // Q and dO as the B operands of dS^T Q and P^T dO
  const uint64_t dqn = L::F32 ? desc(Ws + 2 * Z::TILE, L::LBO_T)
                              : desc(Ws, 128, 64 * 16);
  const uint64_t ddon =
      L::F32 ? desc(Ws + 2 * Z::TILE + L::parts * L::TB, L::LBO_T)
             : desc(Ws + Z::TILE, 128, 64 * 16);
  const float* aux_s = reinterpret_cast<const float*>(Ws + Z::AUX);
  // SPLIT_D: this warpgroup's columns of Q and dO as B operands, DW / 8
  // chunks of 64 rows on
  const int cols = Z::SPLIT_D ? wg * Z::DW : 0;
  const uint64_t dqc = desc_at(dqn, cols * 128);
  const uint64_t ddoc = desc_at(ddon, cols * 128);
  constexpr int DW = Z::DW;
  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < niter; ++it) {
    const int jt = first + Z::STEP * it;
    const bool more = it + 1 < niter;
    if (L::PREFETCH && more) load_q(jt + Z::STEP, 0);

    float s[32], dp[32];  // S^T and dP^T: keys by query rows
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin<32>(s);
    pin<32>(dp);
    fence();
    mma_d<T, D>(s, dka, dqb);
    commit();
    mma_d<T, D>(dp, dva, ddob);
    commit();
    wait<1>();  // S^T; dP^T still on the tensor cores
    pin<32>(s);

    // P^T, masked where the tile is not wholly visible or has invalid
    // rows; column c is row r0 + c of the packed query rows
    const int r0 = row_begin + jt * BM;
    const int pos_lo = r0 / g + a.q_offset;
    const int pos_hi = (r0 + BM - 1) / g + a.q_offset;
    const bool full = jt < nt && r0 + BM <= a.rows &&
                      (!a.causal || kt + BN - 1 <= pos_lo) &&
                      kt + BN <= a.sk_valid &&
                      (a.window <= 0 || pos_hi - kt < a.window);
    float dl[16];
    auto probs = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // lse and Delta of columns 8 i + 2 t and 8 i + 2 t + 1
        const float4 x = *reinterpret_cast<const float4*>(aux_s + 16 * i + 4 * t);
        dl[2 * i] = x.y;
        dl[2 * i + 1] = x.w;
#pragma unroll
        for (int j2 = 0; j2 < 2; ++j2) {
          const int ia = 4 * i + j2, ib = ia + 2;
          const float l2 = j2 ? x.z : x.x;
          s[ia] = ex2(fmaf(s[ia], sl2, -l2));
          s[ib] = ex2(fmaf(s[ib], sl2, -l2));
          if (decltype(masked)::value) {
            const int pr = r0 + 8 * i + 2 * t + j2;
            const bool ok = jt < nt && pr < a.rows;
            const int pos = pr / g + a.q_offset;
            if (!ok || !visible(a, pos, key_a)) s[ia] = 0.f;
            if (!ok || !visible(a, pos, key_b)) s[ib] = 0.f;
          }
        }
      }
    };
    if (full)
      probs(std::false_type());
    else
      probs(std::true_type());
    uint32_t ph[L::KR][4], pl[L::KR][4];
    fragments<T>(s, ph, pl);
    wait<0>();
    pin<32>(dp);
    // dS^T = P^T (dP^T - Delta)
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - dl[(i >> 2) * 2 + (i & 1)]);

    if constexpr (L::F32) {
      // Each tile's products go to a fresh accumulator, added to dV and dK
      // with fp32 rounding: accumulated on the tensor cores across the
      // tiles (dV over 3,584 packed rows at the training shape), the sum
      // drifted past the fp32 tolerance; tile sums added in fp32 stay well
      // inside it.
      float x[DW / 2];
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) x[i] = 0.f;
      pin<DW / 2>(x);
      fence();
      mma_rows<T, DW>(x, ph, pl, ddoc);
      commit();
      wait<0>();
      pin<DW / 2>(x);
      pin<L::KR>(ph);
      pin<L::KR>(pl);
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) {
        dv[i] += x[i];
        x[i] = 0.f;
      }
      fragments<T>(dp, ph, pl);  // the TF32 parts of dS^T
      pin<DW / 2>(x);
      fence();
      mma_rows<T, DW>(x, ph, pl, dqc);
      commit();
      wait<0>();
      pin<DW / 2>(x);
      pin<L::KR>(ph);
      pin<L::KR>(pl);
#pragma unroll
      for (int i = 0; i < DW / 2; ++i) dk[i] += x[i];
    } else {
      pin<DW / 2>(dv);
      fence();
      mma_rows<T, DW>(dv, ph, pl, ddoc);
      commit();
      uint32_t sh[L::KR][4], sl[L::KR][4];
      fragments<T>(dp, sh, sl);
      pin<DW / 2>(dk);
      fence();
      mma_rows<T, DW>(dk, sh, sl, dqc);
      commit();
      wait<0>();
      pin<DW / 2>(dk);
      pin<DW / 2>(dv);
      pin<L::KR>(ph);
      pin<L::KR>(sh);
    }

    if (more) {
      region_sync();  // the products have read the tile
      stage_q(jt + Z::STEP);
      fence_smem_to_async();
      region_sync();
    }
  }

  if constexpr (W > 1 && !Z::SPLIT_D) {
    // warpgroups 1.. hand dK and dV to warpgroup 0, thread by thread (the
    // same keys and columns), which adds them in warpgroup order
    float* xs = reinterpret_cast<float*>(smem + Z::WO);
    __syncthreads();
    if (wg > 0) {
      float* x = xs + (wg - 1) * D * 128 + wt;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        x[i * 128] = dk[i];
        x[(D / 2 + i) * 128] = dv[i];
      }
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float* x = xs + (w - 1) * D * 128 + wt;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk[i] += x[i * 128];
        dv[i] += x[(D / 2 + i) * 128];
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kt + ra + 8 * half;
    if (key >= a.Sk) continue;
    T* pk = static_cast<T*>(a.dk) + b * a.sdk_.b + key * a.sdk_.s +
            hk * a.sdk_.h;
    T* pv = static_cast<T*>(a.dv) + b * a.sdv_.b + key * a.sdv_.s +
            hk * a.sdv_.h + cols;
    pk += cols;
#pragma unroll
    for (int i = 0; i < DW / 8; ++i) {
      store_pair(pk + 8 * i + 2 * t, dk[4 * i + 2 * half] * a.scale,
                 dk[4 * i + 2 * half + 1] * a.scale);
      store_pair(pv + 8 * i + 2 * t, dv[4 * i + 2 * half],
                 dv[4 * i + 2 * half + 1]);
    }
  }
}

// fp32 at head_dim 128 on the CUDA cores: the two passes of the tensor-core
// kernels, each tile held once in fp32, its rows SP floats apart (a column
// read by the 32 lanes of a warp on 32 rows meets 32 banks), 256 threads a
// block. The masks, exps and the order of every sum are fixed, so the
// result is the same bits on every run.
constexpr int SD = 128;     // head_dim
constexpr int SP = SD + 1;  // a tile row's stride, floats
constexpr int SQ = 32;      // packed query rows a tile of the dK/dV pass

// Rows [0, n) of an [n][SP] tile from the fp32 rows src(r) (nullptr:
// zeros), by the block's 256 threads, 16 bytes a load.
template <typename F>
__device__ __forceinline__ void stage_rows(float* tile, int n, F src) {
  for (int idx = threadIdx.x; idx < n * (SD / 4); idx += 256) {
    const int r = idx / (SD / 4), c = idx % (SD / 4);
    const float* p = src(r);
    const float4 x = p ? __ldg(reinterpret_cast<const float4*>(p) + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    float* t = tile + r * SP + 4 * c;
    t[0] = x.x;
    t[1] = x.y;
    t[2] = x.z;
    t[3] = x.w;
  }
}

// Packed query row pr of KV head hk's group: its fp32 row of a (B, Sq, Hq,
// D) tensor with strides ``st``.
__device__ __forceinline__ const float* qrow(const Args& a, const void* base,
                                             const Str& st, int b, int hk,
                                             int pr) {
  return static_cast<const float*>(base) + b * st.b + (pr / a.g) * st.s +
         (hk * a.g + pr % a.g) * st.h;
}

// The (B, Hq, Sq) index of packed query row pr's lse and Delta.
__device__ __forceinline__ long long row_index(const Args& a, int b, int hk,
                                               int pr) {
  return (static_cast<long long>(b) * a.Hq + hk * a.g + pr % a.g) * a.Sq +
         pr / a.g;
}

// Shared memory of the CUDA-core dK/dV pass: K, V, Q and dO tiles, P^T and
// dS^T (keys by rows), each row's lse (base 2) and Delta.
constexpr size_t SIMT_KV_SMEM =
    (2 * BN * SP + 2 * SQ * SP + 2 * BN * (SQ + 1) + 2 * SQ) * sizeof(float);

// dK/dV pass on the CUDA cores. Grid as bwd_dkdv_wgmma's: a block owns 64
// keys of one KV head and walks the packed query rows that see them, SQ at
// a time. Thread (warp w, lane l): S^T and dP^T of keys 8 w.. against row
// l, then dK and dV of keys 8 w.. at columns l + 32 j.
__global__ void __launch_bounds__(256) bwd_dkdv_simt(Args a) {
  extern __shared__ __align__(16) float fs[];
  float* Ks = fs;
  float* Vs = Ks + BN * SP;
  float* Qs = Vs + BN * SP;
  float* dOs = Qs + SQ * SP;
  float* Ps = dOs + SQ * SP;
  float* dSs = Ps + BN * (SQ + 1);
  float* lse_s = dSs + BN * (SQ + 1);
  float* dl_s = lse_s + SQ;

  const int heads = a.Hkv * a.B, hb = blockIdx.x % heads;
  const int kt = blockIdx.x / heads * BN;
  const int hk = hb % a.Hkv, b = hb / a.Hkv, g = a.g;
  const int key_last = min(kt + BN, a.sk_valid) - 1;
  int row_begin = 0, row_end = kt < a.sk_valid ? a.rows : 0;
  if (a.causal) row_begin = max(0, kt - a.q_offset) * g;
  if (a.window > 0)
    row_end = min(row_end, max(0, key_last + a.window - a.q_offset) * g);
  const int tid = threadIdx.x, lane = tid & 31, n0 = (tid >> 5) * 8;
  const float sl2 = a.scale * LOG2E;

  const float* k0 = static_cast<const float*>(a.k) + b * a.sk_.b +
                    hk * a.sk_.h;
  const float* v0 = static_cast<const float*>(a.v) + b * a.sv_.b +
                    hk * a.sv_.h;
  stage_rows(Ks, BN, [&](int r) {
    return kt + r < a.Sk ? k0 + (kt + r) * a.sk_.s : nullptr;
  });
  stage_rows(Vs, BN, [&](int r) {
    return kt + r < a.Sk ? v0 + (kt + r) * a.sv_.s : nullptr;
  });

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int r0 = row_begin; r0 < row_end; r0 += SQ) {
    const int n_rows = min(SQ, row_end - r0);
    __syncthreads();  // the last tile's reads are done
    stage_rows(Qs, SQ, [&](int m) {
      return m < n_rows ? qrow(a, a.q, a.sq_, b, hk, r0 + m) : nullptr;
    });
    stage_rows(dOs, SQ, [&](int m) {
      return m < n_rows ? qrow(a, a.dout, a.sdo_, b, hk, r0 + m) : nullptr;
    });
    if (tid < SQ) {
      const bool ok = tid < n_rows;
      const long long idx = ok ? row_index(a, b, hk, r0 + tid) : 0;
      lse_s[tid] = ok ? a.lse[idx] * LOG2E : 0.f;
      dl_s[tid] = ok ? a.delta[idx] : 0.f;
    }
    __syncthreads();
    {
      float sv[8], dp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) sv[i] = dp[i] = 0.f;
      const float* qr = Qs + lane * SP;
      const float* orow = dOs + lane * SP;
      const float* kr = Ks + n0 * SP;
      const float* vr = Vs + n0 * SP;
#pragma unroll 4
      for (int d = 0; d < SD; ++d) {
        const float qv = qr[d], ov = orow[d];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          sv[i] = fmaf(kr[i * SP + d], qv, sv[i]);
          dp[i] = fmaf(vr[i * SP + d], ov, dp[i]);
        }
      }
      const bool ok = lane < n_rows;
      const int pos = (r0 + lane) / g + a.q_offset;
      const float l2 = lse_s[lane], dl = dl_s[lane];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + i;
        const float pv = ok && visible(a, pos, kt + n)
                             ? ex2(fmaf(sv[i], sl2, -l2))
                             : 0.f;
        Ps[n * (SQ + 1) + lane] = pv;
        dSs[n * (SQ + 1) + lane] = pv * (dp[i] - dl);
      }
    }
    __syncthreads();
    for (int m = 0; m < n_rows; ++m) {
      float o[4], q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = dOs[m * SP + lane + 32 * j];
        q[j] = Qs[m * SP + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pv = Ps[(n0 + i) * (SQ + 1) + m];
        const float ds = dSs[(n0 + i) * (SQ + 1) + m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dv[i][j] = fmaf(pv, o[j], dv[i][j]);
          dk[i][j] = fmaf(ds, q[j], dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = kt + n0 + i;
    if (key >= a.Sk) continue;
    float* pk = static_cast<float*>(a.dk) + b * a.sdk_.b + key * a.sdk_.s +
                hk * a.sdk_.h;
    float* pv = static_cast<float*>(a.dv) + b * a.sdv_.b + key * a.sdv_.s +
                hk * a.sdv_.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pk[lane + 32 * j] = dk[i][j] * a.scale;
      pv[lane + 32 * j] = dv[i][j];
    }
  }
}

// Shared memory of the CUDA-core dQ pass: Q, dO, K and V tiles, dS (rows
// by keys), each row's lse (base 2) and Delta.
constexpr size_t SIMT_DQ_SMEM =
    (2 * BM * SP + 2 * BN * SP + BM * (BN + 1) + 2 * BM) * sizeof(float);

// dQ pass on the CUDA cores. Grid as bwd_dq_wgmma's: a block owns 64 packed
// rows of one KV head's group and walks the key tiles they see. Thread
// (warp w, lane l): S and dP of rows 8 w.. against keys l and l + 32, then
// dQ of rows 8 w.. at columns l + 32 j.
__global__ void __launch_bounds__(256) bwd_dq_simt(Args a) {
  extern __shared__ __align__(16) float fs[];
  float* Qs = fs;
  float* dOs = Qs + BM * SP;
  float* Ks = dOs + BM * SP;
  float* Vs = Ks + BN * SP;
  float* dSs = Vs + BN * SP;
  float* lse_s = dSs + BM * (BN + 1);
  float* dl_s = lse_s + BM;

  const int heads = a.Hkv * a.B, hb = blockIdx.x % heads;
  const int tile = (a.rows + BM - 1) / BM - 1 - blockIdx.x / heads;
  const int hk = hb % a.Hkv, b = hb / a.Hkv, g = a.g;
  const int r0 = tile * BM;
  const int n_rows = min(BM, a.rows - r0);
  const int pos_lo = r0 / g + a.q_offset;
  const int pos_hi = (r0 + n_rows - 1) / g + a.q_offset;
  const int k_end = a.causal ? min(a.sk_valid, pos_hi + 1) : a.sk_valid;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 8;
  const float sl2 = a.scale * LOG2E;

  stage_rows(Qs, BM, [&](int m) {
    return m < n_rows ? qrow(a, a.q, a.sq_, b, hk, r0 + m) : nullptr;
  });
  stage_rows(dOs, BM, [&](int m) {
    return m < n_rows ? qrow(a, a.dout, a.sdo_, b, hk, r0 + m) : nullptr;
  });
  if (tid < BM) {
    const bool ok = tid < n_rows;
    const long long idx = ok ? row_index(a, b, hk, r0 + tid) : 0;
    lse_s[tid] = ok ? a.lse[idx] * LOG2E : 0.f;
    dl_s[tid] = ok ? a.delta[idx] : 0.f;
  }
  const float* k0 = static_cast<const float*>(a.k) + b * a.sk_.b +
                    hk * a.sk_.h;
  const float* v0 = static_cast<const float*>(a.v) + b * a.sv_.b +
                    hk * a.sv_.h;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int kt = k_begin + jt * BN;
    const int n_keys = min(BN, k_end - kt);
    __syncthreads();  // the last tile's reads are done
    stage_rows(Ks, BN, [&](int r) {
      return r < n_keys ? k0 + (kt + r) * a.sk_.s : nullptr;
    });
    stage_rows(Vs, BN, [&](int r) {
      return r < n_keys ? v0 + (kt + r) * a.sv_.s : nullptr;
    });
    __syncthreads();
    {
      float sv[8][2], dp[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) sv[i][0] = sv[i][1] = dp[i][0] = dp[i][1] = 0.f;
      const float* qr = Qs + m0 * SP;
      const float* orow = dOs + m0 * SP;
#pragma unroll 4
      for (int d = 0; d < SD; ++d) {
        const float ka = Ks[lane * SP + d], kb = Ks[(lane + 32) * SP + d];
        const float va = Vs[lane * SP + d], vb = Vs[(lane + 32) * SP + d];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float qv = qr[i * SP + d], ov = orow[i * SP + d];
          sv[i][0] = fmaf(qv, ka, sv[i][0]);
          sv[i][1] = fmaf(qv, kb, sv[i][1]);
          dp[i][0] = fmaf(ov, va, dp[i][0]);
          dp[i][1] = fmaf(ov, vb, dp[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + i;
        const bool ok = m < n_rows;
        const int pos = (r0 + m) / g + a.q_offset;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = lane + 32 * j;
          const float pv = ok && visible(a, pos, kt + n)
                               ? ex2(fmaf(sv[i][j], sl2, -lse_s[m]))
                               : 0.f;
          dSs[m * (BN + 1) + n] = pv * (dp[i][j] - dl_s[m]);
        }
      }
    }
    __syncthreads();
    for (int n = 0; n < n_keys; ++n) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[n * SP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ds = dSs[(m0 + i) * (BN + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + i;
    if (m >= n_rows) continue;
    const int pr = r0 + m;
    float* p = static_cast<float*>(a.dq) + b * a.sdq_.b + (pr / g) * a.sdq_.s +
               (hk * g + pr % g) * a.sdq_.h;
#pragma unroll
    for (int j = 0; j < 4; ++j) p[lane + 32 * j] = acc[i][j] * a.scale;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A second stream for the dQ pass, which runs beside the dK/dV pass: the
// dK/dV blocks of the last key tiles finish early (causal), and dQ's blocks
// take their multiprocessors. Events fork it from the caller's stream after
// Delta and join it back. One per device, made at the first launch.
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
  cudaError_t err;
};
Side& side() {
  static Side sides[64];
  static bool made[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static Side none{nullptr, nullptr, nullptr, cudaErrorInvalidDevice};
  if (err != cudaSuccess || dev < 0 || dev >= 64) return none;
  Side& x = sides[dev];
  if (!made[dev]) {
    x.err = cudaStreamCreateWithFlags(&x.stream, cudaStreamNonBlocking);
    if (x.err == cudaSuccess)
      x.err = cudaEventCreateWithFlags(&x.fork, cudaEventDisableTiming);
    if (x.err == cudaSuccess)
      x.err = cudaEventCreateWithFlags(&x.join, cudaEventDisableTiming);
    made[dev] = true;
  }
  return x;
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // the passes on the tensor cores, or fp32 at head_dim 128 on the CUDA
  // cores
  void (*dkdv)(Args);
  void (*dq)(Args);
  size_t dkdv_smem, dq_smem;
  int dkdv_threads, dq_threads;
  if constexpr (std::is_same<T, float>::value && D == SD) {
    dkdv = bwd_dkdv_simt, dq = bwd_dq_simt;
    dkdv_smem = SIMT_KV_SMEM, dq_smem = SIMT_DQ_SMEM;
    dkdv_threads = dq_threads = 256;
  } else {
    dkdv = bwd_dkdv_wgmma<T, D>, dq = bwd_dq_wgmma<T, D>;
    dkdv_smem = KV<T, D>::smem, dq_smem = DQ<T, D>::smem;
    dkdv_threads = KV<T, D>::THREADS, dq_threads = 128;
  }
  static bool configured = false;  // the attributes are set once per instance
  if (!configured) {
    cudaError_t err = allow_smem(dq, dq_smem);
    if (err == cudaSuccess) err = allow_smem(dkdv, dkdv_smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const Side& sd = side();
  if (sd.err != cudaSuccess) return sd.err;
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
  const long long groups = (rows + 8 * 32 / Tile<T, D>::CPR - 1) /
                           (8 * 32 / Tile<T, D>::CPR);
  const int sms = multiprocessors();
  const long long cap = sms > 0 ? 8LL * sms : groups;
  bwd_delta<T, D><<<static_cast<unsigned>(groups < cap ? groups : cap), 256,
                    0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(sd.fork, stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(sd.stream, sd.fork, 0);
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.Sk + BN - 1) / BN * a.Hkv * a.B);
  dkdv<<<grid_k, dkdv_threads, dkdv_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.rows + BM - 1) / BM * a.Hkv * a.B);
  dq<<<grid_q, dq_threads, dq_smem, sd.stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(sd.join, sd.stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, sd.join, 0);
  return err;
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, the batch,
// sequence and head strides of q, k, v, o, dO, dQ, dK and dV in that order;
// every row must start 16-byte aligned. lse: the forward's (B, Hq, Sq) fp32
// log-sum-exp; delta: (B, Hq, Sq) fp32 scratch, both contiguous. Three
// kernels: Delta on the stream, then dK and dV on it beside dQ on a second
// stream, which the stream then waits for; returns the first error (0 on
// success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    const long long* strides, int causal, int window, int q_offset,
    int sk_valid, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      (static_cast<long long>(Sq) * (Hq / Hkv) + BM - 1) / BM * Hkv * B >=
          (1LL << 31))
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  Str* st[8] = {&a.sq_, &a.sk_, &a.sv_, &a.so_, &a.sdo_, &a.sdq_, &a.sdk_,
                &a.sdv_};
  for (int i = 0; i < 8; ++i)
    *st[i] = Str{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.g = Hq / Hkv;
  a.rows = Sq * a.g;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.sk_valid = sk_valid; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, a, s);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a, s);
  return cudaErrorInvalidValue;
}
