// Flash attention (prefill) for Hopper on the tensor cores: online-softmax
// attention with the running max, sum and output in fp32 registers, fp32 or
// bf16 in, q's type out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). Same function: causal with the tiles
// above the diagonal skipped, or non-causal; a sliding window that masks one
// side only (q - k < window); q_offset places query row i at absolute
// position i + q_offset; keys at or beyond sk_valid are masked; query head h
// reads KV head h / (Hq / Hkv) for any integer group; a row with no valid key
// gives 0.
//
// What bounds it on an H100: operations, 4 * D FLOPs per (query, key) pair,
// and one exp each, once S is in the thousands; at the prefill lengths the
// engine serves (S <= 160) a few MFLOP per head, so latency: the chain of
// loads, products and softmax steps of the longest block. What the design
// does about it:
// * The products run on the tensor cores through wgmma (sm_90a). bf16:
//   m64nNk16 with fp32 accumulators. fp32: 3xTF32, each operand split into
//   its TF32 rounding hi and the rest lo, the product summed as hi*hi +
//   hi*lo + lo*hi (m64nNk8), which keeps the fp32 result within ~1e-7 where
//   one TF32 product is off by ~3e-4; 495 / 3 = 165 TFLOP/s, above the 67
//   of the CUDA cores.
// * GQA packing: a block owns one (batch, KV head) and 64 packed query rows
//   of its group, row r = (position r / g, head r % g), so each K/V tile is
//   staged once for the g heads that read it, and the 64 rows span only
//   64 / g positions, which keeps their causal key range tight. The grid
//   runs the blocks with the longest key range first.
// * fp32 blocks at head_dim 16, 32 and 64 have two warpgroups that share the
//   Q tile and take every other key tile, each with its own K/V buffer and
//   barrier, and merge their softmax states at the end: the serve path's
//   S = 96 needs two key tiles, which then run side by side. bf16 blocks
//   have one warpgroup: at S = 2048 more blocks on an SM beat the split.
// * head_dim 128 (codeqwen1.5-7b): fp32 has one warpgroup, since two
//   warpgroups' hi and lo K/V parts (2 x 131,584 bytes) beside Q's
//   (65,536) pass the 232,448 bytes a block may have, where one takes
//   197,120. The next tile is not prefetched into registers either: its
//   128 registers a thread beside the 64-float accumulator and the 64 of
//   P's parts would spill. The warpgroup copies each tile after its
//   products, four chunks of K and V at a time. bf16 at 128 (49,152 bytes)
//   keeps the prefetch.
// * The scores stay in registers. P feeds P V as the A operand straight
//   from the accumulator registers: in bf16 as a high and a low bf16 part
//   (P rounded once to bf16 would move long rows' outputs by more than one
//   bf16 step of the fp32 result), in fp32 as TF32 parts. The TF32 A
//   fragment holds columns lane % 4 and lane % 4 + 4 where the accumulator
//   holds 2 (lane % 4) and 2 (lane % 4) + 1, so the keys of each group of 8
//   are staged in V^T in the order 0 2 4 6 1 3 5 7 and P needs no shuffle.
// * The masks are applied only in the tiles that the diagonal, the window's
//   edge or sk_valid cut; the exps are ex2.approx on scores pre-scaled by
//   log2 e.
// * The next K/V tile is loaded into registers while this one is
//   multiplied, then split (fp32) and stored into shared memory: K as it
//   lies (D is contiguous, so K-major for Q K^T); V in bf16 as it lies too,
//   read N-major by wgmma, and in fp32 transposed (TF32 wgmma takes K-major
//   B only), its key chunks padded so the transposing stores meet no bank
//   conflicts. The wgmma descriptors are built once and stepped by
//   constants, so ptxas issues the products back to back.
//
// * For training, the launch may pass an fp32 (B, Hq, Sq) buffer that
//   receives each row's log-sum-exp, from the max and sum the block keeps
//   anyway (flash_attention_bwd.cu reads it); serving passes none and
//   writes nothing more.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D), read
// through element strides for the batch, sequence and head axes (the last
// axis is contiguous; rows 16-byte aligned), so the model's layout needs no
// transposed copy. Grid (packed row tiles, Hkv, B); a loop over 64-key tiles
// inside the block replaces the TPU's sequential grid axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 64;  // keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, Hq, Sq) fp32 log-sum-exp of the scaled scores, or null
  int g, rows;  // query heads per KV head; packed rows Sq * g
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
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
  // warpgroups per block: all share the block's 64 packed rows of Q, each
  // takes every W-th key tile with its own K/V buffer, and they merge their
  // softmax states at the end
  static constexpr int W = sizeof(T) == 4 && D <= 64 ? 2 : 1;
  static constexpr int THREADS = 128 * W;
  static constexpr int E = 16 / sizeof(T);      // elements per 16-byte chunk
  static constexpr int CPR = D / E;             // chunks per row
  static constexpr int NL = CPR / 2;            // K/V chunks a thread stages
  // Whether the next tile's K/V chunks wait in registers while this tile
  // is multiplied: only while they and the accumulator take at most 128
  // registers a thread (not fp32 at D = 128). Else a thread copies its
  // chunks after the products, NR at a time.
  static constexpr bool PREFETCH = NL * 2 * 4 + D / 2 <= 128;
  static constexpr int NR = PREFETCH ? NL : 4;
  static constexpr int NQ = (64 * CPR + THREADS - 1) / THREADS;  // Q chunks
  static constexpr int QB = 64 * D * sizeof(T); // one part of 64 Q or K rows
  static constexpr int LBO_V = D * 16 + 16;     // V^T key chunk, padded
  // bf16 V stays as it lies, [D chunk][key][16 B], read N-major by wgmma;
  // fp32 V is stored transposed (TF32 wgmma takes K-major B only)
  static constexpr bool v_nmajor = sizeof(T) == 2;
  static constexpr int VB = v_nmajor ? QB : BN / E * LBO_V;  // one part of V
  static constexpr int parts = Op<T>::parts;
  static constexpr int KVB = parts * (QB + VB);  // one warpgroup's K and V
  // the merge of the softmax states: o, m and l of W - 1 warpgroups, in
  // the K/V buffers once every product is done
  static constexpr int MERGE = (W - 1) * 128 * (D / 2 + 4) * 4;
  static constexpr size_t smem =
      parts * QB + (W * KVB > MERGE ? W * KVB : MERGE);
  static constexpr int KQ = D * sizeof(T) / 32;  // k-steps of Q K^T
  static constexpr int KP = BN * sizeof(T) / 32; // k-steps of P V
  static_assert(BN == 64, "a thread holds 16 scores of each of its rows");
  static_assert(smem <= 232448, "a block's shared memory on an H100");
};

__device__ __forceinline__ uint4 load16(const void* p, bool ok) {
  return ok ? __ldg(static_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

// Chunk c of row ``row`` of a [chunk][row] tile of 64 rows; fp32 is split
// into its TF32 parts, the low one ``part`` bytes after the high one.
template <typename T>
__device__ __forceinline__ void store_chunk(uint8_t* base, int part, uint4 x,
                                            int c, int row) {
  const int off = chunk_offset(c, row, 64);
  if constexpr (Op<T>::parts == 2) {
    uint4 lo;
    *reinterpret_cast<uint4*>(base + off) = split4(x, lo);
    *reinterpret_cast<uint4*>(base + part + off) = lo;
  } else {
    *reinterpret_cast<uint4*>(base + off) = x;
  }
}

// fp32: chunk c of V row ``key`` (tile-local) stored transposed, V^T being
// D rows by BN keys, K-major, in key chunks of LBO_V bytes, and the keys of
// each group of 8 in the order 0 2 4 6 1 3 5 7.
template <typename T, int D>
__device__ __forceinline__ void store_vt(uint8_t* base, uint4 x, int c,
                                         int key) {
  using L = Tile<T, D>;
  const int d0 = c * L::E;
  const int kp = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
  const int off = (kp >> 2) * L::LBO_V + (kp & 3) * 4;
  const float v[4] = {__uint_as_float(x.x), __uint_as_float(x.y),
                      __uint_as_float(x.z), __uint_as_float(x.w)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, lo;
    split(v[e], hi, lo);
    *reinterpret_cast<float*>(base + off + (d0 + e) * 16) = hi;
    *reinterpret_cast<float*>(base + L::VB + off + (d0 + e) * 16) = lo;
  }
}

// Barrier of one warpgroup's 128 threads (ids 1 + warpgroup; 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// max and sum of 16 values as trees
__device__ __forceinline__ float max16(const float* x) {
  float a = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
  float b = fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7]));
  float c = fmaxf(fmaxf(x[8], x[9]), fmaxf(x[10], x[11]));
  float d = fmaxf(fmaxf(x[12], x[13]), fmaxf(x[14], x[15]));
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}
__device__ __forceinline__ float sum16(const float* x) {
  float a = (x[0] + x[1]) + (x[2] + x[3]);
  float b = (x[4] + x[5]) + (x[6] + x[7]);
  float c = (x[8] + x[9]) + (x[10] + x[11]);
  float d = (x[12] + x[13]) + (x[14] + x[15]);
  return (a + b) + (c + d);
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y,
                                              uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::THREADS) flash_fwd(Args a) {
  using L = Tile<T, D>;
  using OT = typename Op<T>::type;
  constexpr int E = L::E, W = L::W;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* Qs = smem;                       // [parts][D / E chunks][64 rows]
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  uint8_t* Ks = smem + L::parts * L::QB + wg * L::KVB;  // this warpgroup's
  uint8_t* Vs = Ks + L::parts * L::QB;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest key ranges first
  const int hk = blockIdx.y, b = blockIdx.z, g = a.g;
  const int warp = wt >> 5, lane = tid & 31;
  // Keys any row of the tile can see: the causal bound of its last row and
  // the window bound of its first; tiles outside are never loaded.
  const int r0 = tile * 64;
  const int pos_lo = r0 / g + a.q_offset;
  const int pos_hi = (min(r0 + 64, a.rows) - 1) / g + a.q_offset;
  const int k_end = a.causal ? min(a.sk_valid, pos_hi + 1) : a.sk_valid;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  // This thread stages key lr of its warpgroup's tiles, chunks c0, c0 + 2..
  const int lr = wt & 63, c0 = wt >> 6;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh +
                lr * a.k_ss + c0 * E;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh +
                lr * a.v_ss + c0 * E;
  // chunks i0 .. i0 + NR of this thread's key of the tile at kt
  uint4 kx[L::NR], vx[L::NR];
  auto load_kv = [&](int kt, int i0) {
    const bool ok = kt + lr < k_end;
#pragma unroll
    for (int i = 0; i < L::NR; ++i) {
      kx[i] = load16(kb + kt * a.k_ss + 2 * (i0 + i) * E, ok);
      vx[i] = load16(vb + kt * a.v_ss + 2 * (i0 + i) * E, ok);
    }
  };
  auto store_kv = [&](int i0) {
#pragma unroll
    for (int i = 0; i < L::NR; ++i) {
      const int c = c0 + 2 * (i0 + i);
      store_chunk<T>(Ks, L::QB, kx[i], c, lr);
      if constexpr (L::v_nmajor)
        store_chunk<T>(Vs, L::VB, vx[i], c, lr);
      else
        store_vt<T, D>(Vs, vx[i], c, lr);
    }
  };
  // a whole tile: the prefetched chunks, or all of them NR at a time
  auto stage_kv = [&](int kt) {
    if constexpr (L::PREFETCH) {
      store_kv(0);
    } else {
#pragma unroll
      for (int i0 = 0; i0 < L::NL; i0 += L::NR) {
        load_kv(kt, i0);
        store_kv(i0);
      }
    }
  };
  {
    // Q (every thread a share) and each warpgroup's first tile, all in
    // flight before any is stored
    uint4 qx[L::NQ];
#pragma unroll
    for (int i = 0; i < L::NQ; ++i) {
      const int idx = tid + L::THREADS * i, pr = r0 + (idx & 63);
      const T* row = static_cast<const T*>(a.q) + b * a.q_sb +
                     (pr / g) * a.q_ss + (hk * g + pr % g) * a.q_sh;
      qx[i] = load16(row + (idx >> 6) * E,
                     idx < 64 * L::CPR && pr < a.rows);
    }
    if (L::PREFETCH && wg < ntiles) load_kv(k_begin + wg * BN, 0);
#pragma unroll
    for (int i = 0; i < L::NQ; ++i) {
      const int idx = tid + L::THREADS * i;
      if (idx < 64 * L::CPR) store_chunk<T>(Qs, L::QB, qx[i], idx >> 6, idx & 63);
    }
    if (wg < ntiles) stage_kv(k_begin + wg * BN);
  }
  fence_smem_to_async();
  __syncthreads();

  // this thread's two rows of the 64: ra and ra + 8
  const int ra = 16 * warp + (lane >> 2), t = lane & 3;
  const int pos_a = (r0 + ra) / g + a.q_offset;
  const int pos_b = (r0 + ra + 8) / g + a.q_offset;
  const float sl2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  // wgmma descriptors of Q, this warpgroup's K and its V (N-major in bf16:
  // LBO between groups of 8 keys, SBO between D chunks of BN keys)
  const uint64_t dq = desc(Qs, 64 * 16), dk = desc(Ks, BN * 16);
  const uint64_t dv = L::v_nmajor ? desc(Vs, 128, BN * 16) : desc(Vs, L::LBO_V);

  for (int j = wg; j < ntiles; j += W) {
    const int kt = k_begin + j * BN;
    const bool more = j + W < ntiles;
    // in flight while this tile is multiplied
    if (L::PREFETCH && more) load_kv(kt + W * BN, 0);

    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    pin<BN / 2>(s);
    fence();
#pragma unroll
    for (int ks = 0; ks < L::KQ; ++ks) {
      const int off = ks * 2 * 64 * 16;  // two chunks of 64 rows
      mma_ss<OT, BN>(s, desc_at(dq, off), desc_at(dk, off), 1);
      if constexpr (L::parts == 2) {
        mma_ss<OT, BN>(s, desc_at(dq, off), desc_at(dk, L::QB + off), 1);
        mma_ss<OT, BN>(s, desc_at(dq, L::QB + off), desc_at(dk, off), 1);
      }
    }
    commit();
    wait<0>();
    pin<BN / 2>(s);

    // Scale to base 2; mask where the tile is not wholly visible to every
    // row (the diagonal, the window's edge, sk_valid); the online softmax.
    // s[4 i + {0, 1}] are row ra's, s[4 i + {2, 3}] row ra + 8's.
    const bool full = (!a.causal || kt + BN - 1 <= pos_lo) &&
                      kt + BN <= a.sk_valid &&
                      (a.window <= 0 || pos_hi - kt < a.window);
    float ra_s[BN / 4], rb_s[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        float xa = s[4 * i + j2] * sl2, xb = s[4 * i + 2 + j2] * sl2;
        if (!full) {
          const int key = kt + 8 * i + 2 * t + j2;
          const bool kv = key < a.sk_valid;
          if (!(kv && (!a.causal || key <= pos_a) &&
                (a.window <= 0 || pos_a - key < a.window)))
            xa = -INFINITY;
          if (!(kv && (!a.causal || key <= pos_b) &&
                (a.window <= 0 || pos_b - key < a.window)))
            xb = -INFINITY;
        }
        ra_s[2 * i + j2] = xa;
        rb_s[2 * i + j2] = xb;
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(max16(ra_s)));
    const float mn_b = fmaxf(m_b, quad_max(max16(rb_s)));
    // a row with no valid key so far keeps p = 0 (and no inf - inf)
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = ex2(m_a - base_a), al_b = ex2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      ra_s[i] = ex2(ra_s[i] - base_a);
      rb_s[i] = ex2(rb_s[i] - base_b);
    }
    l_a = l_a * al_a + sum16(ra_s);
    l_b = l_b * al_b + sum16(rb_s);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= al_a;
      o[4 * i + 1] *= al_a;
      o[4 * i + 2] *= al_b;
      o[4 * i + 3] *= al_b;
    }

    // P as the A operand of P V, in a high and a low part
    uint32_t ph[L::KP][4], pl[L::KP][4];
#pragma unroll
    for (int ks = 0; ks < L::KP; ++ks) {
      if constexpr (L::parts == 2) {
        // columns 2 t and 2 t + 1 of the 8 keys as TF32 columns t, t + 4
        const float p4[4] = {ra_s[2 * ks], rb_s[2 * ks], ra_s[2 * ks + 1],
                             rb_s[2 * ks + 1]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float hi, lo;
          split(p4[r], hi, lo);
          ph[ks][r] = __float_as_uint(hi);
          pl[ks][r] = __float_as_uint(lo);
        }
      } else {
        ph[ks][0] = pack_bf16(ra_s[4 * ks], ra_s[4 * ks + 1], pl[ks][0]);
        ph[ks][1] = pack_bf16(rb_s[4 * ks], rb_s[4 * ks + 1], pl[ks][1]);
        ph[ks][2] = pack_bf16(ra_s[4 * ks + 2], ra_s[4 * ks + 3], pl[ks][2]);
        ph[ks][3] = pack_bf16(rb_s[4 * ks + 2], rb_s[4 * ks + 3], pl[ks][3]);
      }
    }
    pin<D / 2>(o);
    fence();
#pragma unroll
    for (int ks = 0; ks < L::KP; ++ks) {
      if constexpr (L::v_nmajor) {
        // 16 keys = two groups of 8 key rows
        mma_rs_tb<OT, D>(o, ph[ks], desc_at(dv, ks * 2 * 128), 1);
        mma_rs_tb<OT, D>(o, pl[ks], desc_at(dv, ks * 2 * 128), 1);
      } else {
        const int off = ks * 2 * L::LBO_V;
        mma_rs<OT, D>(o, ph[ks], desc_at(dv, off), 1);
        mma_rs<OT, D>(o, ph[ks], desc_at(dv, L::VB + off), 1);
        mma_rs<OT, D>(o, pl[ks], desc_at(dv, off), 1);
      }
    }
    commit();
    wait<0>();
    pin<D / 2>(o);

    if (more) {
      wg_sync(wg);  // the warpgroup's products have read its tile
      stage_kv(kt + W * BN);
      fence_smem_to_async();
      wg_sync(wg);
    }
  }

  if constexpr (W > 1) {
    // merge: warpgroups 1.. hand o, m and l to warpgroup 0, thread by
    // thread (the same rows and columns), through the K/V buffers
    float* xs = reinterpret_cast<float*>(smem + L::parts * L::QB);
    constexpr int NX = D / 2 + 4;
    __syncthreads();
    if (wg > 0) {
      float* x = xs + (wg - 1) * NX * 128 + wt;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) x[i * 128] = o[i];
      x[(D / 2) * 128] = m_a;
      x[(D / 2 + 1) * 128] = m_b;
      x[(D / 2 + 2) * 128] = l_a;
      x[(D / 2 + 3) * 128] = l_b;
    }
    __syncthreads();
    if (wg > 0) return;
#pragma unroll
    for (int w = 1; w < W; ++w) {
      const float* x = xs + (w - 1) * NX * 128 + wt;
      const float mw_a = x[(D / 2) * 128], mw_b = x[(D / 2 + 1) * 128];
      const float mn_a = fmaxf(m_a, mw_a), mn_b = fmaxf(m_b, mw_b);
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float f0_a = ex2(m_a - base_a), f0_b = ex2(m_b - base_b);
      const float fw_a = ex2(mw_a - base_a), fw_b = ex2(mw_b - base_b);
      l_a = l_a * f0_a + x[(D / 2 + 2) * 128] * fw_a;
      l_b = l_b * f0_b + x[(D / 2 + 3) * 128] * fw_b;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] = o[4 * i] * f0_a + x[(4 * i) * 128] * fw_a;
        o[4 * i + 1] = o[4 * i + 1] * f0_a + x[(4 * i + 1) * 128] * fw_a;
        o[4 * i + 2] = o[4 * i + 2] * f0_b + x[(4 * i + 2) * 128] * fw_b;
        o[4 * i + 3] = o[4 * i + 3] * f0_b + x[(4 * i + 3) * 128] * fw_b;
      }
      m_a = mn_a;
      m_b = mn_b;
    }
  }

  const float den_a = quad_sum(l_a), den_b = quad_sum(l_b);
  const float inv_a = den_a == 0.f ? 1.f : 1.f / den_a;
  const float inv_b = den_b == 0.f ? 1.f : 1.f / den_b;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = r0 + ra + 8 * half;
    if (pr >= a.rows) continue;
    T* op = static_cast<T*>(a.o) + b * a.o_sb + (pr / g) * a.o_ss +
            (hk * g + pr % g) * a.o_sh;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      store_pair(op + 8 * i + 2 * t, o[4 * i + 2 * half] * inv,
                 o[4 * i + 2 * half + 1] * inv);
    // the row's log-sum-exp for the backward, in natural units: the max is
    // kept in base 2 (scores times scale log2 e); -inf for a row with no
    // valid key
    if (a.lse != nullptr && t == 0) {
      const float den = half ? den_b : den_a, m = half ? m_b : m_a;
      a.lse[(static_cast<long long>(b) * gridDim.y * g + hk * g + pr % g) *
                (a.rows / g) + pr / g] =
          den == 0.f ? -INFINITY : (m + log2f(den)) * 0.6931471805599453f;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  constexpr size_t smem = Tile<T, D>::smem;
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  using L = Tile<T, D>;
  dim3 grid((a.rows + 63) / 64, Hkv, B);
  flash_fwd<T, D><<<grid, L::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, int B, int Hkv, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, Hkv, stream);
    case 32: return launch<T, 32>(a, B, Hkv, stream);
    case 64: return launch<T, 64>(a, B, Hkv, stream);
    case 128: return launch<T, 128>(a, B, Hkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the batch,
// sequence and head strides of q, k, v and o in that order; every row must
// start 16-byte aligned. lse: null, or a contiguous (B, Hq, Sq) fp32 tensor
// that receives each row's log-sum-exp of the scaled scores (the backward's
// input; -inf for a row with no valid key). Returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int dtype, int B, int Sq, int Hq,
                                   int Hkv, int D, const long long* strides,
                                   int causal, int window, int q_offset,
                                   int sk_valid, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lse = lse;
  a.g = Hq / Hkv;
  a.rows = Sq * a.g;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.sk_valid = sk_valid; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, a, B, Hkv, st);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a, B, Hkv, st);
  return cudaErrorInvalidValue;
}
