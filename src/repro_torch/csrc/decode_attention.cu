// Decode attention for Hopper: one query token per sequence against a KV
// cache with a per-sequence valid length, fp32 or bf16 in, q's type out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel). Same function: query head h reads KV
// head h / (Hq / Hkv) for any integer group up to 16; keys at or beyond
// cache_len[b] are masked; cache_len[b] = 0 gives 0. Beyond it, a sliding
// window (window > 0, Hymba's sliding layers) masks the keys below
// cache_len[b] - window, as the JAX model's einsum decode does
// (src/repro/models/attention.py decode_attention; the Pallas kernel has no
// window).
//
// What bounds it on an H100: at the path's shape (4 slots of a 160-entry
// cache, 14 query heads over 2 KV heads of 64, ~340 valid entries) the
// bytes (~0.35 MB, 0.1 us at 3.35 TB/s) are far below one launch, so
// latency: the launch, the first load's trip to memory, and the longest
// chain of dependent steps in a block. At the long shape (32 slots of a
// 4096-entry cache, 67,584 valid entries, 69 MB) bytes: every valid K and
// V row streams from memory once at ~4 FLOPs per byte, far below what the
// CUDA cores need to become the limit, so the FMAs stay on the CUDA cores
// (fp32-exact; mma's 16-row tiles would idle 9 of a group's 16 rows at
// qwen2-0.5b's group of 7). What the design does about it:
// * one launch, no scratch (the first version launched a split pass and a
//   merge pass, with partials in device memory): one block, or a
//   thread-block cluster of up to 8 blocks, serves one (KV head,
//   sequence); each of a block's 4 warps takes every (4 x ranks)-th tile of
//   32 keys and keeps its own online-softmax state (max, sum, accumulator)
//   for all query heads of the group; the warps merge in shared memory,
//   the blocks through distributed shared memory into the cluster's first
//   block, which writes the output. A short cache (the path's) gets one
//   block, since a cluster's barriers cost more than a warp's second tile;
//   a long one a cluster, to fill the card (ranks_for);
// * the group's rows are rounded up to a power of two at compile time
//   (7 -> 8 at qwen2-0.5b), so no row of the unrolled loops is predicated
//   off;
// * each warp streams its tiles through its own two-stage ring in shared
//   memory with 16-byte cp.async copies (zero-filled past cache_len), so
//   the next tile's loads are in flight while this one is multiplied and
//   warps never wait on each other until the merge. fp32 at head_dim 128
//   (codeqwen1.5-7b) has a one-stage ring: two stages (270,336 bytes)
//   and the cluster's merge state pass the 232,448 bytes a block may have,
//   one takes 218,112 with 8 ranks; its warps overlap each other's loads
//   instead of their own;
// * one block serves all query heads of its KV head's group, so each K/V
//   row is read from memory once, not once per query head; a lane holds
//   one key's scores for the whole group, then the output columns of the
//   group (D / 32 columns a lane at D >= 64: 4 at head_dim 128), so both
//   products are chains of independent FMAs with operands read from shared
//   memory without bank conflicts (rows padded by 16 bytes);
// * cache_len is read on the device and tiles at or beyond it are never
//   loaded, so the bytes moved follow the valid lengths, not the cache size;
//   with a window, a block's first tile starts at the window's first key
//   (cache_len - window), so no tile before the window is loaded either,
//   and the cluster is sized from the keys a window reads, not from S;
// * the engine's (B, S, Hkv, D) cache slice is read in place through its
//   strides, with no transposed or contiguous copy; rows that are not
//   16-byte aligned are loaded element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int KEYS = 32;       // keys per tile: one a lane
constexpr int GMAX = 16;       // largest query-head group
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_RANKS = 8;   // blocks per cluster (the portable limit)
constexpr int SMEM_MAX = 232448;  // a block's shared memory on an H100
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* o;
  int S, g, ranks;
  int window;  // > 0: only the last ``window`` valid keys; 0: all
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;  // D^-0.5 log2(e): scores in log2 units, exps as ex2
};

template <typename T, int D>
struct Lay {
  static constexpr int E = 16 / sizeof(T);            // elements per chunk
  static constexpr int CPR = D / E;                   // chunks per row
  static constexpr int ROW = D + E;                   // smem row, padded
  static constexpr int TILE = KEYS * ROW * sizeof(T); // K or V of a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int QS = GMAX * D * 4;             // q, pre-scaled fp32
  static constexpr int PS = WARPS * GMAX * KEYS * 4;  // each warp's P
  static constexpr int STATE = GMAX * (D + 2) * 4;    // acc rows, m, l
  // tiles in flight per warp: two where they fit beside the rest at
  // MAX_RANKS, else one (fp32 at D = 128)
  static constexpr int STAGES =
      WARPS * 2 * STAGE + QS + PS + MAX_RANKS * STATE <= SMEM_MAX ? 2 : 1;
  static constexpr int RING = WARPS * STAGES * STAGE;
  // output columns a lane holds, lanes per row, rows between a lane's rows
  static constexpr int COLS = D >= 32 ? D / 32 : 1;
  static constexpr int CW = D / COLS;
  static constexpr int RSTEP = 32 / CW;
  static size_t smem(int ranks) {
    return RING + QS + PS + static_cast<size_t>(ranks) * STATE;
  }
  static_assert(STAGES * STAGE >= STATE, "a warp's state fits its ring");
  static_assert(RING + QS + PS + MAX_RANKS * STATE <= SMEM_MAX,
                "a block's shared memory on an H100");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// COLS consecutive elements as floats.
template <int COLS>
__device__ __forceinline__ void ldc(const float* p, float (&x)[COLS]) {
  if constexpr (COLS == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x;
    x[1] = u.y;
  } else if constexpr (COLS == 4) {
    const float4 u = hopper::ld4(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) x[c] = p[c];
  }
}
template <int COLS>
__device__ __forceinline__ void ldc(const __nv_bfloat16* p, float (&x)[COLS]) {
  if constexpr (COLS == 2) {
    const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = u.x;
    x[1] = u.y;
  } else if constexpr (COLS == 4) {
    const float4 u = hopper::ld4(p);
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  } else {
#pragma unroll
    for (int c = 0; c < COLS; ++c) x[c] = __bfloat162float(p[c]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2^(m - mx), 0 for a state that has seen no key (m = -inf).
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : hopper::ex2(m - mx);
}

// One warp's K and V rows k0 .. k0 + KEYS of the cache into a ring stage,
// rows at or past len as zeros: 16-byte cp.async copies (in flight until
// cp_wait), or element by element where the rows are not 16-byte aligned.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_tile(uint8_t* stage, const T* kp,
                                          const T* vp, const Args& a, int k0,
                                          int len, int lane) {
  using Ly = Lay<T, D>;
#pragma unroll
  for (int i = lane; i < KEYS * Ly::CPR; i += 32) {
    const int r = i / Ly::CPR, c = (i % Ly::CPR) * Ly::E;
    const bool in = k0 + r < len;
    const long long row = in ? k0 + r : 0;
    T* dk = reinterpret_cast<T*>(stage) + r * Ly::ROW + c;
    T* dv = dk + Ly::TILE / sizeof(T);
    const T* sk = kp + row * a.k_ss + c;
    const T* sv = vp + row * a.v_ss + c;
    if constexpr (VEC) {
      hopper::cp_async16(dk, sk, in ? 16 : 0);
      hopper::cp_async16(dv, sv, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < Ly::E; ++e) {
        dk[e] = in ? sk[e] : from_f<T>(0.f);
        dv[e] = in ? sv[e] : from_f<T>(0.f);
      }
    }
  }
}

// Merge n states, ``stride`` floats apart, each [GMAX][D + 2] (acc row,
// then m and l), for row j, column c: returns acc and sets the merged
// state's max mx and sum l.
template <int D>
__device__ __forceinline__ float merge(const float* st, int n, int stride,
                                       int j, int c, float& mx, float& l) {
  mx = -INFINITY;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, st[i * stride + j * (D + 2) + D]);
  float acc = 0.f;
  l = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* s = st + i * stride + j * (D + 2);
    const float w = weight(s[D], mx);
    l = fmaf(s[D + 1], w, l);
    acc = fmaf(s[c], w, acc);
  }
  return acc;
}

// GP: the group rounded up to a power of two (at least 2), the rows a lane
// computes; rows g .. GP read zero queries and are never written.
template <typename T, int D, int GP, bool VEC>
__global__ void __launch_bounds__(THREADS) decode_kernel(Args a) {
  using Ly = Lay<T, D>;
  constexpr int RROWS = GP / Ly::RSTEP;  // rows of the output a lane holds
  extern __shared__ __align__(128) uint8_t smem[];
  float* Qs = reinterpret_cast<float*>(smem + Ly::RING);  // [GP][D]
  float* Ps = Qs + GMAX * D;                               // [warp][GP][KEYS]
  float* Cl = Ps + WARPS * GMAX * KEYS;  // [rank] states, in rank 0
  const int rank = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = a.g;
  const bool cluster = a.ranks > 1;
  if (cluster) hopper::cluster_arrive();  // waited for before the merge
  // The keys read, first .. end: with a window, its first key on; tiles
  // and lanes below count from ``first``.
  const int end = max(0, min(a.cache_len[b], a.S));
  const int first = a.window > 0 ? max(0, end - a.window) : 0;
  const int len = end - first;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh +
                first * a.k_ss;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh +
                first * a.v_ss;

  // This warp's tiles: t, t + step, ... below len, through its own ring
  // of STAGES tiles, all in flight before the first is used.
  constexpr int STAGES = Ly::STAGES;
  uint8_t* ring = smem + warp * STAGES * Ly::STAGE;
  const int step = a.ranks * WARPS;
  int t = rank * WARPS + warp;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    const int ti = t + i * step;
    if (ti * KEYS < len)
      load_tile<T, D, VEC>(ring + i * Ly::STAGE, kp, vp, a, ti * KEYS, len, lane);
    hopper::cp_commit();
  }

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + hk * g * a.q_sh;
  for (int i = tid; i < GP * D; i += THREADS) {
    const int j = i / D, c = i % D;
    Qs[i] = j < g ? to_f(qp[j * a.q_sh + c]) * a.scale : 0.f;
  }
  __syncthreads();

  // Lane layout of the output: columns c0 .. c0 + COLS of rows r0 + RSTEP i.
  const int c0 = (lane % Ly::CW) * Ly::COLS, r0 = lane / Ly::CW;
  float m[GP], lsum[GP], acc[RROWS][Ly::COLS];
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    m[j] = -INFINITY;
    lsum[j] = 0.f;  // this lane's keys only, summed over the warp at the end
  }
#pragma unroll
  for (int i = 0; i < RROWS; ++i)
#pragma unroll
    for (int c = 0; c < Ly::COLS; ++c) acc[i][c] = 0.f;
  float* P = Ps + warp * GMAX * KEYS;

  for (int st = 0; t * KEYS < len; t += step, st = (st + 1) % STAGES) {
    hopper::cp_wait<STAGES - 1>();  // this tile has landed
    __syncwarp();
    const T* Kt = reinterpret_cast<const T*>(ring + st * Ly::STAGE);
    const T* Vt = Kt + Ly::TILE / sizeof(T);

    // Scores of this lane's key for every query head of the group.
    float s[GP];
#pragma unroll
    for (int j = 0; j < GP; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 k4 = hopper::ld4(Kt + lane * Ly::ROW + c);
#pragma unroll
      for (int j = 0; j < GP; ++j) {
        const float4 q4 = *reinterpret_cast<const float4*>(Qs + j * D + c);
        s[j] = fmaf(q4.x, k4.x, s[j]);
        s[j] = fmaf(q4.y, k4.y, s[j]);
        s[j] = fmaf(q4.z, k4.z, s[j]);
        s[j] = fmaf(q4.w, k4.w, s[j]);
      }
    }
    // Online softmax: the tile's first key is valid, so each new max is
    // finite; alpha rescales what the state held.
    const bool valid = t * KEYS + lane < len;
    float alpha[GP];
#pragma unroll
    for (int j = 0; j < GP; ++j) {
      const float sj = valid ? s[j] : -INFINITY;
      const float mx = fmaxf(m[j], warp_max(sj));
      alpha[j] = weight(m[j], mx);
      const float p = hopper::ex2(sj - mx);
      lsum[j] = fmaf(lsum[j], alpha[j], p);
      m[j] = mx;
      P[j * KEYS + lane] = p;
    }
#pragma unroll
    for (int i = 0; i < RROWS; ++i) {
      float al = alpha[Ly::RSTEP * i];
#pragma unroll
      for (int r = 1; r < Ly::RSTEP; ++r)
        if (r0 == r) al = alpha[Ly::RSTEP * i + r];
#pragma unroll
      for (int c = 0; c < Ly::COLS; ++c) acc[i][c] *= al;
    }
    __syncwarp();

    // acc += P V over the tile's keys (zeros past len add nothing).
#pragma unroll 2
    for (int kk = 0; kk < KEYS; kk += 4) {
      float v[4][Ly::COLS];
#pragma unroll
      for (int u = 0; u < 4; ++u) ldc<Ly::COLS>(Vt + (kk + u) * Ly::ROW + c0, v[u]);
#pragma unroll
      for (int i = 0; i < RROWS; ++i) {
        const int j = r0 + Ly::RSTEP * i;
        const float4 p4 = *reinterpret_cast<const float4*>(P + j * KEYS + kk);
#pragma unroll
        for (int c = 0; c < Ly::COLS; ++c) {
          acc[i][c] = fmaf(p4.x, v[0][c], acc[i][c]);
          acc[i][c] = fmaf(p4.y, v[1][c], acc[i][c]);
          acc[i][c] = fmaf(p4.z, v[2][c], acc[i][c]);
          acc[i][c] = fmaf(p4.w, v[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();  // P and this stage are rewritten by the next tiles
    const int next = t + STAGES * step;
    if (next * KEYS < len)
      load_tile<T, D, VEC>(ring + st * Ly::STAGE, kp, vp, a, next * KEYS, len,
                           lane);
    hopper::cp_commit();
  }
  hopper::cp_wait<0>();
  __syncwarp();

  // This warp's state, into its own ring (done with it): [GMAX][D + 2].
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < GP; ++j) {
    const float l = warp_sum(lsum[j]);
    if (lane == 0 && j < g) {
      mine[j * (D + 2) + D] = m[j];
      mine[j * (D + 2) + D + 1] = l;
    }
  }
#pragma unroll
  for (int i = 0; i < RROWS; ++i) {
    const int j = r0 + Ly::RSTEP * i;
    if (j < g)
#pragma unroll
      for (int c = 0; c < Ly::COLS; ++c) mine[j * (D + 2) + c0 + c] = acc[i][c];
  }
  __syncthreads();

  // Merge the warps (their states lie one ring apart): into the output,
  // or with a cluster into slot ``rank`` of the first block's shared
  // memory, where the first block merges the slots.
  constexpr int RS = STAGES * Ly::STAGE / 4;  // floats between warp states
  constexpr int SLOT = GMAX * (D + 2);
  static_assert(RS >= SLOT, "states do not overlap");
  const float* ws = reinterpret_cast<const float*>(smem);
  T* op = static_cast<T*>(a.o) + b * a.o_sb + hk * g * a.o_sh;
  if (cluster) hopper::cluster_wait();  // every block of the cluster runs
  for (int i = tid; i < g * D; i += THREADS) {
    const int j = i / D, c = i % D;
    float mx, l;
    const float o = merge<D>(ws, WARPS, RS, j, c, mx, l);
    if (!cluster) {
      op[j * a.o_sh + c] = from_f<T>(l == 0.f ? 0.f : o / l);
    } else {
      float* slot = Cl + rank * SLOT + j * (D + 2);
      hopper::store_remote(slot + c, 0, o);
      if (c == 0) {
        hopper::store_remote(slot + D, 0, mx);
        hopper::store_remote(slot + D + 1, 0, l);
      }
    }
  }
  if (!cluster) return;
  hopper::cluster_sync();
  if (rank != 0) return;
  for (int i = tid; i < g * D; i += THREADS) {
    const int j = i / D, c = i % D;
    float mx, l;
    const float o = merge<D>(Cl, a.ranks, SLOT, j, c, mx, l);
    op[j * a.o_sh + c] = from_f<T>(l == 0.f ? 0.f : o / l);
  }
}

template <typename T, int D, int GP, bool VEC>
cudaError_t launch(const Args& a, int Hkv, int B, cudaStream_t stream) {
  using Ly = Lay<T, D>;
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, D, GP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Ly::smem(MAX_RANKS));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks, Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ly::smem(a.ranks > 1 ? a.ranks : 0);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.ranks > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, decode_kernel<T, D, GP, VEC>, a);
}

template <typename T, int D, int GP>
cudaError_t by_vec(const Args& a, int Hkv, int B, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows: aligned bases, and batch,
  // sequence and head strides in whole 16-byte chunks
  constexpr int E = 16 / sizeof(T);
  const bool vec =
      reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.v) % 16 == 0 && a.k_sb % E == 0 &&
      a.k_ss % E == 0 && a.k_sh % E == 0 && a.v_sb % E == 0 &&
      a.v_ss % E == 0 && a.v_sh % E == 0;
  return vec ? launch<T, D, GP, true>(a, Hkv, B, stream)
             : launch<T, D, GP, false>(a, Hkv, B, stream);
}

template <typename T, int D>
cudaError_t by_group(const Args& a, int Hkv, int B, cudaStream_t stream) {
  if (a.g <= 2) return by_vec<T, D, 2>(a, Hkv, B, stream);
  if (a.g <= 4) return by_vec<T, D, 4>(a, Hkv, B, stream);
  if (a.g <= 8) return by_vec<T, D, 8>(a, Hkv, B, stream);
  return by_vec<T, D, 16>(a, Hkv, B, stream);
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, int Hkv, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return by_group<T, 16>(a, Hkv, B, stream);
    case 64: return by_group<T, 64>(a, Hkv, B, stream);
    case 128: return by_group<T, 128>(a, Hkv, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Cluster blocks per (KV head, sequence) for B sequences of an S-entry
// cache over Hkv KV heads on a card of ``sms`` multiprocessors: enough that
// no warp takes more than 8 tiles of 32 keys; more, up to 2 tiles a warp,
// while the grid is smaller than the card; at most 8. A short cache gets
// one block: a cluster's barriers cost more than a warp's second tile.
int ranks_for(int S, int B, int Hkv, int sms) {
  const int tiles = (S + KEYS - 1) / KEYS;
  const int least = (tiles + 8 * WARPS - 1) / (8 * WARPS);
  const int fill = (sms + B * Hkv - 1) / (B * Hkv);
  const int most = (tiles + 2 * WARPS - 1) / (2 * WARPS);
  const int spread = most < fill ? most : fill;
  const int ranks = least > spread ? least : spread;
  return ranks < 1 ? 1 : ranks > MAX_RANKS ? MAX_RANKS : ranks;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window: 0 = every valid key, > 0 = the
// last ``window`` valid keys of each sequence. strides: 10 element strides,
// q's batch and head strides, k's and v's batch, sequence and head
// strides, o's batch and head strides, in that order. One kernel launch,
// no scratch. Returns the launch's cudaError_t (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* cache_len, void* o, int dtype,
                                    int B, int S, int Hq, int Hkv, int D,
                                    int window, const long long* strides,
                                    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX ||
      window < 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.cache_len = cache_len; a.o = o;
  a.S = S; a.g = Hq / Hkv; a.window = window;
  // a window reads at most ``window`` keys a sequence, wherever they lie
  a.ranks = ranks_for(window > 0 && window < S ? window : S, B, Hkv,
                      hopper::multiprocessors());
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_ss = strides[3]; a.k_sh = strides[4];
  a.v_sb = strides[5]; a.v_ss = strides[6]; a.v_sh = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.scale = scale * LOG2E;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = by_dim<float>(D, a, Hkv, B, st);
  if (dtype == 1) err = by_dim<__nv_bfloat16>(D, a, Hkv, B, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
