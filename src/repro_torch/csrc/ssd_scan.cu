// Mamba2 SSD chunked scan for Hopper on the tensor cores: the chunked dual
// form of the selective state-space recurrence, fp32 or bf16 in, fp32 state
// and sums, y in dx's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _kernel). Same function: for every (batch, head), with
// cs = the running sum of the log-decays dA,
//   y_t   = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dx_s + exp(cs_t) C_t . state0
//   state = state0 exp(cs_S) + sum_s B_s (x) dx_s exp(cs_S - cs_s)
// where head h reads B/C group h / (H / G). The dual form is exact for any
// chunking, so this kernel uses its own chunk of L = 64 steps (the TPU
// kernel took the model's chunk, up to 256) and any S: the last chunk is
// ragged, its missing steps read as dA = 0, B = C = dx = 0.
//
// What bounds it on an H100: at the served prefill (B = 1, S = 96, H = 64,
// P = 64, N = 128) latency: ~5.4 MB and ~0.2 GFLOP of least work (1.6 us
// and 1.3 us at the card's peaks) over two chunks of each head; at S = 2048
// the same per chunk, 32 chunks in a row: the chain of loads, products and
// barriers of one chunk, times the chunks, times the waves of blocks. The
// operations bound (~4.2 S H N P FLOPs, 0.027 ms at 3xTF32's 165 TFLOP/s)
// is far below that chain. The first version ran one block per head (64
// blocks on 132 SMs) on fp32 CUDA-core FMAs. What this design does:
// * the P columns are split: a block owns 16 of them for one (head, batch),
//   so B = 1 runs P / 16 x H = 256 blocks at mamba2-1.3b's heads, and each
//   block carries its N x 16 slice of the state from chunk to chunk in
//   registers (the TPU kernel's VMEM carry), never in device memory;
// * every product runs on the tensor cores through wgmma with fp32 sums.
//   In fp32 each is 3xTF32 (operands split into their TF32 rounding hi and
//   the rest lo; hi*hi + hi*lo + lo*hi, ~2^-20 relative); bf16 inputs are
//   exact in TF32, so their lo parts are zero and the terms that would
//   read them are skipped, and the fp32 state stays as exact as in fp32:
//   - the scores C B^T and C . state are one m64n80 product, B's 64 steps
//     and the state^T's 16 columns stacked as its B operand; C is its A
//     operand from registers, split once per k-step; the two warpgroups
//     take half of the k-steps each and swap their partial sums;
//   - the state update (B w)^T dx, w = exp(cs_last - cs), per 64 state rows
//     a warpgroup, A = (B w)^T built in registers from B's tile;
//   - the decayed causal scores times dx, per 32 steps a warpgroup, the
//     scores fed from the accumulator registers as the A operand: dx^T's
//     steps are stored in the order 0 2 4 6 1 3 5 7 within each 8, the
//     order in which those registers are the TF32 A fragment;
//   - dx^T holds its hi and lo parts as 32 rows, so hi . [dx_hi | dx_lo] is
//     one m64n32 product;
//   both warpgroups issue the same wgmma sequence (in a branch on the
//   warpgroup, ptxas would serialise them), with two batches of score
//   k-steps in flight, and the state update and the causal product in
//   flight while the next one's operands are built;
// * the scores of a group are recomputed by each of its heads' blocks
//   (with G = 1, 256 times), because sharing them costs more than it
//   saves (ssd_probe.py, one H100 at 700 W, fp32): a block that forms only
//   its quarter of them is 3-6% faster, but the exchange of the quarters
//   through a cluster of a head's 4 blocks adds ~2,000 cycles to a chunk
//   of ~11,000 and makes the scan 58-68% slower. Their k-steps take ~38%
//   of a chunk's cycles, and not for the tensor work: a quarter of the
//   columns takes ~88% as long (the chain of fragment builds, issues and
//   waits, not the products, sets the pace);
// * the next chunk's C, B, dx and dA are copied into shared memory with
//   16-byte cp.async copies (whole rows, 64 bytes of dx, coalesced) while
//   this chunk multiplies; B and dx are then split into their TF32 parts in
//   the wgmma tiles, C is read as it lies; the dA scan runs in a warp that
//   is idle while y is written.
// State width: N <= 128 (64 rows a warpgroup; 218 KB of shared memory in
// fp32 at N = 128).
//
// Timing probes, off unless defined at build time (ssd_probe.py builds and
// times them): SSD_STAMPS records clock64() stamps of block (0, 0, 0)'s
// thread 0 at the phase ends of each chunk; SSD_SHARE models sharing the
// scores across a head's four P blocks, and its y is wrong: with 1, a
// block forms only its quarter of the score columns; with 2, it also sends
// that quarter into the shared memory of the three other blocks of a
// cluster of 4 and reads theirs back, a cluster barrier a chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int L = 64;            // steps per chunk
constexpr int PB = 16;           // columns of P a block owns
constexpr int THREADS = 256;     // two warpgroups
constexpr int KB = 2;            // k-steps of C fragments in one batch
constexpr int SCAN_WARP = 4;     // scans dA: idle while y is written
constexpr int MAX_SMEM = 232448; // a block's shared memory on the H100
constexpr int MAX_N = 128;       // state rows: 64 a warpgroup
#ifndef SSD_SHARE
#define SSD_SHARE 0
#endif
constexpr int SHARE_RX = SSD_SHARE == 2 ? 3 * L * PB * 4 : 0;  // received

#ifdef SSD_STAMPS
__device__ long long stamps[64][8];
#define STAMP(k)                                                         \
  if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && threadIdx.x == 0 &&   \
      c0 / L < 64)                                                       \
  stamps[c0 / L][k] = clock64()
#else
#define STAMP(k)
#endif

struct Args {
  const void* dx;
  const float* dA;
  const void* B;
  const void* C;
  const float* init;  // (Bt, H, N, P) fp32 or null for zeros
  void* y;            // (Bt, S, H, P) contiguous, dx's type
  float* fin;         // (Bt, H, N, P) fp32 contiguous
  int S, H, G, N, P, NK;  // NK: N rounded up to 8 whole k-steps of 8
  long long dx_sb, dx_ss, dx_sh, dA_sb, dA_ss, dA_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

// Shared memory, byte offsets, for inputs of ``es`` bytes an element:
// * craw (two chunks), braw, xraw, araw: a chunk's C, B, dx (the block's 16
//   columns) and dA as they lie, rows of C and B padded by 16 bytes, filled
//   by cp.async while the chunk before is multiplied;
// * bs: the B operand of the product with C, [NK / 4 chunk][BR row][16 B],
//   hi part then lo part: rows 0 .. 63 are B's steps, rows 64 .. 79 the
//   state^T's columns;
// * x: dx^T [L / 4 chunk][2 PB row][16 B]: rows 0 .. 15 the hi parts of
//   the block's columns, rows 16 .. 31 their lo parts, so one m64n32
//   product takes A . [hi | lo];
// * dec: the running log-decays of two chunks; xch: the partial sums the
//   warpgroups swap (the scores and C . state, then the second half of y).
constexpr int BR = L + PB;  // rows of bs

struct Smem {
  int nkp, raw, craw, braw, xraw, araw, bs, cb, x, xb, dec, xch, rx;
  size_t total;
  __host__ __device__ Smem(int NK, int es) {
    nkp = NK + 16 / es;             // elements in a raw row of C or B
    raw = L * nkp * es;
    craw = 0;
    braw = 2 * raw;
    xraw = braw + raw;
    araw = xraw + L * PB * es;
    bs = araw + L * 4;
    cb = BR * NK * 4;               // one part of bs
    x = bs + 2 * cb;
    xb = PB * L * 4;
    dec = x + 2 * xb;               // [2 chunks][cs, exp(cs), w][L]
    xch = dec + 2 * 3 * L * 4;
    rx = xch + THREADS * 20 * 4;
    total = rx + SHARE_RX;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One 16-byte chunk of a row, its first ``n`` elements from ``src`` and the
// rest zeros: by cp.async where the rows are 16-byte aligned, else element
// by element.
template <typename T, bool VEC>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const T* src, int n) {
  constexpr int E = 16 / sizeof(T);
  if constexpr (VEC) {
    cp_async16(dst, src, n * (int)sizeof(T));
  } else {
    T* d = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = e < n ? src[e] : T(0.f);
  }
}

// Stores x's TF32 parts, hi at ``hi`` and lo ``part`` bytes further on (a
// bf16 input is exact in TF32: lo = 0).
__device__ __forceinline__ void put4(uint8_t* hi, int part, float4 x) {
  uint4 lo;
  *reinterpret_cast<uint4*>(hi) = split4(
      make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                 __float_as_uint(x.z), __float_as_uint(x.w)), lo);
  *reinterpret_cast<uint4*>(hi + part) = lo;
}
__device__ __forceinline__ void put1(uint8_t* hi, int part, float x) {
  float h, l;
  split(x, h, l);
  *reinterpret_cast<float*>(hi) = h;
  *reinterpret_cast<float*>(hi + part) = l;
}

// A fragment of TF32 parts from four fp32 values.
__device__ __forceinline__ void frag(float x0, float x1, float x2, float x3,
                                     uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float x[4] = {x0, x1, x2, x3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    split(x[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

// The state (this thread's rows n of the accumulator layout, columns p)
// into bs's state^T rows, hi and lo parts.
__device__ __forceinline__ void store_state(uint8_t* bs, int part,
                                            const float (&s)[8], int NK,
                                            int n1) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n1 + (e & 2 ? 8 : 0);
    const int p = 8 * (e / 4) + 2 * t4 + (e & 1);
    if (n < NK)
      put1(bs + chunk_offset(n / 4, L + p, BR) + (n % 4) * 4, part,
                 s[e]);
  }
}

// A chunk's raw C (into buffer ``buf``), B, dx and dA, steps past ``len``
// and columns past N or P as zeros.
template <typename T, bool VEC>
__device__ __forceinline__ void fetch(uint8_t* smem, const Smem& lay,
                                      const Args& a, int buf, const T* Cg,
                                      const T* Bg, const T* dx,
                                      const float* dA, int c0, int len,
                                      int pn, int tid) {
  constexpr int E = 16 / sizeof(T);
  const int nch = a.NK / E;
  for (int i = tid; i < L * nch; i += THREADS) {
    const int r = i / nch, c = (i % nch) * E;
    const int n = r < len ? max(0, min(E, a.N - c)) : 0;
    const long long row = c0 + (r < len ? r : 0);
    const int o = (r * lay.nkp + c) * (int)sizeof(T);
    copy_chunk<T, VEC>(smem + lay.craw + buf * lay.raw + o, Cg + row * a.c_ss + c, n);
    copy_chunk<T, VEC>(smem + lay.braw + o, Bg + row * a.b_ss + c, n);
  }
  for (int i = tid; i < L * (PB / E); i += THREADS) {
    const int r = i / (PB / E), c = (i % (PB / E)) * E;
    const int n = r < len ? max(0, min(E, pn - c)) : 0;
    copy_chunk<T, VEC>(smem + lay.xraw + (r * PB + c) * (int)sizeof(T),
                       dx + (c0 + (r < len ? r : 0)) * a.dx_ss + c, n);
  }
  if (tid / 32 == SCAN_WARP) {  // the warp that scans them
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * (tid % 32) + j;
      cp_async4(smem + lay.araw + r * 4,
                dA + (c0 + (r < len ? r : 0)) * a.dA_ss, r < len ? 4 : 0);
    }
  }
}

// Running log-decays of one chunk from its raw dA (past its end, 0), by
// SCAN_WARP once its copies have landed: cs, exp(cs) and exp(cs_last - cs).
__device__ __forceinline__ void scan(const uint8_t* smem, const Smem& lay,
                                     float* cs) {
  const int lane = threadIdx.x % 32, s0 = 2 * lane;
  cp_wait<0>();
  __syncwarp();
  const float* ar = reinterpret_cast<const float*>(smem + lay.araw);
  const float x0 = ar[s0], x1 = ar[s0 + 1];
  float incl = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float c_0 = excl + x0, c_1 = c_0 + x1;
  const float last = __shfl_sync(0xffffffffu, c_1, 31);
  float* ecs = cs + L;
  float* w = ecs + L;
  cs[s0] = c_0;
  cs[s0 + 1] = c_1;
  ecs[s0] = expf(c_0);
  ecs[s0 + 1] = expf(c_1);
  w[s0] = expf(last - c_0);
  w[s0 + 1] = expf(last - c_1);
}

// One k-step of the product with C: the 64 score columns and C . state's
// 16 (SSD_SHARE: rows 48 .. 79 of bs, a quarter of the scores and C .
// state, into the first 16 sums).
__device__ __forceinline__ void score_mma(float (&d)[40],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
#if SSD_SHARE
  mma_rs<TF32, 32>(*reinterpret_cast<float(*)[16]>(&d[0]), a,
                   desc_at(b, (L - PB) * 16), 1);
#else
  mma_rs<TF32, 80>(d, a, b, 1);
#endif
}

#if SSD_SHARE == 2
// The exchange of shared scores, timed: this thread's 4 of the block's 1024
// score sums into each other block of the cluster (rank = blockIdx.x),
// a cluster barrier, and the 12 values received read into ``mine``. The
// barrier's second phase (arrived at here, waited for before the next
// chunk's stores) keeps a block from overwriting values not yet read.
__device__ __forceinline__ void share_scores(uint8_t* rx, float (&mine)[20],
                                             bool first) {
  float* r = reinterpret_cast<float*>(rx);
  const uint32_t me = blockIdx.x % 4;
  if (!first) cluster_wait();
#pragma unroll
  for (int k = 1; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_remote(r + ((3 - k) * 4 + e) * THREADS + threadIdx.x,
                   (me + k) % 4, mine[e]);
  cluster_sync();
#pragma unroll
  for (int i = 0; i < 12; ++i) mine[4 + i] += r[i * THREADS + threadIdx.x];
  cluster_arrive();
}
#endif

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Args a) {
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const Smem lay(a.NK, sizeof(T));
  const int N = a.N, P = a.P, NK = a.NK, KS = a.NK / 8;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, t4 = lane % 4;
  const int pq = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int p0 = pq * PB, pn = min(PB, P - p0), g = h / (a.H / a.G);
  const T* dx = static_cast<const T*>(a.dx) + bi * a.dx_sb + h * a.dx_sh + p0;
  const float* dA = a.dA + bi * a.dA_sb + h * a.dA_sh;
  const T* Bg = static_cast<const T*>(a.B) + bi * a.b_sb + g * a.b_sg;
  const T* Cg = static_cast<const T*>(a.C) + bi * a.c_sb + g * a.c_sg;
  const long long y_ss = (long long)a.H * P;
  T* yp = static_cast<T*>(a.y) + (long long)bi * a.S * y_ss + (long long)h * P + p0;
  const long long st_off = ((long long)bi * a.H + h) * N * P + p0;
  float* xch = reinterpret_cast<float*>(smem + lay.xch);
  // rows of this thread in the m64 accumulator layout
  const int l1 = 16 * warp + lane / 4, l2 = l1 + 8;

  if (a.S > 0)
    fetch<T, VEC>(smem, lay, a, 0, Cg, Bg, dx, dA, 0, min(L, a.S), pn, tid);
  cp_commit();
  float* const dec = reinterpret_cast<float*>(smem + lay.dec);
  if (warp + 4 * wg == SCAN_WARP && a.S > 0) scan(smem, lay, dec);

  // The state: warpgroup wg keeps rows n1 = 64 wg + l1 and n1 + 8, columns
  // 8 (e / 4) + 2 t4 (+ 1) of the block's 16 (N <= 128: 64 rows each).
  const int n1 = 64 * wg + l1;
  float st[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = n1 + (e & 2 ? 8 : 0);
    const int p = 8 * (e / 4) + 2 * t4 + (e & 1);
    st[e] = a.init && n < N && p < pn
                ? a.init[st_off + (long long)n * P + p] : 0.f;
  }
  store_state(smem + lay.bs, lay.cb, st, NK, n1);

  // wgmma descriptors: bs (80 rows), dx^T (32 rows: N = 32 reads hi and
  // lo, N = 16 hi); k-step ks of bs lies ks * 2 * BR chunks on, of dx^T
  // ks * 4 * PB.
  const uint64_t dB = desc(smem + lay.bs, BR * 16);
  const uint64_t dX = desc(smem + lay.x, 2 * PB * 16);
  const int cb = lay.cb;

  for (int c0 = 0, ci = 0; c0 < a.S; c0 += L, ci ^= 1) {
    const int len = min(L, a.S - c0);
    const float* cs = dec + ci * 3 * L;
    const float* ecs = cs + L;  // exp(cs_l)
    const float* w = ecs + L;   // exp(cs_last - cs_s)
    STAMP(0);
    cp_wait<0>();
    __syncthreads();  // [R] the chunk's raw inputs have landed
    STAMP(1);

    // B into bs (lanes on consecutive steps: the raw rows are 16 bytes
    // longer than a multiple of 128, so neither side conflicts), dx into
    // dx^T with step s at position 0 2 4 6 1 3 5 7 of its 8.
    {
      const T* br = reinterpret_cast<const T*>(smem + lay.braw);
      for (int i = tid; i < L * NK / 4; i += THREADS) {
        const int l = i % L, c = i / L;
        // both parts in bf16 too: the products read bs's lo part for the
        // state's columns
        put4(smem + lay.bs + chunk_offset(c, l, BR), cb,
                   ld4(br + l * lay.nkp + 4 * c));
      }
      const T* xr = reinterpret_cast<const T*>(smem + lay.xraw);
      for (int i = tid; i < L * PB / 4; i += THREADS) {
        const int s = i / (PB / 4), pc = 4 * (i % (PB / 4));
        const float4 v = ld4(xr + s * PB + pc);
        const float xe[4] = {v.x, v.y, v.z, v.w};
        const int k = (s & ~7) + ((s & 1) ? 4 : 0) + ((s & 7) >> 1);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put1(smem + lay.x + chunk_offset(k / 4, pc + e, 2 * PB) +
                         (k % 4) * 4, PB * 16, xe[e]);
      }
    }
    fence_smem_to_async();
    __syncthreads();  // [A] B, dx^T, the decays and the state are staged
    STAMP(2);

    // The next chunk's inputs fly while this one is multiplied (its raw
    // B and dx are consumed, dA was scanned; its C buffer was last read a
    // chunk ago).
    if (c0 + L < a.S)
      fetch<T, VEC>(smem, lay, a, ci ^ 1, Cg, Bg, dx, dA, c0 + L,
                    min(L, a.S - c0 - L), pn, tid);
    cp_commit();

    // Both warpgroups run the same products on their own parts (wgmma in
    // a branch on the warpgroup would be serialised). C is the A operand,
    // from registers, split into its TF32 parts once per k-step, of one
    // m64n80 product: the 64 score columns s and the 16 columns p of C .
    // state; warpgroup wg takes the k-steps wg * KS / 2 .. + KS / 2, in
    // batches of KB k-steps, two batches in flight.
    float sc[40];
#pragma unroll
    for (int i = 0; i < 40; ++i) sc[i] = 0.f;
    const T* cr = reinterpret_cast<const T*>(smem + lay.craw + ci * lay.raw);
    auto cfrag = [&](int ks, uint32_t (&hi)[KB][4], uint32_t (&lo)[KB][4]) {
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int n = 8 * (ks + j) + t4;
        frag(to_f(cr[l1 * lay.nkp + n]), to_f(cr[l2 * lay.nkp + n]),
             to_f(cr[l1 * lay.nkp + n + 4]), to_f(cr[l2 * lay.nkp + n + 4]),
             hi[j], lo[j]);
      }
    };
    auto issue = [&](int ks, const uint32_t (&hi)[KB][4],
                     const uint32_t (&lo)[KB][4]) {
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int off = (ks + j) * 2 * BR * 16;
        score_mma(sc, hi[j], desc_at(dB, off));
        score_mma(sc, hi[j], desc_at(dB, cb + off));
        if constexpr (F32) score_mma(sc, lo[j], desc_at(dB, off));
      }
    };
    const int k0 = wg * (KS / 2);
    uint32_t ah[KB][4], al[KB][4], bh[KB][4], bl[KB][4];
    cfrag(k0, ah, al);
    pin<40>(sc);
    fence();
    issue(k0, ah, al);
    commit();
    // Two batches in flight: a batch's fragments are built while the one
    // before multiplies, into the registers of the one before that, once
    // it is done. The trip count is the same in both warpgroups, and KS / 2
    // is a multiple of 2 KB, so the last batch is in bh, bl.
    for (int j = KB; j < KS / 2; j += 2 * KB) {
      cfrag(k0 + j, bh, bl);
      fence();
      issue(k0 + j, bh, bl);
      commit();
      wait<1>();
      pin<KB>(ah);
      pin<KB>(al);
      if (j + KB < KS / 2) {
        cfrag(k0 + j + KB, ah, al);
        fence();
        issue(k0 + j + KB, ah, al);
        commit();
        wait<1>();
        pin<KB>(bh);
        pin<KB>(bl);
      }
    }
    // (the last batch may still fly)
    STAMP(3);

    // state = state exp(cs_last) + (B w)^T dx over this warpgroup's 64
    // rows: A = (B w)^T from registers, its steps in dx^T's order, built
    // while the last batch multiplies
    uint32_t fh[8][4], fl[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int ns[2] = {n1, n1 + 8}, ss[2] = {8 * ks + 2 * t4, 8 * ks + 2 * t4 + 1};
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = ns[q & 1], s = ss[q >> 1];
        float x = 0.f;
        if (n < NK) {
          const uint8_t* pb =
              smem + lay.bs + chunk_offset(n / 4, s, BR) + (n % 4) * 4;
          x = *reinterpret_cast<const float*>(pb);
          if constexpr (F32) x += *reinterpret_cast<const float*>(pb + cb);
        }
        v[q] = x * w[s];
      }
      frag(v[0], v[1], v[2], v[3], fh[ks], fl[ks]);
    }
    // hi . [X_hi | X_lo] as one m64n32 product, lo . X_hi as one m64n16
    const float total = expf(cs[L - 1]);
    float sw[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sw[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) st[e] *= total;
    pin<16>(sw);
    fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int xo = ks * 4 * PB * 16;
      mma_rs<TF32, 32>(sw, fh[ks], desc_at(dX, xo), 1);
      mma_rs<TF32, 16>(st, fl[ks], desc_at(dX, xo), 1);
    }
    commit();
    wait<1>();  // the scores and C . state are done; the state flies
    pin<KB>(bh);
    pin<KB>(bl);
    pin<40>(sc);
    STAMP(4);
    // Swap partial sums: warpgroup wg keeps score columns 32 wg .. + 32
    // and C . state's columns 8 wg .. + 8 (column groups of 8: G[wg] =
    // {4 wg .. 4 wg + 3, 8 + wg}); it sends the other warpgroup's groups.
    float mine[20];
    {
      float* xo = xch + ((1 - wg) * 128 + wt) * 20;
      const float* xi = xch + (wg * 128 + wt) * 20;
#pragma unroll
      for (int k = 0; k < 5; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g0 = k < 4 ? k : 8, g1 = k < 4 ? 4 + k : 9;
          xo[4 * k + e] = wg == 0 ? sc[4 * g1 + e] : sc[4 * g0 + e];
          mine[4 * k + e] = wg == 0 ? sc[4 * g0 + e] : sc[4 * g1 + e];
        }
      __syncthreads();  // [E] the partial sums are swapped
#pragma unroll
      for (int i = 0; i < 20; ++i) mine[i] += xi[i];
    }
#if SSD_SHARE == 2
    share_scores(smem + lay.rx, mine, c0 == 0);
#endif
    STAMP(5);

    // Decayed causal scores M[l][s] = sc exp(cs_l - cs_s) for s <= l (the
    // mask before the exp), then y_part = M dx over this warpgroup's steps
    // + exp(cs_l) (its columns of C . state), while the state multiplies.
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int l = i & 2 ? l2 : l1;
      const int s = 32 * wg + 8 * (i / 4) + 2 * t4 + (i & 1);
      mine[i] = s <= l ? mine[i] * expf(cs[l] - cs[s]) : 0.f;
    }
    float yv[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float o = ecs[e & 2 ? l2 : l1] * mine[16 + e];
      yv[e] = wg == 0 ? o : 0.f;
      yv[4 + e] = wg == 1 ? o : 0.f;
    }
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      frag(mine[4 * i], mine[4 * i + 2], mine[4 * i + 1], mine[4 * i + 3],
           mh[i], ml[i]);
    float yw[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) yw[e] = 0.f;
    pin<8>(yv);
    pin<16>(yw);
    fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int xo = (4 * wg + i) * 4 * PB * 16;
      mma_rs<TF32, 32>(yw, mh[i], desc_at(dX, xo), 1);
      mma_rs<TF32, 16>(yv, ml[i], desc_at(dX, xo), 1);
    }
    commit();
    wait<1>();  // the state is done; M dx flies
    pin<8>(st);
    pin<16>(sw);
    // + the n32 product's hi and lo halves (same rows, columns 16 apart)
#pragma unroll
    for (int e = 0; e < 8; ++e) st[e] += sw[e] + sw[e + 8];
    pin<8>(fh);
    pin<8>(fl);
    store_state(smem + lay.bs, cb, st, NK, n1);  // C . state was read by [E]
    wait<0>();
    pin<8>(yv);
    pin<16>(yw);
    pin<4>(mh);
    pin<4>(ml);
    STAMP(6);
#pragma unroll
    for (int e = 0; e < 8; ++e) yv[e] += yw[e] + yw[e + 8];
    __syncthreads();  // [B] the swapped sums are read
    if (wg == 1) {
      *reinterpret_cast<float4*>(xch + wt * 8) = make_float4(yv[0], yv[1], yv[2], yv[3]);
      *reinterpret_cast<float4*>(xch + wt * 8 + 4) = make_float4(yv[4], yv[5], yv[6], yv[7]);
    }
    fence_smem_to_async();
    __syncthreads();  // [C] the new state^T and the second half of y
    if (warp + 4 * wg == SCAN_WARP && c0 + L < a.S)
      scan(smem, lay, dec + (ci ^ 1) * 3 * L);  // the next chunk's decays
    if (wg == 0) {
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int l = e & 2 ? l2 : l1;
        const int p = 8 * (e / 4) + 2 * t4;
        if (l >= len || p >= pn) continue;
        const float y0 = yv[e] + xch[wt * 8 + e];
        const float y1 = yv[e + 1] + xch[wt * 8 + e + 1];
        T* out = yp + (c0 + l) * y_ss + p;
        if constexpr (F32) {
          *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    STAMP(7);
  }
  cp_wait<0>();
#if SSD_SHARE == 2
  if (a.S > 0) cluster_wait();  // the last chunk's second phase
#endif

#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const int n = n1 + (e & 2 ? 8 : 0);
    const int p = 8 * (e / 4) + 2 * t4;
    if (n < N && p < pn)
      *reinterpret_cast<float2*>(a.fin + st_off + (long long)n * P + p) =
          make_float2(st[e], st[e + 1]);
  }
}

template <typename T, bool VEC>
cudaError_t launch(const Args& a, int Bt, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((a.P + PB - 1) / PB, a.H, Bt);
#if SSD_SHARE == 2
  if (grid.x != 4) return cudaErrorInvalidValue;  // P = 64 only
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Smem(a.NK, sizeof(T)).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 4;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ssd_scan_kernel<T, VEC>, a);
  if (err != cudaSuccess) return err;
#else
  ssd_scan_kernel<T, VEC><<<grid, THREADS, Smem(a.NK, sizeof(T)).total,
                                 stream>>>(a);
#endif
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_vec(const Args& a, int Bt, cudaStream_t stream) {
  // 16-byte copies need 16-byte aligned rows: aligned bases, and strides in
  // whole 16-byte chunks (P and N need not be)
  constexpr int E = 16 / sizeof(T);
  const bool vec =
      reinterpret_cast<uintptr_t>(a.dx) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.B) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.C) % 16 == 0 && a.dx_sb % E == 0 &&
      a.dx_ss % E == 0 && a.dx_sh % E == 0 && a.b_sb % E == 0 &&
      a.b_ss % E == 0 && a.b_sg % E == 0 && a.c_sb % E == 0 &&
      a.c_ss % E == 0 && a.c_sg % E == 0;
  return vec ? launch<T, true>(a, Bt, stream)
             : launch<T, false>(a, Bt, stream);
}

int padded(int N) { return (N + 63) / 64 * 64; }

}  // namespace

// Shared memory one block needs for a state of N rows in fp32 (any P: a
// block owns 16 columns; bf16 needs less); the wrapper refuses shapes above
// ssd_scan_max_smem().
extern "C" long long ssd_scan_smem_bytes(int N) {
  return (long long)Smem(padded(N), 4).total;
}
extern "C" long long ssd_scan_max_smem() { return MAX_SMEM; }

#ifdef SSD_STAMPS
// The stamps of the last launch, [chunk < 64][phase end < 8] clock64()
// values (phases as marked by STAMP in the kernel).
extern "C" int ssd_scan_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, stamps, sizeof(stamps));
}
#endif

// dtype (of dx, B, C and y): 0 = float32, 1 = bfloat16; dA, init and fin are
// float32. strides: 12 element strides, the batch, sequence and head (group)
// strides of dx, dA, B and C in that order; the last axes of dx, B and C are
// contiguous. init may be null (a zero state). y is (Bt, S, H, P) and init /
// fin (Bt, H, N, P), all contiguous. Returns the launch's cudaError_t.
extern "C" int ssd_scan_fwd(const void* dx, const float* dA, const void* B,
                            const void* C, const float* init, void* y,
                            float* fin, int dtype, int Bt, int S, int H, int G,
                            int N, int P, const long long* strides,
                            void* stream) {
  if (Bt <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N % 4 != 0 ||
      N > MAX_N || P <= 0 || P % 4 != 0 || S < 0 ||
      Smem(padded(N), dtype == 1 ? 2 : 4).total > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  Args a;
  a.dx = dx; a.dA = dA; a.B = B; a.C = C; a.init = init; a.y = y; a.fin = fin;
  a.S = S; a.H = H; a.G = G; a.N = N; a.P = P; a.NK = padded(N);
  a.dx_sb = strides[0]; a.dx_ss = strides[1]; a.dx_sh = strides[2];
  a.dA_sb = strides[3]; a.dA_ss = strides[4]; a.dA_sh = strides[5];
  a.b_sb = strides[6]; a.b_ss = strides[7]; a.b_sg = strides[8];
  a.c_sb = strides[9]; a.c_ss = strides[10]; a.c_sg = strides[11];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_vec<float>(a, Bt, st);
  if (dtype == 1) return by_vec<__nv_bfloat16>(a, Bt, st);
  return cudaErrorInvalidValue;
}
