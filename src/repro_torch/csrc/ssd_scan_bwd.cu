// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a): the gradient
// of csrc/ssd_scan.cu's (y, final state) for dx, dA, B, C and the initial
// state, fp32 or bf16 in, fp32 sums, ddx / dB / dC in the input's type, ddA
// and the initial state's gradient in fp32.
//
// The Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan) has no
// backward: the JAX model differentiates XLA's ssd_chunked
// (src/repro/models/ssm.py). This kernel computes that gradient, as the
// flash backward does for attention. Per (batch, head h) and chunk of
// L = 64 steps (the forward's chunk; the last one ragged, its missing steps
// read as dA = 0, dx = B = C = dy = 0), with cs the inclusive running sum
// of dA in the chunk, S0 the state entering it, dS1 the gradient of the
// state leaving it, E_ts = exp(cs_t - cs_s) for s <= t (else 0),
// M = (C B^T) o E, G = dy dx^T, w_s = exp(cs_L - cs_s):
//   ddx = M^T dy + w o (B dS1)
//   dC  = (G o E) B + exp(cs) o (dy S0^T)
//   dB  = (G o E)^T C + w o (dx dS1^T)       (summed over a group's heads)
//   dS0 = exp(cs_L) dS1 + (C o exp(cs))^T dy  (the previous chunk's dS1)
//   dcs = rowsum(Z) - colsum(Z) + rowsum(y_off o dy) - W, Z = G o M,
//         y_off = exp(cs) o (C S0), W_s = w_s sum_p ((B dS1) o dx)_sp,
//         and dcs_L += sum(W) + exp(cs_L) <S0, dS1>
//   ddA = the reverse running sum of dcs within the chunk.
// kernels/ssd_scan.py's plain_backward is the same math in PyTorch.
//
// Three kernels, one launch of the wrapper:
// 1. bwd_states: one block per 16 columns of P of a (batch, head) walks the
//    chunks forward, writing the state entering each (recomputed from dx, B
//    and dA: nothing extra is kept by the forward, so serving's launch is
//    unchanged), then back, writing the gradient of the state leaving each
//    and, at the start, the initial state's gradient. Each thread carries
//    its 8 of the block's N x 16 state elements in registers.
// 2. bwd_chunk: one block per (chunk, head, batch) computes the chunk's
//    gradients from its C, B, dA and, 32 columns of P at a time, dx, dy, S0
//    and dS1, all in shared memory as fp32; every product is a register
//    tile of 4 rows x (2, 4 or N / 16) columns a thread on the CUDA cores
//    (rows tr + 16 i, columns tc + 16 j, leading dimensions padded to odd
//    strides, so no load conflicts); the row and column sums of G o M,
//    which cancel in dcs, in fp64; dB and dC go per head into fp32
//    scratch.
// 3. bwd_group_sum: each group's dB and dC summed over its heads in head
//    order, rounded once to the input's type.
// Nothing is summed by atomics: two calls on the same inputs give the same
// bits (a restarted training run stays bit-identical).
//
// What bounds it on an H100 at mamba2-1.3b's training shape (B = 8,
// S = 512, H = 64, P = 64, N = 128, bf16): ~110 MB of least traffic
// (0.033 ms at 3.35 TB/s) and ~4 x the forward's products. This first
// version runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s at most, a
// register tile loading ~0.4 shared values a FMA) and moves the chunk
// states through device memory (2 x 134 MB at that shape): the operations,
// not the bytes, set its time. The tensor cores (the forward's wgmma
// helpers in hopper.cuh) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int L = 64;            // steps per chunk: the forward's
constexpr int THREADS = 256;
constexpr int PB = 16;           // columns of P a bwd_states block owns
constexpr int PT = 32;           // columns of P a bwd_chunk block holds
constexpr int MAX_N = 128;
constexpr int MAX_SMEM = 232448; // a block's shared memory on the H100
constexpr int EPT = MAX_N * PB / THREADS;  // state elements a thread
constexpr int LDL = L + 1;       // padded leading dimensions (odd)
constexpr int LDP = PT + 1;

struct Args {
  const void* dx;
  const float* dA;
  const void* B;
  const void* C;
  const float* init;    // (Bt, H, N, P) fp32 or null for zeros
  const void* dy;
  const float* dstate;  // (Bt, H, N, P) fp32 or null for zeros
  void* ddx;            // (Bt, S, H, P) contiguous, the input's type
  float* ddA;           // (Bt, S, H) contiguous
  void* dB;             // (Bt, S, G, N) contiguous, the input's type
  void* dC;
  float* dinit;         // (Bt, H, N, P) or null
  float* states;        // (Bt, NC, H, N, P): the state entering each chunk
  float* dstates;       // (Bt, NC, H, N, P): the gradient of the one leaving
  float* dBh;           // (Bt, S, H, N): each head's dB and dC
  float* dCh;
  int S, H, G, N, P, NC;
  long long dx_sb, dx_ss, dx_sh, dA_sb, dA_ss, dA_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg, dy_sb, dy_ss, dy_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The running log-decays of one chunk from its 64 raw dA (0 past its end),
// by one warp, each lane two steps (the forward kernel's order of sums):
// cs, exp(cs) and w = exp(cs_last - cs).
__device__ __forceinline__ void scan_chunk(const float* a, float* cs,
                                           float* ecs, float* w) {
  const int lane = threadIdx.x % 32, s0 = 2 * lane;
  const float x0 = a[s0], x1 = a[s0 + 1];
  float incl = x0 + x1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + x0, c1 = c0 + x1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  cs[s0] = c0;
  cs[s0 + 1] = c1;
  ecs[s0] = expf(c0);
  ecs[s0 + 1] = expf(c1);
  w[s0] = expf(last - c0);
  w[s0 + 1] = expf(last - c1);
}

// acc[i][j] += sum_{k < K} A(r_i, k) Bm(c_j, k) over shared memory, rows
// r_i = tr + 16 i, columns c_j = tc + 16 j, A(r, k) = A[r ar + k ak] and
// Bm(c, k) = Bm[c bc + k bk]: the strides say which operand is read
// transposed.
template <int TI, int TJ>
__device__ __forceinline__ void mm(float (&acc)[TI][TJ], const float* A,
                                   int ar, int ak, const float* Bm, int bc,
                                   int bk, int K, int tr, int tc) {
  for (int k = 0; k < K; ++k) {
    float av[TI], bv[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i) av[i] = A[(tr + 16 * i) * ar + k * ak];
#pragma unroll
    for (int j = 0; j < TJ; ++j) bv[j] = Bm[(tc + 16 * j) * bc + k * bk];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The sum over the 16 lanes of a half warp (the threads of one tile row
// tr), by a fixed tree.
template <typename F>
__device__ __forceinline__ F half_warp_sum(F x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1 and 2: block (P / 16, H, Bt). Thread element k is e = tid + 256 k
// of the block's N x 16 slice, row n = e / 16, column p = e % 16.
template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_states(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int N = a.N, P = a.P, tid = threadIdx.x;
  float* sv = sm;               // [L][N]: B, then C
  float* sx = sv + L * N;       // [L][PB]: dx, then dy
  float* sa = sx + L * PB;      // [L]: raw dA
  float* cs = sa + L;
  float* ecs = cs + L;
  float* w = ecs + L;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, bi = blockIdx.z;
  const int pn = min(PB, P - p0), g = h / (a.H / a.G);
  const T* dx = static_cast<const T*>(a.dx) + bi * a.dx_sb + h * a.dx_sh + p0;
  const T* dy = static_cast<const T*>(a.dy) + bi * a.dy_sb + h * a.dy_sh + p0;
  const float* dA = a.dA + bi * a.dA_sb + h * a.dA_sh;
  const T* Bg = static_cast<const T*>(a.B) + bi * a.b_sb + g * a.b_sg;
  const T* Cg = static_cast<const T*>(a.C) + bi * a.c_sb + g * a.c_sg;
  const long long hs = (long long)N * P;  // one head's state
  const long long head = ((long long)bi * a.H + h) * hs + p0;
  int en[EPT], ep[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    en[k] = (tid + THREADS * k) / PB;
    ep[k] = (tid + THREADS * k) % PB;
  }
  // chunk c's slice of states / dstates
  const long long at0 = (long long)bi * a.NC * a.H * hs + (long long)h * hs + p0;
  const long long chunk_stride = (long long)a.H * hs;

  float st[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    st[k] = a.init && en[k] < N && ep[k] < pn
                ? a.init[head + (long long)en[k] * P + ep[k]] : 0.f;
  for (int c = 0; c < a.NC; ++c) {
    const int c0 = c * L, len = min(L, a.S - c0);
    for (int i = tid; i < L * N; i += THREADS) {
      const int l = i / N, n = i % N;
      sv[i] = l < len ? to_f(Bg[(c0 + l) * a.b_ss + n]) : 0.f;
    }
    for (int i = tid; i < L * PB; i += THREADS) {
      const int l = i / PB, p = i % PB;
      sx[i] = l < len && p < pn ? to_f(dx[(c0 + l) * a.dx_ss + p]) : 0.f;
    }
    if (tid < L) sa[tid] = tid < len ? dA[(c0 + tid) * a.dA_ss] : 0.f;
    __syncthreads();
    if (tid < 32) scan_chunk(sa, cs, ecs, w);
    float* out = a.states + at0 + c * chunk_stride;
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (en[k] < N && ep[k] < pn) out[(long long)en[k] * P + ep[k]] = st[k];
    __syncthreads();
    const float tot = expf(cs[L - 1]);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (en[k] >= N) continue;
      float acc = 0.f;
      for (int l = 0; l < L; ++l)
        acc = fmaf(sv[l * N + en[k]] * w[l], sx[l * PB + ep[k]], acc);
      st[k] = st[k] * tot + acc;
    }
    __syncthreads();
  }

  float ds[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    ds[k] = a.dstate && en[k] < N && ep[k] < pn
                ? a.dstate[head + (long long)en[k] * P + ep[k]] : 0.f;
  for (int c = a.NC - 1; c >= 0; --c) {
    const int c0 = c * L, len = min(L, a.S - c0);
    for (int i = tid; i < L * N; i += THREADS) {
      const int l = i / N, n = i % N;
      sv[i] = l < len ? to_f(Cg[(c0 + l) * a.c_ss + n]) : 0.f;
    }
    for (int i = tid; i < L * PB; i += THREADS) {
      const int l = i / PB, p = i % PB;
      sx[i] = l < len && p < pn ? to_f(dy[(c0 + l) * a.dy_ss + p]) : 0.f;
    }
    if (tid < L) sa[tid] = tid < len ? dA[(c0 + tid) * a.dA_ss] : 0.f;
    __syncthreads();
    if (tid < 32) scan_chunk(sa, cs, ecs, w);
    float* out = a.dstates + at0 + c * chunk_stride;
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (en[k] < N && ep[k] < pn) out[(long long)en[k] * P + ep[k]] = ds[k];
    __syncthreads();
    const float tot = expf(cs[L - 1]);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (en[k] >= N) continue;
      float acc = 0.f;
      for (int l = 0; l < L; ++l)
        acc = fmaf(sv[l * N + en[k]] * ecs[l], sx[l * PB + ep[k]], acc);
      ds[k] = ds[k] * tot + acc;
    }
    __syncthreads();
  }
  if (a.dinit) {
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (en[k] < N && ep[k] < pn)
        a.dinit[head + (long long)en[k] * P + ep[k]] = ds[k];
  }
}

// Shared memory of bwd_chunk, in floats, for NR = N rounded up to 16.
struct ChunkSmem {
  int ldn, c, b, m, g, x, y, s0, d, a, cs, ecs, w, red, rowz, row, ip, total;
  __host__ __device__ explicit ChunkSmem(int NR) {
    ldn = NR + 1;
    c = 0;                    // [L][ldn] C
    b = c + L * ldn;          // [L][ldn] B
    m = b + L * ldn;          // [L][LDL] M = (C B^T) o E
    g = m + L * LDL;          // [L][LDL] G o E
    x = g + L * LDL;          // [L][LDP] dx, 32 columns of P
    y = x + L * LDP;          // [L][LDP] dy
    s0 = y + L * LDP;         // [NR][LDP] S0
    d = s0 + NR * LDP;        // [NR][LDP] dS1
    a = d + NR * LDP;         // [L] raw dA
    cs = a + L;
    ecs = cs + L;
    w = ecs + L;
    red = w + L;              // [16][L] doubles: Z's column sums by row tile
    rowz = red + 2 * 16 * L;  // [L] doubles: Z's row sums
    row = rowz + 2 * L;       // [2][L] y_off . dy, W
    ip = row + 2 * L;         // [8] <S0, dS1> by warp
    total = ip + 8;
  }
};

// Pass 3: block (NC, H, Bt); NJ = N / 16 rounded up, the column tiles of
// N a thread owns.
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS, 1) bwd_chunk(Args a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NR = 16 * NJ;
  const ChunkSmem lay(NR);
  const int ldn = lay.ldn;
  float *sC = sm + lay.c, *sB = sm + lay.b, *sM = sm + lay.m,
        *sG = sm + lay.g, *sX = sm + lay.x, *sY = sm + lay.y,
        *sS0 = sm + lay.s0, *sD = sm + lay.d, *sa = sm + lay.a,
        *cs = sm + lay.cs, *ecs = sm + lay.ecs, *w = sm + lay.w,
        *row = sm + lay.row, *sip = sm + lay.ip;
  // (8-byte aligned: every offset before them is even)
  double *red = reinterpret_cast<double*>(sm + lay.red),
         *rowz = reinterpret_cast<double*>(sm + lay.rowz);
  const int N = a.N, P = a.P, tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int c0 = c * L, len = min(L, a.S - c0), g = h / (a.H / a.G);
  const T* dx = static_cast<const T*>(a.dx) + bi * a.dx_sb + h * a.dx_sh;
  const T* dy = static_cast<const T*>(a.dy) + bi * a.dy_sb + h * a.dy_sh;
  const float* dA = a.dA + bi * a.dA_sb + h * a.dA_sh;
  const T* Bg = static_cast<const T*>(a.B) + bi * a.b_sb + g * a.b_sg;
  const T* Cg = static_cast<const T*>(a.C) + bi * a.c_sb + g * a.c_sg;
  const long long st_off =
      (((long long)bi * a.NC + c) * a.H + h) * (long long)N * P;

  for (int i = tid; i < L * NR; i += THREADS) {
    const int l = i / NR, n = i % NR;
    const bool in = l < len && n < N;
    sC[l * ldn + n] = in ? to_f(Cg[(c0 + l) * a.c_ss + n]) : 0.f;
    sB[l * ldn + n] = in ? to_f(Bg[(c0 + l) * a.b_ss + n]) : 0.f;
  }
  if (tid < L) sa[tid] = tid < len ? dA[(c0 + tid) * a.dA_ss] : 0.f;
  __syncthreads();
  if (tid < 32) scan_chunk(sa, cs, ecs, w);
  __syncthreads();

  // M = (C B^T) o E over this thread's (t, s) = (tr + 16 i, tc + 16 j)
  {
    float cb[4][4] = {};
    mm<4, 4>(cb, sC, ldn, 1, sB, ldn, 1, NR, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tr + 16 * i, s = tc + 16 * j;
        sM[t * LDL + s] = s <= t ? cb[i][j] * expf(cs[t] - cs[s]) : 0.f;
      }
  }

  float gacc[4][4] = {};   // G[t][s] = dy_t . dx_s
  float dca[4][NJ] = {};   // dy S0^T, then dC
  float dba[4][NJ] = {};   // dx dS1^T, then dB
  float yoff[4] = {}, wrow[4] = {}, ip = 0.f;
  for (int p0 = 0; p0 < P; p0 += PT) {
    __syncthreads();  // M is stored; the last tile is read
    for (int i = tid; i < L * PT; i += THREADS) {
      const int l = i / PT, pp = i % PT;
      const bool in = l < len && p0 + pp < P;
      sX[l * LDP + pp] = in ? to_f(dx[(c0 + l) * a.dx_ss + p0 + pp]) : 0.f;
      sY[l * LDP + pp] = in ? to_f(dy[(c0 + l) * a.dy_ss + p0 + pp]) : 0.f;
    }
    for (int i = tid; i < NR * PT; i += THREADS) {
      const int n = i / PT, pp = i % PT;
      const bool in = n < N && p0 + pp < P;
      const long long o = st_off + (long long)n * P + p0 + pp;
      sS0[n * LDP + pp] = in ? a.states[o] : 0.f;
      sD[n * LDP + pp] = in ? a.dstates[o] : 0.f;
    }
    __syncthreads();
    mm<4, 4>(gacc, sY, LDP, 1, sX, LDP, 1, PT, tr, tc);
    mm<4, NJ>(dca, sY, LDP, 1, sS0, LDP, 1, PT, tr, tc);
    mm<4, NJ>(dba, sX, LDP, 1, sD, LDP, 1, PT, tr, tc);
    // ddx[s][p] = sum_t M[t][s] dy[t][p] + w_s (B dS1)[s][p]
    float mdy[4][2] = {}, bds[4][2] = {}, cs0[4][2] = {};
    mm<4, 2>(mdy, sM, 1, LDL, sY, 1, LDP, L, tr, tc);
    mm<4, 2>(bds, sB, ldn, 1, sD, 1, LDP, NR, tr, tc);
    mm<4, 2>(cs0, sC, ldn, 1, sS0, 1, LDP, NR, tr, tc);  // C S0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int pp = tc + 16 * j;
        wrow[i] = fmaf(bds[i][j], sX[s * LDP + pp], wrow[i]);
        yoff[i] = fmaf(cs0[i][j], sY[s * LDP + pp], yoff[i]);
        if (s < len && p0 + pp < P)
          put(static_cast<T*>(a.ddx) +
                  (((long long)bi * a.S + c0 + s) * a.H + h) * P + p0 + pp,
              fmaf(w[s], bds[i][j], mdy[i][j]));
      }
    }
    for (int i = tid; i < NR * PT; i += THREADS)
      ip = fmaf(sS0[(i / PT) * LDP + i % PT], sD[(i / PT) * LDP + i % PT], ip);
  }

  // Z = G o M and G o E over this thread's (t, s); Z's row sums over the
  // half warp of row tile tr, its column sums through shared memory, both
  // in fp64: they are large and mostly cancel in dcs, and in fp32 they
  // would cost the A_log gradient at mamba2-1.3b's decays more than the
  // card-vs-CPU check's 1e-4 of its scale
  double zr[4] = {}, zc[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = tr + 16 * i, s = tc + 16 * j;
      const float z = gacc[i][j] * sM[t * LDL + s];
      zr[i] += z;
      zc[j] += z;
      sG[t * LDL + s] = s <= t ? gacc[i][j] * expf(cs[t] - cs[s]) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[tr * L + tc + 16 * j] = zc[j];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double rz = half_warp_sum(zr[i]);
    const float ry = half_warp_sum(yoff[i]), rw = half_warp_sum(wrow[i]);
    if (tc == 0) {
      const int t = tr + 16 * i;
      rowz[t] = rz;
      row[t] = ecs[t] * ry;
      row[L + t] = w[t] * rw;
    }
  }
  ip = warp_sum(ip);
  if (tid % 32 == 0) sip[tid / 32] = ip;
  __syncthreads();  // G o E, the row and column sums are stored

  // dC = exp(cs) o (dy S0^T) + (G o E) B; dB = w o (dx dS1^T) + (G o E)^T C
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dca[i][j] *= ecs[r];
      dba[i][j] *= w[r];
    }
  }
  mm<4, NJ>(dca, sG, LDL, 1, sB, 1, ldn, L, tr, tc);
  mm<4, NJ>(dba, sG, 1, LDL, sC, 1, ldn, L, tr, tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= len) continue;
    const long long o = (((long long)bi * a.S + c0 + r) * a.H + h) * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tc + 16 * j;
      if (n < N) {
        a.dCh[o + n] = dca[i][j];
        a.dBh[o + n] = dba[i][j];
      }
    }
  }

  // dcs, then ddA = its reverse running sum, by warp 0, two steps a lane
  if (tid < 32) {
    const int lane = tid, l0 = 2 * lane;
    float d[2], wsum = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int l = l0 + e;
      double col = 0.0;
      for (int r = 0; r < 16; ++r) col += red[r * L + l];
      d[e] = (float)(rowz[l] - col) + row[l] - row[L + l];
      wsum += row[L + l];
    }
    wsum = warp_sum(wsum);
    if (lane == 31) {
      float ips = 0.f;
      for (int k = 0; k < THREADS / 32; ++k) ips += sip[k];
      d[1] += wsum + expf(cs[L - 1]) * ips;
    }
    float suf = d[0] + d[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += u;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) after = 0.f;
    const float v1 = after + d[1], v0 = v1 + d[0];
    float* out = a.ddA + ((long long)bi * a.S + c0) * a.H + h;
    if (l0 < len) out[(long long)l0 * a.H] = v0;
    if (l0 + 1 < len) out[(long long)(l0 + 1) * a.H] = v1;
  }
}

// Each group's dB and dC: the sum of its heads' in head order.
template <typename T>
__global__ void bwd_group_sum(Args a, long long rows) {
  const int N = a.N, G = a.G, hg = a.H / a.G;
  const long long total = rows * G * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = i % N;
    const long long r = i / N;
    const long long src = ((r / G) * a.H + (r % G) * hg) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < hg; ++j) {
      sb += a.dBh[src + (long long)j * N];
      sc += a.dCh[src + (long long)j * N];
    }
    put(static_cast<T*>(a.dB) + i, sb);
    put(static_cast<T*>(a.dC) + i, sc);
  }
}

// Host side: launches and the C interface.

size_t states_smem(int N) { return (size_t)(L * N + L * PB + 4 * L) * 4; }
size_t chunk_smem(int NJ) { return (size_t)ChunkSmem(16 * NJ).total * 4; }

template <typename T, int NJ>
cudaError_t launch(const Args& a, int Bt, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per instance
  const size_t sm = chunk_smem(NJ);
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_chunk<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  bwd_states<T><<<dim3((a.P + PB - 1) / PB, a.H, Bt), THREADS,
                  states_smem(a.N), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_chunk<T, NJ><<<dim3(a.NC, a.H, Bt), THREADS, sm, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = (long long)Bt * a.S;
  const long long blocks = (rows * a.G * a.N + 255) / 256;
  bwd_group_sum<T><<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                     stream>>>(a, rows);
  return cudaGetLastError();
}

// The 16-column tiles of N a bwd_chunk thread owns: 1, 2, 4 or 8.
int tiles_of(int N) {
  const int t = (N + 15) / 16;
  return t <= 2 ? t : t <= 4 ? 4 : 8;
}

template <typename T>
cudaError_t by_n(const Args& a, int Bt, cudaStream_t stream) {
  switch (tiles_of(a.N)) {
    case 1: return launch<T, 1>(a, Bt, stream);
    case 2: return launch<T, 2>(a, Bt, stream);
    case 4: return launch<T, 4>(a, Bt, stream);
    default: return launch<T, 8>(a, Bt, stream);
  }
}

}  // namespace

// Shared memory of the largest block for a state of N rows.
extern "C" long long ssd_scan_bwd_smem_bytes(int N) {
  return (long long)chunk_smem(tiles_of(N));
}
extern "C" long long ssd_scan_bwd_max_smem() { return MAX_SMEM; }

// dtype (of dx, B, C, dy and ddx / dB / dC): 0 = float32, 1 = bfloat16;
// dA, init, dstate, ddA, dinit and the scratch are float32. strides: 15
// element strides, the batch, sequence and head (group) strides of dx, dA,
// B, C and dy in that order; their last axes are contiguous. init and
// dstate may be null (zeros), dinit too (not written). Outputs and scratch
// are contiguous: ddx (Bt, S, H, P), ddA (Bt, S, H), dB / dC (Bt, S, G, N),
// dinit (Bt, H, N, P), states / dstates (Bt, ceil(S / 64), H, N, P), dBh /
// dCh (Bt, S, H, N). S >= 1. Returns the launches' cudaError_t.
extern "C" int ssd_scan_bwd(const void* dx, const float* dA, const void* B,
                            const void* C, const float* init, const void* dy,
                            const float* dstate, void* ddx, float* ddA,
                            void* dB, void* dC, float* dinit, float* states,
                            float* dstates, float* dBh, float* dCh, int dtype,
                            int Bt, int S, int H, int G, int N, int P,
                            const long long* strides, void* stream) {
  if (Bt <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N % 4 != 0 ||
      N > MAX_N || P <= 0 || P % 4 != 0 || S <= 0 ||
      chunk_smem(tiles_of(N)) > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  Args a;
  a.dx = dx; a.dA = dA; a.B = B; a.C = C; a.init = init; a.dy = dy;
  a.dstate = dstate; a.ddx = ddx; a.ddA = ddA; a.dB = dB; a.dC = dC;
  a.dinit = dinit; a.states = states; a.dstates = dstates; a.dBh = dBh;
  a.dCh = dCh;
  a.S = S; a.H = H; a.G = G; a.N = N; a.P = P; a.NC = (S + L - 1) / L;
  a.dx_sb = strides[0]; a.dx_ss = strides[1]; a.dx_sh = strides[2];
  a.dA_sb = strides[3]; a.dA_ss = strides[4]; a.dA_sh = strides[5];
  a.b_sb = strides[6]; a.b_ss = strides[7]; a.b_sg = strides[8];
  a.c_sb = strides[9]; a.c_ss = strides[10]; a.c_sg = strides[11];
  a.dy_sb = strides[12]; a.dy_ss = strides[13]; a.dy_sh = strides[14];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_n<float>(a, Bt, st);
  if (dtype == 1) return by_n<__nv_bfloat16>(a, Bt, st);
  return cudaErrorInvalidValue;
}
