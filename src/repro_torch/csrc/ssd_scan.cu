// Mamba2 SSD chunked scan for Hopper: the chunked dual form of the selective
// state-space recurrence, fp32 or bf16 in, fp32 state and sums, y in dx's
// type.
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
// P = 64, N = 128) the least work of an exact form is the chunked form at a
// chunk of ~11 steps, with the scores C . B^T shared by a group's heads:
// per step and head 4 N P (C . state and the state update) + L P (the
// causal scores times dx) + N P / L (the state's decay), ~4.19 S H N P =
// 0.21 GFLOP, 3.1 us on the 67 TFLOP/s fp32 CUDA cores (the sequential
// recurrence needs 5 S H N P), against 5.4 MB of memory traffic (1.6 us at
// 3.35 TB/s): operations. This first version runs the
// chunked form with fp32 FMAs on the CUDA cores (the fp32 path stays exact
// fp32). What the design does about the bound:
// * one block per (head, batch) walks its chunks in order; the N x P fp32
//   state lives in shared memory for the whole scan (32 KB at full width)
//   and never goes to device memory between chunks, the TPU kernel's VMEM
//   carry;
// * a chunk's B and C are staged transposed (n-major, rows padded to 68
//   floats) and dx row-major in shared memory, so every inner loop reads
//   16-byte vectors, and each thread keeps a 4 x 4 tile of its outputs in
//   registers (16 FMAs for every 8 floats loaded);
// * the L x L score matrix of a chunk (16 KB at L = 64) is masked before
//   the exp and stays in shared memory; the output rows skip the score
//   columns past their own step, and score tiles above the diagonal are
//   never computed.
// At B = 1 this is 64 blocks on 132 SMs; chunk-parallel state passing,
// wgmma and TMA are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int L = 64;            // steps per chunk
constexpr int LP = L + 4;        // padded row of the transposed B and C tiles
constexpr int TILES = L / 4;     // 4-step tiles per chunk
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448; // a block's shared memory on the H100
static_assert(TILES * TILES == THREADS, "one score tile per thread");

struct Args {
  const void* dx;
  const float* dA;
  const void* B;
  const void* C;
  const float* init;  // (Bt, H, N, P) fp32 or null for zeros
  void* y;            // (Bt, S, H, P) contiguous, dx's type
  float* fin;         // (Bt, H, N, P) fp32 contiguous
  int S, H, G, N, P;
  long long dx_sb, dx_ss, dx_sh, dA_sb, dA_ss, dA_sh;
  long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

size_t smem_bytes(int N, int P) {
  return sizeof(float) * (2 * (size_t)N * LP + (size_t)L * P + (size_t)L * L +
                          (size_t)N * P + 3 * L);
}

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& a,
                                       const float4& b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ai = at(a, i);
    acc[i][0] = fmaf(ai, b.x, acc[i][0]);
    acc[i][1] = fmaf(ai, b.y, acc[i][1]);
    acc[i][2] = fmaf(ai, b.z, acc[i][2]);
    acc[i][3] = fmaf(ai, b.w, acc[i][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, P = a.P, P4 = a.P / 4;
  float* ct = smem;                // C^T: ct[n * LP + l]
  float* bt = ct + N * LP;         // B^T: bt[n * LP + s]
  float* xs = bt + N * LP;         // dx:  xs[s * P + p]
  float* mt = xs + L * P;          // masked decayed scores: mt[s * L + l]
  float* st = mt + L * L;          // state: st[n * P + p]
  float* cs = st + N * P;          // running log-decay inside the chunk
  float* ecs = cs + L;             // exp(cs_l)
  float* w = ecs + L;              // exp(cs_last - cs_s)

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int g = h / (a.H / a.G);
  const T* dx = static_cast<const T*>(a.dx) + bi * a.dx_sb + h * a.dx_sh;
  const float* dA = a.dA + bi * a.dA_sb + h * a.dA_sh;
  const T* Bg = static_cast<const T*>(a.B) + bi * a.b_sb + g * a.b_sg;
  const T* Cg = static_cast<const T*>(a.C) + bi * a.c_sb + g * a.c_sg;
  const long long y_ss = (long long)a.H * P;
  T* y = static_cast<T*>(a.y) + (long long)bi * a.S * y_ss + (long long)h * P;
  const long long st_off = ((long long)bi * a.H + h) * N * P;

  for (int i = tid; i < N * P; i += THREADS)
    st[i] = a.init ? a.init[st_off + i] : 0.f;

  for (int c0 = 0; c0 < a.S; c0 += L) {
    const int len = min(L, a.S - c0);
    // Stage the chunk; steps past its end read as zeros.
    if (tid < L) cs[tid] = tid < len ? dA[(c0 + tid) * a.dA_ss] : 0.f;
    for (int i = tid; i < L * N; i += THREADS) {
      const int l = i / N, n = i - l * N;
      float bv = 0.f, cv = 0.f;
      if (l < len) {
        bv = to_f(Bg[(c0 + l) * a.b_ss + n]);
        cv = to_f(Cg[(c0 + l) * a.c_ss + n]);
      }
      bt[n * LP + l] = bv;
      ct[n * LP + l] = cv;
    }
    for (int i = tid; i < L * P; i += THREADS) {
      const int l = i / P, p = i - l * P;
      xs[i] = l < len ? to_f(dx[(c0 + l) * a.dx_ss + p]) : 0.f;
    }
    __syncthreads();

    // Inclusive running sum of the log-decays: warp 0, two steps a lane.
    if (tid < 32) {
      const float x0 = cs[2 * tid], x1 = cs[2 * tid + 1];
      float incl = x0 + x1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c_0 = excl + x0, c_1 = c_0 + x1;
      const float last = __shfl_sync(0xffffffffu, c_1, 31);
      cs[2 * tid] = c_0;
      cs[2 * tid + 1] = c_1;
      ecs[2 * tid] = expf(c_0);
      ecs[2 * tid + 1] = expf(c_1);
      w[2 * tid] = expf(last - c_0);
      w[2 * tid + 1] = expf(last - c_1);
    }
    __syncthreads();

    // Scores M[l][s] = (C_l . B_s) exp(cs_l - cs_s) for s <= l, else 0; the
    // mask comes before the exp, as in the TPU kernel.
    {
      const int l0 = (tid / TILES) * 4, s0 = (tid % TILES) * 4;
      float acc[4][4] = {};
      if (s0 <= l0) {
        for (int n = 0; n < N; ++n)
          outer4(acc, ld4(ct + n * LP + l0), ld4(bt + n * LP + s0));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = l0 + i;
          v[i] = s <= l ? acc[i][j] * expf(cs[l] - cs[s]) : 0.f;
        }
        *reinterpret_cast<float4*>(mt + s * L + l0) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();

    // Output rows: y_l = sum_{s<=l} M[l][s] dx_s + exp(cs_l) C_l . state.
    for (int t = tid; t < TILES * P4; t += THREADS) {
      const int l0 = (t / P4) * 4, p0 = (t % P4) * 4;
      if (l0 >= len) continue;
      float diag[4][4] = {}, off[4][4] = {};
      const int s_end = min(l0 + 4, len);
      for (int s = 0; s < s_end; ++s)
        outer4(diag, ld4(mt + s * L + l0), ld4(xs + s * P + p0));
      for (int n = 0; n < N; ++n)
        outer4(off, ld4(ct + n * LP + l0), ld4(st + n * P + p0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + i;
        if (l >= len) break;
        T* yr = y + (c0 + l) * y_ss + p0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yr[j] = from_f<T>(fmaf(ecs[l], off[i][j], diag[i][j]));
      }
    }
    __syncthreads();

    // State to the chunk's end: state exp(cs_last) + sum_s B_s w_s (x) dx_s.
    const float total = expf(cs[L - 1]);
    for (int t = tid; t < (N / 4) * P4; t += THREADS) {
      const int n0 = (t / P4) * 4, p0 = (t % P4) * 4;
      float acc[4][4] = {};
      for (int s = 0; s < len; ++s) {
        const float ws = w[s];
        const float4 bv = make_float4(bt[n0 * LP + s] * ws,
                                      bt[(n0 + 1) * LP + s] * ws,
                                      bt[(n0 + 2) * LP + s] * ws,
                                      bt[(n0 + 3) * LP + s] * ws);
        outer4(acc, bv, ld4(xs + s * P + p0));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = st + (n0 + i) * P + p0 + j;
          *sp = fmaf(*sp, total, acc[i][j]);
        }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * P; i += THREADS) a.fin[st_off + i] = st[i];
}

template <typename T>
cudaError_t launch(const Args& a, int Bt, cudaStream_t stream) {
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ssd_scan_kernel<T><<<dim3(a.H, Bt), THREADS, smem_bytes(a.N, a.P), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs for a state of N x P; the wrapper refuses
// shapes above ssd_scan_max_smem().
extern "C" long long ssd_scan_smem_bytes(int N, int P) {
  return (long long)smem_bytes(N, P);
}
extern "C" long long ssd_scan_max_smem() { return MAX_SMEM; }

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
      P <= 0 || P % 4 != 0 || S < 0 || smem_bytes(N, P) > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  Args a;
  a.dx = dx; a.dA = dA; a.B = B; a.C = C; a.init = init; a.y = y; a.fin = fin;
  a.S = S; a.H = H; a.G = G; a.N = N; a.P = P;
  a.dx_sb = strides[0]; a.dx_ss = strides[1]; a.dx_sh = strides[2];
  a.dA_sb = strides[3]; a.dA_ss = strides[4]; a.dA_sh = strides[5];
  a.b_sb = strides[6]; a.b_ss = strides[7]; a.b_sg = strides[8];
  a.c_sb = strides[9]; a.c_ss = strides[10]; a.c_sg = strides[11];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, Bt, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, Bt, st);
  return cudaErrorInvalidValue;
}
