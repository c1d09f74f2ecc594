// Cosine similarity for Hopper, fp32 or bf16 in, fp32 sums and output:
// * rowwise_cosine: out[m] = sum_d a[m, d] * b[m, d] (aligned rows);
// * cosine_matrix:  out[m, n] = sum_d a[m, d] * b[n, d] (every pair).
//
// rowwise_cosine replaces the Pallas TPU kernel
// src/repro/kernels/similarity.py (rowwise_cosine, body _rowwise_kernel).
// Same function on any M: the TPU padded M up to a block of 128 rows and
// sliced the result back; here every warp owns one row and warps past M
// return, so nothing is padded.
//
// What bounds it on an H100: bytes. Each pair of elements read takes one
// fused multiply-add, 2 FLOPs per 8 bytes at fp32, far below the ~20
// FLOP/byte where the CUDA cores would become the limit. What the design
// does about it:
// * one warp per row and 8 rows per block, so a 256-wide fp32 row is two
//   16-byte loads a lane, neighbouring lanes on neighbouring addresses;
// * 16-byte loads (4 fp32 or 8 bf16 a lane) where D and the row strides are
//   multiples of the vector and the rows are 16-byte aligned, else one
//   element a lane;
// * b is read through its own row stride, so a stride of 0 broadcasts one
//   anchor row to every row of a: the cascade scores a morsel against its
//   predicate without a (M, D) copy of the anchor, and the anchor's bytes
//   come from the L1/L2 caches after the first warp reads them;
// * the fp32 partial sums of the lanes meet in a __shfl_xor_sync tree, with
//   no shared memory and no second pass.
//
// cosine_matrix replaces the Pallas TPU kernel
// src/repro/kernels/similarity.py (cosine_matrix, body _matrix_kernel): a
// product of 128 x 128 tiles with the whole D in VMEM, M and N padded to
// the tile and sliced back. Here any M, N and D: tiles of 64 x 64 outputs,
// D walked in slices of 32, the ragged edges of M, N and D masked.
//
// What bounds it on an H100: operations once M and N are in the hundreds
// (2 D FLOPs per output against 4 D bytes read per row), bytes at a few
// rows. This first version multiplies with fp32 FMAs on the CUDA cores (67
// TFLOP/s; exact fp32, no TF32). What the design does about the bound:
// * each 32-wide slice of 64 rows of a and 64 rows of b is staged in
//   shared memory transposed (rows padded to 68 floats, so the transposing
//   stores meet few bank conflicts), and every element staged is used 64
//   times; the next slice is loaded into registers while this one is
//   multiplied, and warps whose outputs all lie past M or N skip the
//   multiply, so a small product costs little more than its 8 slices'
//   memory round trips at D = 256;
// * each of the 256 threads keeps a 4 x 4 tile of outputs in registers and
//   reads two 16-byte vectors per step of the slice for its 16 FMAs.
// wgmma on bf16 tiles and a TMA ring are the later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dot product of two 16-byte vectors: 4 fp32 or 8 bf16 lanes. A bf16 value
// is the top half of an fp32 with the same bits, so each 32-bit word holds
// two of them, the first in its low half.
template <typename T>
__device__ __forceinline__ float dot16(uint4 x, uint4 y);
template <>
__device__ __forceinline__ float dot16<float>(uint4 x, uint4 y) {
  float s = __uint_as_float(x.x) * __uint_as_float(y.x);
  s = fmaf(__uint_as_float(x.y), __uint_as_float(y.y), s);
  s = fmaf(__uint_as_float(x.z), __uint_as_float(y.z), s);
  return fmaf(__uint_as_float(x.w), __uint_as_float(y.w), s);
}
__device__ __forceinline__ float dot_bf16x2(uint32_t x, uint32_t y, float s) {
  s = fmaf(__uint_as_float(x << 16), __uint_as_float(y << 16), s);
  return fmaf(__uint_as_float(x & 0xffff0000u), __uint_as_float(y & 0xffff0000u), s);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(uint4 x, uint4 y) {
  float s = dot_bf16x2(x.x, y.x, 0.f);
  s = dot_bf16x2(x.y, y.y, s);
  s = dot_bf16x2(x.z, y.z, s);
  return dot_bf16x2(x.w, y.w, s);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
rowwise_kernel(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ out, int M, int D, long long sa,
               long long sb) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= M) return;                     // whole warps leave together
  const T* ar = a + row * sa;
  const T* br = b + row * sb;
  float acc = 0.f;
  if (VEC) {
    constexpr int E = 16 / sizeof(T);
    const uint4* av = reinterpret_cast<const uint4*>(ar);
    const uint4* bv = reinterpret_cast<const uint4*>(br);
    for (int i = lane; i < D / E; i += 32) acc += dot16<T>(__ldg(av + i), __ldg(bv + i));
  } else {
    for (int i = lane; i < D; i += 32) acc = fmaf(to_f(ar[i]), to_f(br[i]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

template <typename T>
int launch(const void* a, const void* b, float* out, int M, int D,
           long long sa, long long sb, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = D % E == 0 && sa % E == 0 && sb % E == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((M + WARPS - 1) / WARPS);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  if (vec)
    rowwise_kernel<T, true><<<grid, THREADS, 0, stream>>>(at, bt, out, M, D, sa, sb);
  else
    rowwise_kernel<T, false><<<grid, THREADS, 0, stream>>>(at, bt, out, M, D, sa, sb);
  return cudaGetLastError();
}

constexpr int TM = 64;          // output tile: 64 rows of a x 64 rows of b
constexpr int TK = 32;          // slice of D staged at a time
constexpr int TMP = TM + 4;     // padded row of a staged (transposed) slice
constexpr int MT_THREADS = 256; // a 4 x 4 output tile each
constexpr int PER = TM * TK / MT_THREADS;  // elements a thread stages

// acc[i][j] += x[i] * y[j]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 x, float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(xs[i], y.x, acc[i][0]);
    acc[i][1] = fmaf(xs[i], y.y, acc[i][1]);
    acc[i][2] = fmaf(xs[i], y.z, acc[i][2]);
    acc[i][3] = fmaf(xs[i], y.w, acc[i][3]);
  }
}

// This thread's PER elements of one slice of a and of b, masked to 0 past
// M, N and D; consecutive threads read consecutive elements of a row.
template <typename T>
__device__ __forceinline__ void load_slice(
    const T* __restrict__ a, const T* __restrict__ b, float (&ra)[PER],
    float (&rb)[PER], int M, int N, int D, long long sa, long long sb,
    int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * MT_THREADS, r = i / TK, gk = k0 + i % TK;
    ra[j] = m0 + r < M && gk < D ? to_f(a[(m0 + r) * sa + gk]) : 0.f;
    rb[j] = n0 + r < N && gk < D ? to_f(b[(n0 + r) * sb + gk]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(MT_THREADS, 2)
matrix_kernel(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ out, int M, int N, int D, long long sa,
              long long sb) {
  __shared__ __align__(16) float as[TK][TMP];   // as[k][m]
  __shared__ __align__(16) float bs[TK][TMP];   // bs[k][n]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TM;
  const int tm = (tid / (TM / 4)) * 4, tn = (tid % (TM / 4)) * 4;
  // a warp whose outputs all lie past M or N (a small product) only stages
  const bool live = m0 + tm < M && n0 + tn < N;
  float acc[4][4] = {};
  float ra[PER], rb[PER];
  load_slice(a, b, ra, rb, M, N, D, sa, sb, m0, n0, 0);
  for (int k0 = 0; k0 < D; k0 += TK) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * MT_THREADS;
      as[i % TK][i / TK] = ra[j];
      bs[i % TK][i / TK] = rb[j];
    }
    __syncthreads();
    // the next slice's loads are in flight while this one is multiplied
    if (k0 + TK < D) load_slice(a, b, ra, rb, M, N, D, sa, sb, m0, n0, k0 + TK);
    if (live) {
#pragma unroll 8
      for (int k = 0; k < TK; ++k)
        outer4(acc, *reinterpret_cast<const float4*>(&as[k][tm]),
               *reinterpret_cast<const float4*>(&bs[k][tn]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch_matrix(const void* a, const void* b, float* out, int M, int N,
                  int D, long long sa, long long sb, cudaStream_t stream) {
  const dim3 grid((N + TM - 1) / TM, (M + TM - 1) / TM);
  matrix_kernel<T><<<grid, MT_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), out, M, N, D, sa, sb);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. a is (M, D) with row stride sa, b is
// (N, D) with row stride sb, both in elements with a contiguous last axis;
// out is (M, N) contiguous floats. M, N > 0 and M / 64 < 65536. Returns the
// launch's cudaError_t (0 on success).
extern "C" int cosine_matrix_fwd(const void* a, const void* b, float* out,
                                 int dtype, int M, int N, int D, long long sa,
                                 long long sb, void* stream) {
  if (M <= 0 || N <= 0 || D < 0 || sa < 0 || sb < 0 ||
      (M + TM - 1) / TM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_matrix<float>(a, b, out, M, N, D, sa, sb, st);
  if (dtype == 1)
    return launch_matrix<__nv_bfloat16>(a, b, out, M, N, D, sa, sb, st);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. a is (M, D) with row stride sa, b is
// (M, D) with row stride sb (0 broadcasts one row), both in elements with a
// contiguous last axis; out is M floats. M > 0. Returns the launch's
// cudaError_t (0 on success).
extern "C" int rowwise_cosine_fwd(const void* a, const void* b, float* out,
                                  int dtype, int M, int D, long long sa,
                                  long long sb, void* stream) {
  if (M <= 0 || D < 0 || sa < 0 || sb < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, out, M, D, sa, sb, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, out, M, D, sa, sb, st);
  return cudaErrorInvalidValue;
}
