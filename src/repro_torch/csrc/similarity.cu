// Row-wise dot products for Hopper: out[m] = sum_d a[m, d] * b[m, d], the
// sum taken in fp32, fp32 or bf16 in, fp32 out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/similarity.py
// (rowwise_cosine, body _rowwise_kernel). Same function on any M: the TPU
// padded M up to a block of 128 rows and sliced the result back; here every
// warp owns one row and warps past M return, so nothing is padded.
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

}  // namespace

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
