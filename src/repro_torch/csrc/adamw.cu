// AdamW for Hopper: the global norm of a tree's gradients, then the update
// of every leaf, fp32, in two multi-tensor passes.
//
// Replaces no Pallas TPU kernel: the reference writes AdamW in jnp
// (src/repro/training/optimizer.py apply_updates) and leaves its
// elementwise chain to XLA, which fuses it. Run eagerly, the same chain
// (kernels/adamw.py plain) is about 17 PyTorch kernels a leaf and two more
// for the norm, each reading and writing whole fp32 leaves: ~195 bytes a
// parameter moved where 32 are needed.
//
// What bounds it on an H100: bytes. The norm reads each gradient once (4
// bytes a parameter); the update reads p, g, m and v and writes the new p,
// m and v (28 bytes) at 17 FLOPs an element, under one FLOP a byte, far
// below the ridge. So the least time is 32 bytes a parameter over 3.35
// TB/s (15.0 ms for codeqwen1.5-7b cut to 4 layers, 1.569 B parameters).
// What the design does about it:
// * two passes, each reading its inputs once and writing its outputs once;
//   between them only one fp64 partial a block stays in device memory;
// * one launch a pass for up to MAX_LEAVES leaves: their pointers and sizes
//   travel in the kernel's parameters, and the grid walks the tiles of all
//   the leaves as one sequence, so a small leaf (a norm's scale, a bias)
//   costs no launch of its own and a large one spreads over every SM;
// * 16-byte loads and stores, four fp32 a thread, with cache hints that
//   stream (nothing is read twice); elements past a multiple of 4, and
//   leaves whose pointers are not 16-byte aligned, go element by element;
// * the grid is what the card holds at once (the multiprocessor count
//   times the blocks an SM fits), each block striding over the tiles.
//
// The norm: each thread sums squares in fp64 over its elements, each block
// writes its sum to a fixed place of a scratch buffer, and one block adds
// those in a fixed order into the fp64 sum of squares: the same bits every
// run, no float atomics. The sum, not its root, so that the sums of the
// blocks of a tree split over ranks can be all-reduced first. The update: the reference's arithmetic in the chain's
// order, each operation rounded to fp32 (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no FMA contraction), the constants rounded to fp32 as
// PyTorch rounds a Python float, and the clip scale, lr and bias
// corrections read from device memory, so the step waits on no host read.
// New p, m and v equal the chain's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_LEAVES = 32;
constexpr int THREADS = 256;
constexpr int VEC = 4;                          // fp32 a 16-byte access
constexpr int NORM_TILE = THREADS * VEC * 2;    // two accesses a thread
constexpr int UPDATE_TILE = THREADS * VEC;

// The leaves of one launch of the norm pass. tile0[l] is leaf l's first
// tile in the sequence of all the launch's tiles, tile0[count] their
// number; bit l of vec: leaf l takes 16-byte accesses.
struct NormLeaves {
  const float* g[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long tile0[MAX_LEAVES + 1];
  unsigned vec;
  int count;
};

struct UpdateLeaves {
  const float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  const float* m[MAX_LEAVES];
  const float* v[MAX_LEAVES];
  float* p2[MAX_LEAVES];
  float* m2[MAX_LEAVES];
  float* v2[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long tile0[MAX_LEAVES + 1];
  unsigned vec;
  int count;
};

// The Python floats of the configuration, rounded to fp32: b1, 1 - b1,
// b2, 1 - b2 (each difference taken in double first, as Python does),
// eps and the weight decay.
struct Coeffs {
  float b1, c1, b2, c2, eps, wd;
};

// The sum of x over the block, in a fixed order, in thread 0.
__device__ double block_sum(double x) {
  __shared__ double warps[THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  x = 0.0;
  if (warp == 0) {
    if (lane < THREADS / 32) x = warps[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

__device__ __forceinline__ double squares(float4 x) {
  double s = (double)x.x * x.x;
  s += (double)x.y * x.y;
  s += (double)x.z * x.z;
  return s + (double)x.w * x.w;
}

// Each block's sum of squares over its tiles into partial[blockIdx.x].
__global__ void __launch_bounds__(THREADS)
    adamw_sumsq_partial(NormLeaves a, double* partial) {
  double acc = 0.0;
  const long long tiles = a.tile0[a.count];
  int l = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    while (t >= a.tile0[l + 1]) ++l;
    const float* g = a.g[l];
    const long long n = a.n[l];
    const long long i0 = (t - a.tile0[l]) * NORM_TILE + threadIdx.x * VEC;
    const long long i1 = i0 + THREADS * VEC;
    if ((a.vec >> l & 1u) && i1 + VEC <= n) {
      const float4 x0 = __ldcs(reinterpret_cast<const float4*>(g + i0));
      const float4 x1 = __ldcs(reinterpret_cast<const float4*>(g + i1));
      acc += squares(x0);
      acc += squares(x1);
    } else {
      for (int j = 0; j < 2 * VEC; ++j) {
        const long long i = (j < VEC ? i0 : i1 - VEC) + j;
        if (i < n) {
          const double x = g[i];
          acc += x * x;
        }
      }
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// The partials added in a fixed order into out.
__global__ void __launch_bounds__(THREADS)
    adamw_sumsq_finish(const double* partial, int count, double* out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += THREADS) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

// One element's step, as the chain computes it.
__device__ __forceinline__ void step(float p, float g, float m, float v,
                                     float scale, float lr, float b1c,
                                     float b2c, const Coeffs& k, float& p2,
                                     float& m2, float& v2) {
  const float gs = __fmul_rn(g, scale);
  m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, gs));
  v2 = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.c2, __fmul_rn(gs, gs)));
  const float mhat = __fdiv_rn(m2, b1c);
  const float vhat = __fdiv_rn(v2, b2c);
  const float delta = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), k.eps));
  p2 = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(delta, __fmul_rn(k.wd, p))));
}

__global__ void __launch_bounds__(THREADS)
    adamw_update(UpdateLeaves a, const float* scale_p, const float* lr_p,
                 const float* b1c_p, const float* b2c_p, Coeffs k) {
  const float scale = *scale_p, lr = *lr_p, b1c = *b1c_p, b2c = *b2c_p;
  const long long tiles = a.tile0[a.count];
  int l = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    while (t >= a.tile0[l + 1]) ++l;
    const long long n = a.n[l];
    const long long i = (t - a.tile0[l]) * UPDATE_TILE + threadIdx.x * VEC;
    if ((a.vec >> l & 1u) && i + VEC <= n) {
      const float4 p = __ldcs(reinterpret_cast<const float4*>(a.p[l] + i));
      const float4 g = __ldcs(reinterpret_cast<const float4*>(a.g[l] + i));
      const float4 m = __ldcs(reinterpret_cast<const float4*>(a.m[l] + i));
      const float4 v = __ldcs(reinterpret_cast<const float4*>(a.v[l] + i));
      float4 p2, m2, v2;
      step(p.x, g.x, m.x, v.x, scale, lr, b1c, b2c, k, p2.x, m2.x, v2.x);
      step(p.y, g.y, m.y, v.y, scale, lr, b1c, b2c, k, p2.y, m2.y, v2.y);
      step(p.z, g.z, m.z, v.z, scale, lr, b1c, b2c, k, p2.z, m2.z, v2.z);
      step(p.w, g.w, m.w, v.w, scale, lr, b1c, b2c, k, p2.w, m2.w, v2.w);
      __stcs(reinterpret_cast<float4*>(a.p2[l] + i), p2);
      __stcs(reinterpret_cast<float4*>(a.m2[l] + i), m2);
      __stcs(reinterpret_cast<float4*>(a.v2[l] + i), v2);
    } else {
      for (long long j = i; j < i + VEC && j < n; ++j)
        step(a.p[l][j], a.g[l][j], a.m[l][j], a.v[l][j], scale, lr, b1c,
             b2c, k, a.p2[l][j], a.m2[l][j], a.v2[l][j]);
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Blocks of ``kernel`` the whole card holds at once; 0 if unknown.
int resident(const void* kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0) != cudaSuccess)
    return 0;
  return per_sm * hopper::multiprocessors();
}

int norm_blocks() {
  static const int blocks =
      resident(reinterpret_cast<const void*>(adamw_sumsq_partial));
  return blocks;
}

int update_blocks() {
  static const int blocks =
      resident(reinterpret_cast<const void*>(adamw_update));
  return blocks;
}

// tile0 of ``count`` leaves of n elements at ``tile`` elements a tile.
void tile_starts(const long long* n, int count, int tile, long long* tile0) {
  tile0[0] = 0;
  for (int l = 0; l < count; ++l)
    tile0[l + 1] = tile0[l] + (n[l] + tile - 1) / tile;
}

}  // namespace

// The leaves one launch of either pass takes; a call with more launches
// once for each run of this many.
extern "C" int adamw_max_leaves() { return MAX_LEAVES; }

// The doubles of scratch the norm pass writes for each run of
// adamw_max_leaves() leaves: one a block of its grid. 0 if the device
// cannot be read.
extern "C" int adamw_sumsq_blocks() { return norm_blocks(); }

// out = the sum over the count leaves of sum g[l][i]^2, fp64, on the
// device; g[l] holds n[l] contiguous floats. partial: scratch of
// ceil(count / adamw_max_leaves()) * adamw_sumsq_blocks() doubles. One
// partial launch a run of leaves, then one finishing block. Returns the
// launches' cudaError_t (0 on success).
extern "C" int adamw_sumsq(const float* const* g, const long long* n,
                           int count, double* partial, double* out,
                           void* stream) {
  const int blocks = norm_blocks();
  if (count <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int runs = 0;
  for (int first = 0; first < count; first += MAX_LEAVES, ++runs) {
    NormLeaves a;
    a.count = count - first < MAX_LEAVES ? count - first : MAX_LEAVES;
    a.vec = 0;
    for (int l = 0; l < a.count; ++l) {
      if (n[first + l] < 0) return cudaErrorInvalidValue;
      a.g[l] = g[first + l];
      a.n[l] = n[first + l];
      if (aligned(a.g[l])) a.vec |= 1u << l;
    }
    tile_starts(a.n, a.count, NORM_TILE, a.tile0);
    adamw_sumsq_partial<<<blocks, THREADS, 0, st>>>(a, partial +
                                                       (long long)runs * blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  adamw_sumsq_finish<<<1, THREADS, 0, st>>>(partial, runs * blocks, out);
  return cudaGetLastError();
}

// For each of the count leaves of n[l] contiguous floats: the new p, m and
// v of one AdamW step into p2, m2, v2 (new buffers: none may overlap an
// input). scale, lr, b1c, b2c: one float each on the device; b1, c1 = 1 -
// b1, b2, c2 = 1 - b2, eps, wd: the configuration's. One launch a run of
// adamw_max_leaves() leaves. Returns the launches' cudaError_t.
extern "C" int adamw_update_leaves(
    const float* const* p, const float* const* g, const float* const* m,
    const float* const* v, float* const* p2, float* const* m2,
    float* const* v2, const long long* n, int count, const float* scale,
    const float* lr, const float* b1c, const float* b2c, float b1, float c1,
    float b2, float c2, float eps, float wd, void* stream) {
  const int blocks = update_blocks();
  if (count <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const Coeffs k{b1, c1, b2, c2, eps, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < count; first += MAX_LEAVES) {
    UpdateLeaves a;
    a.count = count - first < MAX_LEAVES ? count - first : MAX_LEAVES;
    a.vec = 0;
    for (int l = 0; l < a.count; ++l) {
      const int s = first + l;
      if (n[s] < 0) return cudaErrorInvalidValue;
      a.p[l] = p[s]; a.g[l] = g[s]; a.m[l] = m[s]; a.v[l] = v[s];
      a.p2[l] = p2[s]; a.m2[l] = m2[s]; a.v2[l] = v2[s];
      a.n[l] = n[s];
      if (aligned(p[s]) && aligned(g[s]) && aligned(m[s]) && aligned(v[s]) &&
          aligned(p2[s]) && aligned(m2[s]) && aligned(v2[s]))
        a.vec |= 1u << l;
    }
    tile_starts(a.n, a.count, UPDATE_TILE, a.tile0);
    const long long tiles = a.tile0[a.count];
    if (tiles == 0) continue;
    const int grid = tiles < blocks ? (int)tiles : blocks;
    adamw_update<<<grid, THREADS, 0, st>>>(a, scale, lr, b1c, b2c, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
