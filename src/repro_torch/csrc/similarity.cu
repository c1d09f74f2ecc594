// Cosine similarity for Hopper, fp32 or bf16 in, fp32 sums and output:
// * rowwise_cosine: out[m] = sum_d a[m, d] * b[m, d] (aligned rows);
// * cosine_matrix:  out[m, n] = sum_d a[m, d] * b[n, d] (every pair).
//
// rowwise_cosine replaces the Pallas TPU kernel
// src/repro/kernels/similarity.py (rowwise_cosine, body _rowwise_kernel).
// Same function on any M: the TPU padded M up to a block of 128 rows and
// sliced the result back; here rows past M are masked, so nothing is
// padded.
//
// What bounds it on an H100: bytes. Each pair of elements read takes one
// fused multiply-add, 2 FLOPs per 8 bytes at fp32, far below the ~20
// FLOP/byte where the CUDA cores would become the limit. So the card's
// memory has to see enough bytes in flight (~2 MB across the card at 3.35
// TB/s and its latency). What the design does about it:
// * A warp streams RW = 4 rows at a time and issues all their 16-byte
//   loads (4 fp32 or 8 bf16 a lane, neighbouring lanes on neighbouring
//   addresses) before any sum: 4 KB in flight a warp at D = 256 fp32, with
//   the anchor, 4x the one row a warp of the first version. Below 4 rows
//   a warp for every multiprocessor's block (M < 4 x 8 x 132), one row a
//   warp, so a short pass spreads over more warps.
// * b is read through its own row stride. With a stride of 0 (one anchor
//   row against every row of a: the cascade scores a morsel against its
//   predicate, no (M, D) copy of the anchor) each warp loads the anchor
//   into registers once (2 x 16 B a lane at D = 256 fp32) and half the
//   load instructions, which fetched the same 1 KB for every row, go.
// * The grid is the row groups of 8 warps x 4 rows, up to 8 blocks of 256
//   threads on each multiprocessor (the most an SM holds), with a
//   grid-stride loop past that; a small M (a 16-row morsel) is one short
//   block.
// * Rows whose D, stride or start do not allow 16-byte loads, and rows of
//   more than 64 chunks (whose RW rows of a and b would pass 128 registers
//   a thread), take the first version: one warp a row, one element a lane
//   or a loop of 16-byte loads.
// * The fp32 partial sums of the lanes meet in a __shfl_xor_sync tree, with
//   no shared memory and no second pass.
//
// cosine_matrix replaces the Pallas TPU kernel
// src/repro/kernels/similarity.py (cosine_matrix, body _matrix_kernel): a
// product of 128 x 128 tiles with the whole D in VMEM, M and N padded to
// the tile and sliced back. Here any M, N and D, the ragged edges masked.
//
// What bounds it on an H100: operations once M and N are in the thousands
// (2 D FLOPs per output against 4 D bytes read per row); at the semantic
// path's 250 x 250 x 256 (a few MFLOP), the latency of one block's loads
// and products. What the design does about it:
// * the products run on the tensor cores through wgmma (sm_90a): bf16 as
//   bf16 with fp32 accumulators; fp32 as 3xTF32, each value split into its
//   TF32 rounding hi and the rest lo, the product summed as hi*hi + hi*lo +
//   lo*hi, which keeps the cosines within ~2e-7 of fp32 where one TF32
//   product is off by ~1e-4, at up to 495 / 3 = 165 TFLOP/s against the 67
//   of the CUDA cores;
// * both operands are K-major as they lie (D contiguous), so wgmma reads
//   them from shared memory with no transpose;
// * the tiles follow the size of the grid: 128 x 128 outputs from two
//   warpgroups when the tiles fill the card's SMs; 64 x 64 from two
//   warpgroups that split each slice's k-steps; and, for a grid that still
//   leaves SMs idle, clusters of 4 blocks per tile that split D's slices
//   and add their sums in the first block's shared memory, so each block
//   loads and multiplies a quarter of D;
// * each slice of D is loaded into registers while the one before is
//   multiplied, split into its TF32 parts on the way to shared memory
//   (wgmma reads B from there), and stored with lanes on consecutive rows,
//   so the stores meet no bank conflicts; 16-byte loads where D and the row
//   strides allow, else one element at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// 16-byte rows of at most 32 CH chunks: each warp takes RW rows at a time,
// all their loads in flight before the sums; with ANCHOR (b's row stride 0)
// b's one row is loaded into registers once.
template <typename T, int CH, int RW, bool ANCHOR>
__global__ void __launch_bounds__(THREADS)
rowwise_rows(const T* __restrict__ a, const T* __restrict__ b,
             float* __restrict__ out, int M, int D, long long sa,
             long long sb) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, nc = D / E;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 an[CH];
  if (ANCHOR) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = lane + 32 * c;
      an[c] = i < nc ? __ldg(reinterpret_cast<const uint4*>(b) + i) : zero;
    }
  }
  const long long step = (long long)gridDim.x * WARPS * RW;
  for (long long r0 = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * RW;
       r0 < M; r0 += step) {
    uint4 x[RW][CH], y[RW][CH];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const bool ok = r0 + r < M;
      const uint4* ar = reinterpret_cast<const uint4*>(a + (r0 + r) * sa);
      const uint4* br = reinterpret_cast<const uint4*>(b + (r0 + r) * sb);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int i = lane + 32 * c;
        x[r][c] = ok && i < nc ? __ldg(ar + i) : zero;
        if (!ANCHOR) y[r][c] = ok && i < nc ? __ldg(br + i) : zero;
      }
    }
    float acc[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c)
        acc[r] += dot16<T>(x[r][c], ANCHOR ? an[c] : y[r][c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < RW; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < RW; ++r)
        if (r0 + r < M) out[r0 + r] = acc[r];
    }
  }
}

template <typename T, int CH, int RW>
int launch_rows(const T* a, const T* b, float* out, int M, int D,
                long long sa, long long sb, int sms, cudaStream_t stream) {
  const long long groups = ((long long)M + WARPS * RW - 1) / (WARPS * RW);
  const long long cap = sms > 0 ? 8LL * sms : groups;
  const dim3 grid(static_cast<unsigned>(groups < cap ? groups : cap));
  if (sb == 0)
    rowwise_rows<T, CH, RW, true><<<grid, THREADS, 0, stream>>>(a, b, out, M, D, sa, sb);
  else
    rowwise_rows<T, CH, RW, false><<<grid, THREADS, 0, stream>>>(a, b, out, M, D, sa, sb);
  return cudaGetLastError();
}

// RW = 4 rows a warp where that still gives every multiprocessor a block;
// a smaller M (a 16-row morsel) takes one row a warp, over more warps.
template <typename T, int CH>
int launch_rows(const T* a, const T* b, float* out, int M, int D,
                long long sa, long long sb, cudaStream_t stream) {
  static const int sms = hopper::multiprocessors();
  if ((long long)M >= 4LL * WARPS * sms)
    return launch_rows<T, CH, 4>(a, b, out, M, D, sa, sb, sms, stream);
  return launch_rows<T, CH, 1>(a, b, out, M, D, sa, sb, sms, stream);
}

template <typename T>
int launch(const void* a, const void* b, float* out, int M, int D,
           long long sa, long long sb, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = D % E == 0 && sa % E == 0 && sb % E == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  const int nc = D / E;
  if (vec && nc <= 32) return launch_rows<T, 1>(at, bt, out, M, D, sa, sb, stream);
  if (vec && nc <= 64) return launch_rows<T, 2>(at, bt, out, M, D, sa, sb, stream);
  const dim3 grid((M + WARPS - 1) / WARPS);
  if (vec)
    rowwise_kernel<T, true><<<grid, THREADS, 0, stream>>>(at, bt, out, M, D, sa, sb);
  else
    rowwise_kernel<T, false><<<grid, THREADS, 0, stream>>>(at, bt, out, M, D, sa, sb);
  return cudaGetLastError();
}

// cosine_matrix: a BM x BN tile of outputs per block, BM = 64 WGM, over
// the slices z, z + CK, ... of D, where z is the block's rank in a cluster
// of CK blocks along the grid's z axis. A slice is CH 16-byte chunks a row;
// the slice's BM rows of a and BN rows of b are one [chunk][R = BM + BN
// rows][16 B] tile in shared memory (fp32: its TF32 high part, then its low
// part). The block's WGM x WGK warpgroups: warpgroup (wm, wk) multiplies
// rows 64 wm to 64 wm + 63 over the slice's k-steps wk, wk + WGK, ...; its
// sum meets the other warpgroups' in shared memory, and with CK > 1 the
// cluster's sums meet in the first block's shared memory.
template <typename T, int WGM, int WGK, int BN, int CH, int CK>
struct Mat {
  static constexpr int BM = 64 * WGM, R = BM + BN, THREADS = 128 * WGM * WGK;
  static constexpr int E = 16 / sizeof(T);         // elements per chunk
  static constexpr int BK = CH * E;                // elements per slice
  static constexpr int parts = sizeof(T) == 4 ? 2 : 1;
  static constexpr int PB = R * CH * 16;           // bytes of one part
  static constexpr int NC = R * CH / THREADS;      // chunks a thread loads
  // the warpgroups' sums (in the operand tiles once they are read), then
  // the sums of the cluster's other blocks (a region of their own)
  static constexpr int SUMS = (WGK - 1) * WGM * 128 * (BN / 2) * 4;
  static constexpr int OPS = parts * PB > SUMS ? parts * PB : SUMS;
  static constexpr size_t smem = OPS + (CK - 1) * WGM * 128 * (BN / 2) * 4;
  static_assert(R * CH % THREADS == 0, "whole chunks per thread");
  static_assert(CH / 2 % WGK == 0, "whole k-steps per warpgroup");
};

// Chunk of one row at element k: 16 bytes at once where the rows allow it,
// else element by element; past D, or with no row, zeros.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int k, int D) {
  constexpr int E = 16 / sizeof(T);
  if (row == nullptr || k >= D) return make_uint4(0, 0, 0, 0);
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + k));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (k + e >= D) break;
    if constexpr (sizeof(T) == 4) {
      w[e] = __float_as_uint(row[k + e]);
    } else {
      const uint16_t bits = __bfloat16_as_ushort(row[k + e]);
      w[e >> 1] |= static_cast<uint32_t>(bits) << (16 * (e & 1));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int WGM, int WGK, int BN, int CH, int CK, bool VEC>
__global__ void __launch_bounds__(Mat<T, WGM, WGK, BN, CH, CK>::THREADS,
                                  WGK * CK == 1 ? 2 : 1)
matrix_kernel(const T* __restrict__ a, const T* __restrict__ b,
              float* __restrict__ out, int M, int N, int D, long long sa,
              long long sb) {
  using L = Mat<T, WGM, WGK, BN, CH, CK>;
  using OT = typename std::conditional<sizeof(T) == 4, hopper::TF32,
                                       hopper::BF16>::type;
  constexpr int BM = L::BM, R = L::R, NC = L::NC;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, wg = tid >> 7, wm = wg % WGM, wk = wg / WGM;
  const int wt = tid & 127, z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // waited for before the merge
  if constexpr (CK > 1) hopper::cluster_arrive();

  // This thread's chunks of every slice: index tid + THREADS i of the tile,
  // row idx % R (a's rows first, then b's), chunk idx / R; found once.
  const T* src[NC];  // the row, or nullptr past M or N
  int col[NC], dst[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int idx = tid + L::THREADS * i, row = idx % R, c = idx / R;
    const int r = row < BM ? m0 + row : n0 + row - BM;
    src[i] = row < BM ? (r < M ? a + r * sa : nullptr)
                      : (r < N ? b + r * sb : nullptr);
    col[i] = c * L::E;
    dst[i] = hopper::chunk_offset(c, row, R);
  }
  uint4 x[NC];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NC; ++i)
      x[i] = load_chunk<T, VEC>(src[i], k0 + col[i], D);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if constexpr (L::parts == 2) {
        uint4 lo;
        *reinterpret_cast<uint4*>(smem + dst[i]) = hopper::split4(x[i], lo);
        *reinterpret_cast<uint4*>(smem + L::PB + dst[i]) = lo;
      } else {
        *reinterpret_cast<uint4*>(smem + dst[i]) = x[i];
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int first = z * L::BK;
  if (first < D) {
    load(first);
    store();
  }
  hopper::fence_smem_to_async();
  __syncthreads();
  // wgmma descriptors of this warpgroup's first k-step: rows 64 wm of a,
  // the BN rows of b
  const uint64_t da = hopper::desc(smem + (wm * 64 + wk * 2 * R) * 16, R * 16);
  const uint64_t db = hopper::desc(smem + (BM + wk * 2 * R) * 16, R * 16);
  for (int k0 = first; k0 < D; k0 += CK * L::BK) {
    const bool more = k0 + CK * L::BK < D;
    if (more) load(k0 + CK * L::BK);  // in flight while this slice multiplies
    hopper::pin<BN / 2>(acc);
    hopper::fence();
    // this warpgroup's k-steps wk, wk + WGK, ..., each two chunks of R rows
    // (the slice's zeros past D add nothing)
#pragma unroll
    for (int j = 0; j < CH / 2 / WGK; ++j) {
      const int off = j * WGK * 2 * R * 16;
      const uint64_t ah = hopper::desc_at(da, off), bh = hopper::desc_at(db, off);
      hopper::mma_ss<OT, BN>(acc, ah, bh, 1);
      if constexpr (L::parts == 2) {
        hopper::mma_ss<OT, BN>(acc, ah, hopper::desc_at(db, L::PB + off), 1);
        hopper::mma_ss<OT, BN>(acc, hopper::desc_at(da, L::PB + off), bh, 1);
      }
    }
    hopper::commit();
    hopper::wait<0>();
    hopper::pin<BN / 2>(acc);
    if (more) {
      __syncthreads();  // every product has read this slice
      store();
      hopper::fence_smem_to_async();
      __syncthreads();
    }
  }

  // The sums meet thread by thread (the same rows and columns): warpgroups
  // wk > 0 hand theirs to wk = 0 through the operand tiles; then the
  // cluster's blocks z > 0 theirs to block 0, into its own region.
  if constexpr (WGK > 1) {
    float* xs = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (wk > 0) {
      float* xw = xs + ((wk - 1) * WGM + wm) * (BN / 2) * 128 + wt;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) xw[i * 128] = acc[i];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int w = 1; w < WGK; ++w) {
        const float* xw = xs + ((w - 1) * WGM + wm) * (BN / 2) * 128 + wt;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += xw[i * 128];
      }
    }
  }
  if constexpr (CK > 1) {
    float* xs = reinterpret_cast<float*>(smem + L::OPS);
    hopper::cluster_wait();  // every block of the cluster is running
    if (z > 0 && wk == 0) {
      float* xw = xs + ((z - 1) * WGM + wm) * (BN / 2) * 128 + wt;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        hopper::store_remote(xw + i * 128, 0, acc[i]);
    }
    hopper::cluster_sync();
    if (z == 0 && wk == 0) {
#pragma unroll
      for (int w = 1; w < CK; ++w) {
        const float* xw = xs + ((w - 1) * WGM + wm) * (BN / 2) * 128 + wt;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += xw[i * 128];
      }
    }
  }
  if (wk > 0 || z > 0) return;

  // rows 16 warp + lane / 4 (+ 8) of the warpgroup's 64, columns 8 i + 2 t
  // (+ 1)
  const int lane = tid & 31, t = lane & 3;
  const int row = m0 + 64 * wm + 16 * (wt >> 5) + (lane >> 2);
  const bool pairs = (N & 1) == 0;  // 8-byte stores stay aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = row + 8 * half;
    if (m >= M) continue;
    float* orow = out + (long long)m * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * t;
      const float x0 = acc[4 * i + 2 * half], x1 = acc[4 * i + 2 * half + 1];
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(orow + n) = make_float2(x0, x1);
      } else {
        if (n < N) orow[n] = x0;
        if (n + 1 < N) orow[n + 1] = x1;
      }
    }
  }
}

template <typename T, int WGM, int WGK, int BN, int CH, int CK, bool VEC>
int launch_matrix_tiles(const void* a, const void* b, float* out, int M,
                        int N, int D, long long sa, long long sb,
                        cudaStream_t stream) {
  using L = Mat<T, WGM, WGK, BN, CH, CK>;
  auto kernel = matrix_kernel<T, WGM, WGK, BN, CH, CK, VEC>;
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + L::BM - 1) / L::BM, CK);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = CK;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a), static_cast<const T*>(b), out,
      M, N, D, sa, sb);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Tiles by the size of the grid: 128 x 128 outputs from two warpgroups
// when they fill the card's SMs (132 on an H100) at least once; else 64 x
// 64 from two warpgroups that split each 64-element slice of D, and, when
// even those tiles leave SMs idle (the semantic path's 250 x 250 gives
// 16), a cluster of 4 blocks per tile that split D's slices between them.
template <typename T, bool VEC>
int launch_matrix_vec(const void* a, const void* b, float* out, int M, int N,
                      int D, long long sa, long long sb, cudaStream_t stream) {
  constexpr int CH = 64 * sizeof(T) / 16;  // 64 elements a slice
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  const long long small = (long long)((M + 63) / 64) * ((N + 63) / 64);
  const int sms = hopper::multiprocessors();
  if (big >= sms)
    return launch_matrix_tiles<T, 2, 1, 128, 8, 1, VEC>(a, b, out, M, N, D,
                                                        sa, sb, stream);
  if (small >= sms)
    return launch_matrix_tiles<T, 1, 2, 64, CH, 1, VEC>(a, b, out, M, N, D,
                                                        sa, sb, stream);
  return launch_matrix_tiles<T, 1, 2, 64, CH, 4, VEC>(a, b, out, M, N, D, sa,
                                                      sb, stream);
}

template <typename T>
int launch_matrix(const void* a, const void* b, float* out, int M, int N,
                  int D, long long sa, long long sb, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = D % E == 0 && sa % E == 0 && sb % E == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec) return launch_matrix_vec<T, true>(a, b, out, M, N, D, sa, sb, stream);
  return launch_matrix_vec<T, false>(a, b, out, M, N, D, sa, sb, stream);
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
      (M + 63) / 64 > 65535)
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
