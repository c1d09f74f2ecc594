// Decode attention for Hopper: one query token per sequence against a KV
// cache with a per-sequence valid length, fp32 or bf16 in, q's type out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _kernel). Same function: query head h reads KV
// head h / (Hq / Hkv) for any integer group; keys at or beyond cache_len[b]
// are masked; cache_len[b] = 0 gives 0.
//
// What bounds it on an H100: bytes. Every valid K and V row streams from
// device memory once and takes ~4 FLOPs per byte read at fp32, far below
// the ~20 FLOP/byte where the CUDA cores would become the limit. What the
// design does about it:
// * flash-decoding: the TPU merged split-K blocks in order along a
//   sequential grid axis; here the splits of 64 keys run in parallel across
//   the SMs (pass 1, one block per split, KV head and sequence) and a second
//   pass merges their (max, sum, accumulator) partials, so a short batch
//   still fills the card;
// * one block serves all query heads of its KV head's group, so each K/V
//   row is read from memory once, not once per query head;
// * cache_len is read on the device and splits at or beyond it return at
//   once, so the bytes moved follow the valid lengths, not the cache size;
// * the engine's (B, S, Hkv, D) cache slice is read in place through its
//   strides, with no transposed or contiguous copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 64;                    // keys per split (two per lane)
constexpr int GMAX = 16;                     // largest query-head group
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* o;
  float* part_acc;                           // (B, Hq, nsplit, D)
  float* part_m;                             // (B, Hq, nsplit)
  float* part_l;                             // (B, Hq, nsplit)
  int S, Hq, Hkv, nsplit;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale;
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

__device__ __forceinline__ int valid_len(const Args& a, int b) {
  return max(0, min(a.cache_len[b], a.S));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (GMAX * D + CHUNK * (D + 1) + CHUNK * D + GMAX * CHUNK);
}

// Pass 1: one block per (split, KV head, sequence).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) decode_split(Args a) {
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = sp * CHUNK;
  const int len = valid_len(a, b);
  if (k0 >= len) return;                     // nothing valid in this split
  const int n = min(CHUNK, len - k0);
  const int g = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* Qs = smem;                          // [g][D], pre-scaled
  float* Ks = Qs + GMAX * D;                 // [CHUNK][D + 1]
  float* Vs = Ks + CHUNK * (D + 1);          // [CHUNK][D]
  float* Ps = Vs + CHUNK * D;                // [g][CHUNK]

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + hk * g * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int i = tid; i < g * D; i += THREADS) {
    const int j = i / D, c = i % D;
    Qs[i] = to_f(qp[j * a.q_sh + c]) * a.scale;
  }
  for (int i = tid; i < CHUNK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool in = r < n;
    Ks[r * (D + 1) + c] = in ? to_f(kp[(k0 + r) * a.k_ss + c]) : 0.f;
    Vs[r * D + c] = in ? to_f(vp[(k0 + r) * a.v_ss + c]) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < g * CHUNK; i += THREADS) {
    const int j = i / CHUNK, kk = i % CHUNK;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) s = fmaf(Qs[j * D + c], Ks[kk * (D + 1) + c], s);
    Ps[i] = kk < n ? s : -INFINITY;
  }
  __syncthreads();

  const long long part = ((long long)b * a.Hq + hk * g) * a.nsplit + sp;
  for (int j = warp; j < g; j += WARPS) {
    const float s0 = Ps[j * CHUNK + lane], s1 = Ps[j * CHUNK + lane + 32];
    const float mx = warp_max(fmaxf(s0, s1));  // n >= 1: finite
    const float p0 = lane < n ? expf(s0 - mx) : 0.f;
    const float p1 = lane + 32 < n ? expf(s1 - mx) : 0.f;
    const float sum = warp_sum(p0 + p1);
    Ps[j * CHUNK + lane] = p0;
    Ps[j * CHUNK + lane + 32] = p1;
    if (lane == 0) {
      a.part_m[part + (long long)j * a.nsplit] = mx;
      a.part_l[part + (long long)j * a.nsplit] = sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < g * D; i += THREADS) {
    const int j = i / D, c = i % D;
    float acc = 0.f;
    for (int kk = 0; kk < n; ++kk) acc = fmaf(Ps[j * CHUNK + kk], Vs[kk * D + c], acc);
    a.part_acc[(part + (long long)j * a.nsplit) * D + c] = acc;
  }
}

// Pass 2: merge the valid splits of one (query head, sequence).
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_combine(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int ns = (valid_len(a, b) + CHUNK - 1) / CHUNK;
  const long long base = ((long long)b * a.Hq + h) * a.nsplit;
  float mx = -INFINITY;
  for (int i = 0; i < ns; ++i) mx = fmaxf(mx, a.part_m[base + i]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float w = expf(a.part_m[base + i] - mx);
    l = fmaf(a.part_l[base + i], w, l);
    acc = fmaf(a.part_acc[(base + i) * D + c], w, acc);
  }
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  op[c] = from_f<T>(ns == 0 ? 0.f : acc / l);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  decode_split<T, D><<<dim3(a.nsplit, a.Hkv, B), THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, D><<<dim3(a.Hq, B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// dtype: 0 = float32, 1 = bfloat16. strides: 10 element strides, q's batch
// and head strides, k's and v's batch, sequence and head strides, o's batch
// and head strides, in that order. scratch holds B * Hq * nsplit * (D + 2)
// floats with nsplit = ceil(S / decode_attention_chunk()). Returns the
// launches' cudaError_t (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* cache_len, void* o, float* scratch,
                                    int dtype, int B, int S, int Hq, int Hkv,
                                    int D, const long long* strides, float scale,
                                    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > GMAX) return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.cache_len = cache_len; a.o = o;
  a.S = S; a.Hq = Hq; a.Hkv = Hkv;
  a.nsplit = (S + CHUNK - 1) / CHUNK;
  const long long parts = (long long)B * Hq * a.nsplit;
  a.part_acc = scratch;
  a.part_m = scratch + parts * D;
  a.part_l = a.part_m + parts;
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_ss = strides[3]; a.k_sh = strides[4];
  a.v_sb = strides[5]; a.v_ss = strides[6]; a.v_sh = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, a, B, st);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a, B, st);
  return cudaErrorInvalidValue;
}
