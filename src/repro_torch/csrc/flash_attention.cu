// Flash attention (prefill) for Hopper: online-softmax attention with the
// running max, sum and accumulator in fp32, fp32 or bf16 in, q's type out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel). Same function: causal with the upper
// triangle of tiles skipped, or non-causal; a sliding window that masks one
// side only (q - k < window); q_offset places query row i at absolute
// position i + q_offset; keys at or beyond sk_valid are masked; query head h
// reads KV head h / (Hq / Hkv) for any integer group; a row with no valid key
// gives 0.
//
// What bounds it on an H100: at the prefill lengths the engine serves
// (S <= 160) the work is a few MFLOP per head and launch latency dominates;
// at long S it is bound by operations, 4 * D FLOPs per (query, key) pair.
// This first version does that arithmetic with fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak), not tensor cores, so the model's fp32 path stays exact
// fp32 (TF32 would keep only ~3 decimal digits). What the design does about
// the bound: it never writes the S x S scores to device memory, reads each
// K/V tile once per block into shared memory and reuses it for 32 query
// rows, and skips tiles that the causal mask or the window leaves empty.
// wgmma on bf16 tiles is the later step.
//
// Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D), read
// through element strides for the batch, sequence and head axes (the last
// axis is contiguous), so the model's layout needs no transposed copy.
// One block per (query tile of 32 rows, query head, batch); four warps of
// eight rows each; a loop over 64-key tiles inside the block replaces the
// TPU's sequential grid axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;                       // query rows per block
constexpr int BK = 64;                       // keys per tile (two per lane)
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;              // rows per warp
constexpr int THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset, sk_valid;
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(Args a) {
  constexpr int NC = (D + 31) / 32;          // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][D], pre-scaled
  float* Ks = Qs + BQ * D;                   // [BK][D + 1], padded rows
  float* Vs = Ks + BK * (D + 1);             // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    Qs[i] = row < a.Sq ? to_f(qp[row * a.q_ss + c]) * a.scale : 0.f;
  }

  // Key range any row of this block can see: the causal bound of the last
  // row and the window bound of the first one. Tiles outside hold no valid
  // key for any row and are skipped (the TPU kernel's block skip).
  const int pos_lo = q0 + a.q_offset;
  const int pos_hi = min(q0 + BQ, a.Sq) - 1 + a.q_offset;
  int k_end = a.sk_valid;
  if (a.causal) k_end = min(k_end, pos_hi + 1);
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, key = kt + r;
      const bool in = key < k_end;
      Ks[r * (D + 1) + c] = in ? to_f(kp[key * a.k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vp[key * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // scores: lane owns keys kt + lane and kt + lane + 32 for the warp's rows
    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* q_rows = Qs + warp * RPW * D;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float k0 = Ks[lane * (D + 1) + c];
      const float k1 = Ks[(lane + 32) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qv = q_rows[r * D + c];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int pos = q0 + warp * RPW + r + a.q_offset;
      bool ok[2];
      float t[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = kt + lane + 32 * j;
        ok[j] = key < k_end && (!a.causal || pos >= key) &&
                (a.window <= 0 || pos - key < a.window);
        t[j] = ok[j] ? s[r][j] : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(t[0], t[1])));
      float alpha = 1.f, p0 = 0.f, p1 = 0.f;
      if (m_new != -INFINITY) {  // at least one valid key seen so far
        alpha = expf(m[r] - m_new);
        p0 = ok[0] ? expf(t[0] - m_new) : 0.f;
        p1 = ok[1] ? expf(t[1] - m_new) : 0.f;
      }
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      Ps[(warp * RPW + r) * BK + lane] = p0;
      Ps[(warp * RPW + r) * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V: lane owns output columns lane + 32 c
    const float* p_rows = Ps + warp * RPW * BK;
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? Vs[kk * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = p_rows[r * BK + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= a.Sq) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) op[row * a.o_ss + d] = from_f<T>(acc[r][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(a);
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

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the batch,
// sequence and head strides of q, k, v and o in that order. Returns the
// launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int dtype, int B, int Sq, int Hq,
                                   int Hkv, int D, const long long* strides,
                                   int causal, int window, int q_offset,
                                   int sk_valid, float scale, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.Sq = Sq; a.Hq = Hq; a.Hkv = Hkv;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.sk_valid = sk_valid; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, a, B, st);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a, B, st);
  return cudaErrorInvalidValue;
}
