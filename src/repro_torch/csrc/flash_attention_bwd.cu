// Flash attention backward for Hopper: dQ, dK and dV of the forward in
// flash_attention.cu from q, k, v, the forward's output o, the output's
// gradient dO and the forward's per-row log-sum-exp, fp32 or bf16 in (fp32
// arithmetic throughout), the inputs' type out.
//
// The gradient of the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention), which has no custom_vjp: the JAX model trains through
// XLA's attention under jax.value_and_grad. The port's forward runs its
// kernel on the card, so its gradient is this kernel. Same masks as the
// forward: causal or not, the one-sided window q - k < window, query row i
// at absolute position i + q_offset, keys at or beyond sk_valid masked,
// query head h reading KV head h / (Hq / Hkv). A row with no valid key had
// output 0 and gets gradient 0 (its log-sum-exp is -inf, and no score of it
// is ever exponentiated).
//
// With P = exp(scale S - lse) recomputed from S = Q K^T and the stored lse:
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),  Delta = rowsum(dO o),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// What bounds it on an H100: operations, five products of 2 D FLOPs per
// visible (query, key) pair (9.4 GFLOP for qwen2-0.5b's 14/2 heads of 64 at
// B = 8, S = 512, causal). This first version is simple and deterministic,
// not fast:
// * CUDA-core fp32 FMAs on tiles in shared memory (rows padded to D + 1
//   floats, so a warp's column reads meet no bank conflicts); each of 256
//   threads holds a 4 x 4 block of a 64 x 64 product.
// * No atomics: one pass owns query tiles and writes dQ, another owns key
//   tiles and writes dK and dV. So S and dP are computed twice, seven
//   products where the bound counts five. The dQ pass packs a GQA group's
//   rows into its tiles as the forward does (row r = position r / g, head
//   r % g), so each K/V tile is staged once for the group. The dK/dV pass
//   runs one block per (key tile, query head) to fill the card, writes
//   fp32 partials per query head, and a third kernel sums each group's
//   partials in a fixed order. The gradient is the same bits on every run.
// * The dQ pass also computes Delta for its rows (the pre-pass) and stores
//   it for the dK/dV pass, which runs after it on the stream.
// * P is recomputed with ex2.approx on scores pre-scaled by log2 e, as the
//   forward computes it (relative error ~2^-22).
// Tensor cores (wgmma), one fused pass and the five-product count are the
// speed work that follows.
//
// Layout: q, o, dO, dQ (B, Sq, Hq, D); k, v, dK, dV (B, Sk, Hkv, D), read
// and written through element strides for the batch, sequence and head
// axes (the last axis contiguous; no alignment needed); lse and the Delta
// scratch (B, Hq, Sq) fp32 contiguous; the dK/dV partials (B, Sk, Hq, D)
// fp32 contiguous, two of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::ex2;

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16, a 4 x 4 block of 64 x 64 each
constexpr float LOG2E = 1.4426950408889634f;

struct Str {
  long long b, s, h;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;
  Str sq_, sk_, sv_, so_, sdo_, sdq_, sdk_, sdv_;
  int B, Sq, Sk, Hq, Hkv, g;
  int causal, window, q_offset, sk_valid;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Args& a, int pos, int key) {
  return key < a.sk_valid && (!a.causal || key <= pos) &&
         (a.window <= 0 || pos - key < a.window);
}

// 64 rows of D into a [64][D + 1] float tile; row r is element offset
// off(r) of base, or absent (zeros) where off(r) < 0.
template <typename T, int D, typename Off>
__device__ __forceinline__ void load_tile(float* dst, const void* base,
                                          Off off) {
  const T* p = static_cast<const T*>(base);
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const long long o = off(r);
    dst[r * (D + 1) + c] = o >= 0 ? to_f(p[o + c]) : 0.f;
  }
}

// Shared memory of either pass: four [64][D + 1] tiles, one [64][65]
// tile of probabilities or score gradients, and two vectors of 64.
template <int D>
constexpr size_t smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * 65 + 2 * 64) * sizeof(float);
}

// dQ pass. Grid (packed row tiles, Hkv, B): a block owns 64 packed rows of
// one KV head's group and walks the key tiles they can see.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dq(Args a) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* dOs = Qs + 64 * P;
  float* Ks = dOs + 64 * P;
  float* Vs = Ks + 64 * P;
  float* dSs = Vs + 64 * P;      // [64 rows][65]
  float* lse_s = dSs + 64 * 65;  // lse log2 e, +inf past the last row
  float* dl_s = lse_s + 64;      // Delta
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int hk = blockIdx.y, b = blockIdx.z, g = a.g, Sk = a.Sk;
  const int rows = a.Sq * g, r0 = blockIdx.x * BM;

  // element offset of packed row r's (position, head) in a (B, Sq, Hq, D)
  // tensor of strides st, or -1 past the last row
  auto row_off = [=](const Str st) {
    return [=](int r) -> long long {
      const int pr = r0 + r;
      return pr < rows ? b * st.b + (pr / g) * st.s + (hk * g + pr % g) * st.h
                       : -1;
    };
  };
  load_tile<T, D>(Qs, a.q, row_off(a.sq_));
  load_tile<T, D>(dOs, a.dout, row_off(a.sdo_));
  {
    // Delta = rowsum(dO o), four threads a row, and the row's lse
    const int r = tid >> 2, part = tid & 3, pr = r0 + r;
    float acc = 0.f;
    if (pr < rows) {
      const T* orow = static_cast<const T*>(a.o) + row_off(a.so_)(r);
      const T* drow = static_cast<const T*>(a.dout) + row_off(a.sdo_)(r);
      for (int c = part; c < D; c += 4) acc += to_f(orow[c]) * to_f(drow[c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      float l2 = INFINITY;
      if (pr < rows) {
        const long long idx =
            (static_cast<long long>(b) * a.Hq + hk * g + pr % g) * a.Sq +
            pr / g;
        a.delta[idx] = acc;
        l2 = a.lse[idx] * LOG2E;
      }
      lse_s[r] = l2;
      dl_s[r] = acc;
    }
  }
  __syncthreads();

  int pos[4];
  float l2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    pos[i] = (r0 + r) / g + a.q_offset;
    l2[i] = lse_s[r];
    dl[i] = dl_s[r];
  }
  // the keys any row of the tile can see
  const int pos_lo = r0 / g + a.q_offset;
  const int pos_hi = (min(r0 + BM, rows) - 1) / g + a.q_offset;
  const int k_end = a.causal ? min(a.sk_valid, pos_hi + 1) : a.sk_valid;
  const int k_begin = a.window > 0 ? max(0, pos_lo - a.window + 1) : 0;
  const float sl2 = a.scale * LOG2E;

  float dq[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BN) {
    auto key_off = [=](const Str st) {
      return [=](int r) -> long long {
        return kt + r < Sk ? b * st.b + (kt + r) * st.s + hk * st.h : -1;
      };
    };
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(Ks, a.k, key_off(a.sk_));
    load_tile<T, D>(Vs, a.v, key_off(a.sv_));
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * P + d];
        da[i] = dOs[(ty + 16 * i) * P + d];
        ka[i] = Ks[(tx + 16 * i) * P + d];
        va[i] = Vs[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt + tx + 16 * j;
        const float p = visible(a, pos[i], key)
                            ? ex2(fmaf(s[i][j], sl2, -l2[i]))
                            : 0.f;
        dSs[(ty + 16 * i) * 65 + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      float ds[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * 65 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq[i][j] = fmaf(ds[i], kv[j], dq[i][j]);
    }
  }

  T* dqp = static_cast<T*>(a.dq);
  const auto dq_off = row_off(a.sdq_);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = dq_off(ty + 16 * i);
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) put(dqp + o + tx + 16 * j, dq[i][j] * a.scale);
  }
}

// dK/dV pass. Grid (key tiles, Hq, B): a block owns 64 keys of one query
// head's KV head and walks the query tiles of that head which can see
// them; it writes the head's share of dK and dV to the fp32 partials.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv(Args a) {
  constexpr int P = D + 1, NJ = D / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + 64 * P;
  float* Qs = Vs + 64 * P;
  float* dOs = Qs + 64 * P;
  float* Ps = dOs + 64 * P;       // [64 keys][65]: P^T, then dS^T
  float* lse_s = Ps + 64 * 65;
  float* dl_s = lse_s + 64;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.g;
  const int kt = blockIdx.x * BN, Sq = a.Sq, Sk = a.Sk;

  auto key_off = [=](const Str st) {
    return [=](int r) -> long long {
      return kt + r < Sk ? b * st.b + (kt + r) * st.s + hk * st.h : -1;
    };
  };
  load_tile<T, D>(Ks, a.k, key_off(a.sk_));
  load_tile<T, D>(Vs, a.v, key_off(a.sv_));

  // query rows whose positions can see a key of the tile
  int i_begin = 0, i_end = kt < a.sk_valid ? a.Sq : 0;
  if (a.causal) i_begin = max(0, kt - a.q_offset);
  if (a.window > 0)
    i_end = min(i_end, max(0, kt + BN - 1 + a.window - a.q_offset));
  const float sl2 = a.scale * LOG2E;

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int i0 = i_begin; i0 < i_end; i0 += BM) {
    auto row_off = [=](const Str st) {
      return [=](int r) -> long long {
        return i0 + r < Sq ? b * st.b + (i0 + r) * st.s + h * st.h : -1;
      };
    };
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(Qs, a.q, row_off(a.sq_));
    load_tile<T, D>(dOs, a.dout, row_off(a.sdo_));
    if (tid < 64) {
      const int i = i0 + tid;
      const long long idx = (static_cast<long long>(b) * a.Hq + h) * a.Sq + i;
      lse_s[tid] = i < a.Sq ? a.lse[idx] * LOG2E : INFINITY;
      dl_s[tid] = i < a.Sq ? a.delta[idx] : 0.f;
    }
    __syncthreads();
    // S^T and dP^T: keys ty + 16 i, rows tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = Ks[(ty + 16 * i) * P + d];
        va[i] = Vs[(ty + 16 * i) * P + d];
        qa[i] = Qs[(tx + 16 * i) * P + d];
        da[i] = dOs[(tx + 16 * i) * P + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], da[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, key = kt + ty + 16 * i;
        // rows past the end have lse +inf: p = 0
        s[i][j] = visible(a, i0 + r + a.q_offset, key)
                      ? ex2(fmaf(s[i][j], sl2, -lse_s[r]))
                      : 0.f;
        Ps[(ty + 16 * i) * 65 + r] = s[i][j];
      }
    __syncthreads();
    // dV += P^T dO: keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pa[4], oa[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * 65 + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) oa[j] = dOs[r * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dv[i][j] = fmaf(pa[i], oa[j], dv[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        Ps[(ty + 16 * i) * 65 + r] = s[i][j] * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();
    // dK += dS^T Q
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float sa[4], qa[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = Ps[(ty + 16 * i) * 65 + r];
#pragma unroll
      for (int j = 0; j < NJ; ++j) qa[j] = Qs[r * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dk[i][j] = fmaf(sa[i], qa[j], dk[i][j]);
    }
  }

  // this head's partials, (B, Sk, Hq, D) fp32; keys no row sees get 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt + ty + 16 * i;
    if (key >= a.Sk) continue;
    const long long o = ((static_cast<long long>(b) * a.Sk + key) * a.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      a.dk_part[o + tx + 16 * j] = dk[i][j] * a.scale;
      a.dv_part[o + tx + 16 * j] = dv[i][j];
    }
  }
}

// dK and dV: each KV head's g partials summed in head order, in the
// inputs' type.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) bwd_sum(Args a) {
  const long long n = static_cast<long long>(a.B) * a.Sk * a.Hkv * D;
  for (long long e = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * THREADS) {
    const int c = static_cast<int>(e % D);
    const long long t = e / D;
    const int hk = static_cast<int>(t % a.Hkv);
    const long long bs = t / a.Hkv;  // b * Sk + key
    const int key = static_cast<int>(bs % a.Sk), b = static_cast<int>(bs / a.Sk);
    const long long p0 = (bs * a.Hq + hk * a.g) * D + c;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < a.g; ++j) {
      sk += a.dk_part[p0 + j * D];
      sv += a.dv_part[p0 + j * D];
    }
    put(static_cast<T*>(a.dk) + b * a.sdk_.b + key * a.sdk_.s + hk * a.sdk_.h + c,
        sk);
    put(static_cast<T*>(a.dv) + b * a.sdv_.b + key * a.sdv_.s + hk * a.sdv_.h + c,
        sv);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // the attributes are set once per instance
  if (!configured) {
    cudaError_t err = allow_smem(bwd_dq<T, D>, smem);
    if (err == cudaSuccess) err = allow_smem(bwd_dkdv<T, D>, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid_q((a.Sq * a.g + BM - 1) / BM, a.Hkv, a.B);
  bwd_dq<T, D><<<grid_q, THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.Sk + BN - 1) / BN, a.Hq, a.B);
  bwd_dkdv<T, D><<<grid_k, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.B) * a.Sk * a.Hkv * D;
  const long long need = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(need < 4096 ? need : 4096);
  bwd_sum<T, D><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_dim(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, the batch,
// sequence and head strides of q, k, v, o, dO, dQ, dK and dV in that order.
// lse: the forward's (B, Hq, Sq) fp32 log-sum-exp; delta: (B, Hq, Sq) fp32
// scratch; dk_part, dv_part: (B, Sk, Hq, D) fp32 scratch, all contiguous.
// Three kernels on the stream; returns the first launch error (0 on
// success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, float* dk_part, float* dv_part, int dtype, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, const long long* strides, int causal,
    int window, int q_offset, int sk_valid, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.dk_part = dk_part; a.dv_part = dv_part;
  Str* st[8] = {&a.sq_, &a.sk_, &a.sv_, &a.so_, &a.sdo_, &a.sdq_, &a.sdk_,
                &a.sdv_};
  for (int i = 0; i < 8; ++i)
    *st[i] = Str{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.g = Hq / Hkv;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.sk_valid = sk_valid; a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_dim<float>(D, a, s);
  if (dtype == 1) return by_dim<__nv_bfloat16>(D, a, s);
  return cudaErrorInvalidValue;
}
