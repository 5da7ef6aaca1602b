// Flash attention forward for Hopper (sm_90a): fp32 online softmax on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by ::flash_attention).  Same function: O = softmax(scale*Q K^T + mask) V per
// (batch, head); GQA with KV head h / (H/K); causal k <= q + q_offset; sliding window
// q - k < window when window > 0; masked scores -1e30; running max, denominator and
// accumulator in fp32 and both products in fp32 even for bf16 inputs; denominator clamped
// at 1e-30; output in the input dtype; (q-tile, kv-tile) pairs that are fully masked are
// skipped.
//
// What bounds it on this card.  At the serving shape (B=4, H=32, K=2, S=1024, D=128, bf16,
// causal) one call does ~34 GFLOP on ~71 MB: ~480 FLOP per byte, so the card's bound is its
// bf16 tensor-core rate, not memory.  This first version computes in fp32 FFMA on the CUDA
// cores instead (the fp32 cases must meet 2e-5, which TF32 cannot), so it is bound by the
// SIMT fp32 rate and by shared-memory bandwidth under that.  What the design does about it:
//   * one block of 256 threads per (64-row q tile, head, batch); the KV loop runs inside the
//     block and stops at the causal/window limit (the Pallas kernel's pl.when), so fully
//     masked tiles cost nothing and no state crosses blocks;
//   * Q, K and V tiles live in shared memory as fp32 (bf16 widened on load); each thread owns
//     a 4x4 block of scores and a 4 x (D/16) block of the output and reads shared memory with
//     16-byte loads, 8 loads per 64 FMAs; rows are padded by 4 floats so those loads hit no
//     bank twice;
//   * row max and row sum reduce over the 16 threads that share a row with warp shuffles;
//   * P reuses the K buffer once the scores sit in registers, which keeps D=128 at 98 KB of
//     shared memory and two blocks per SM;
//   * strides are arguments, so the model layout [B, S, H, D] is read in place, and any head
//     dim up to 256 works (zero-padded in shared memory only).
// The tensor-core version (bf16 wgmma tiles fed by TMA) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NTHREADS = 256;  // 16 row groups x 16 column lanes
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int Sq, Skv, H, G, d;        // G = H / K query heads per KV head; d = real head dim
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + 64) of a [S, d] slice into shared memory as fp32 with row pitch
// `pitch`; rows past S and columns past d are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, long long ss,
                                          int row0, int S, int d) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int s = row0 + r;
    float val = 0.f;
    if (s < S && c < d) val = to_f(src[(long long)s * ss + c]);
    dst[r * pitch + c] = val;
  }
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Args a) {
  constexpr int QP = D + 4;    // Q and K row pitch (floats)
  constexpr int PP = BK + 4;   // P row pitch
  constexpr int NG = D / 64;   // 64-wide output column groups per thread row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * QP;    // K tile, then P of the same tile
  float* sV = sK + BK * QP;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<T, D>(sQ, QP, q, a.q_ss, qt * BQ, a.Sq, a.d);

  // KV tiles that hold at least one unmasked key for some row of this q tile
  const int q_start = qt * BQ + a.q_offset;        // absolute position of row 0
  const int nk = (a.Skv + BK - 1) / BK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q_start + BQ - 1) / BK + 1);
  int kt_begin = 0;
  if (a.window > 0) kt_begin = max(0, q_start - a.window + 1) / BK;

  float acc[4][NG][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();   // the previous tile's P and V are consumed
    load_tile<T, D>(sK, QP, k, a.k_ss, k_start, a.Skv, a.d);
    load_tile<T, D>(sV, D, v, a.v_ss, k_start, a.Skv, a.d);
    __syncthreads();

    // scores for rows tr*4+i, columns tc+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&sQ[(tr * 4 + i) * QP + dd]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&sK[(tc + 16 * j) * QP + dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // scale, mask, online softmax update
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_start + tr * 4 + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k_start + tc + 16 * j;
        bool ok = ki < a.Skv;
        if (a.causal) ok = ok && ki <= qi;
        if (a.window > 0) ok = ok && (qi - ki) < a.window;
        s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mc));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }

    __syncthreads();   // every thread is done reading K: its buffer now takes P
    float* sP = sK;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(tr * 4 + i) * PP + tc + 16 * j] = s[i][j];
    __syncthreads();

    // acc[rows tr*4+i][cols g*64 + tc*4 + e] += P V
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&sP[(tr * 4 + i) * PP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(&sV[(c + cc) * D + g * 64 + tc * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * BQ + tr * 4 + i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tc * 4 + e;
        if (col < a.d) o[(long long)row * a.o_ss + col] = from_f<T>(acc[i][g][e] / denom);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int smem = (2 * 64 * (D + 4) + 64 * D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, int B, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, B, stream);
  if (a.d <= 128) return launch<T, 128>(a, B, stream);
  if (a.d <= 256) return launch<T, 256>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim is contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int K, int Sq, int Skv, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (K <= 0 || H % K != 0 || d <= 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, Sq, Skv, H, H / K, d,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
         causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dim<float>(a, B, st);
  if (dtype == 1) return (int)dispatch_dim<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
