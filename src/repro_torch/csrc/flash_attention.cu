// Flash attention forward for Hopper (sm_90a): two kernels behind one C entry point.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by ::flash_attention).  Same function: O = softmax(scale*Q K^T + mask) V per
// (batch, head); GQA with KV head h / (H/K); causal k <= q + q_offset; sliding window
// q - k < window when window > 0; masked scores -1e30; running max, denominator and
// accumulator in fp32 and both products in fp32 even for bf16 inputs; denominator clamped
// at 1e-30; output in the input dtype; (q-tile, kv-tile) pairs that are fully masked are
// skipped.
//
// Dispatch (repro_flash_attention_fwd, mirrored by kernels/flash_attention.py::kernel_for):
//   * bfloat16 at any head dim d <= 256 -> flash_fwd_wgmma_kernel, on the tensor cores;
//   * float32 at any d <= 256 -> flash_fwd_tf32x3_kernel, on the tensor cores in 3xTF32 (the
//     fp32 cases must meet 2e-5 max abs: one TF32 product keeps ~10 mantissa bits, which
//     cannot; three of the split operands, hi*hi + hi*lo + lo*hi, keep ~21).
// Neither stands in for the other: a bf16 call whose base or strides TMA cannot take
// returns an error.
//
// What bounds it on this card.  At the serving shape (B=4, H=32, K=2, S=1024, D=128, bf16,
// causal) one call does ~34 GFLOP on ~71 MB: ~480 FLOP per byte, so the card's bound is its
// bf16 tensor-core rate, not memory.
//
// flash_fwd_wgmma_kernel (bf16), what its design does about that:
//   * one block of 3 warpgroups per (128-row q tile, head, batch), the heaviest causal q
//     tiles first; warpgroup 2 is the producer: after setmaxnreg gives its registers to the
//     consumers, one thread starts TMA loads of Q once and of K/V tiles of BN keys into a
//     ring of stages guarded by mbarriers (full: bytes landed; empty: the 8 consumer warps
//     are done, K and V released apart, K as soon as its S is in registers);
//   * the tile is compiled per padded head dim D (64, 128, 256) with BN and the stages
//     beside it: BN 128 with 4 stages (D = 64) or 3 (D = 128); BN 64 with 2 stages at
//     D = 256, where O takes 128 registers a consumer thread and the Q tile 64 KB, so that
//     O + S + P_hi + P_lo stay at 192 registers under setmaxnreg's 240 and Q + 2 x (K + V)
//     at 192 KB of shared memory;
//   * tensor maps are 4-d over [B, S, heads, d] with the caller's strides, so the model
//     layout [B, S, H, D] is read in place; 64-column boxes (128 rows for Q, BN for K/V)
//     with 128-byte swizzle, and TMA's zero fill pads d to D (120 to 128, 129-255 to 256)
//     and rows past S, in shared memory only;
//   * warpgroups 0 and 1 own 64 q rows each: S = Q K^T on wgmma m64nBNk16 from shared
//     memory, bf16 x bf16 -> fp32 (products of bf16 values are exact in fp32); scale, mask
//     and online softmax in fp32 registers, in base 2, the row sum from the fp32 P; the
//     mask runs only on tiles that cross the diagonal, the window's edge or Skv, as one
//     key range per row;
//   * O += P V on register-A wgmma with P split in two, P_hi = P rounded to bf16 and
//     P_lo = the rest truncated to bf16 (integer operations), two series into the same
//     fp32 O: P keeps < 2^-15 of relative error instead of bf16's 2^-9, which the check of
//     two bf16 steps per element at outputs near zero needs; it costs half again the
//     tensor work of Q K^T + P V.  The S accumulator's fragments are the A operand's once
//     pairs are packed to bf16x2; V is the MN-major B operand through the transpose bit,
//     so nothing is transposed in memory; at D = 256 O is two m64n128 halves;
//   * tile i's Q K^T is started together with tile i-1's P V, and tile i's softmax runs
//     while that P V does, so the tensor cores and the softmax overlap inside a warpgroup;
//   * 224 KB of shared memory at d = 128, 192 KB at 256, 144 KB at 64: one block per SM.

// flash_fwd_tf32x3_kernel (fp32): both products on the tensor cores in 3xTF32, at close to
// fp32 accuracy (the fp32 cases are held to 2e-5 max abs, which one TF32 product, ~10
// mantissa bits, cannot meet).  Bound by the 3xTF32 tensor rate (495 / 3 = 165 TFLOP/s
// dense) and, under it, by the instructions that split the operands and by shared-memory
// bandwidth.  What its design does about that:
//   * one block per (64-row q tile, head, batch), the heaviest causal q tiles first; a warp
//     owns 16 q rows: 4 warps, and at D = 256, where one block fills the SM's shared
//     memory, 8: two warps a row group, each summing S over half the head dims (the halves
//     added through shared memory) and keeping half of O's columns; the KV loop runs inside
//     the block and stops at the causal/window limit (the Pallas kernel's pl.when), so
//     fully masked tiles cost nothing (at D = 256, 8 warps of 128 rows with 16-key tiles
//     were slower on an H100 than 4 warps of 64 rows; the split is faster than both);
//   * S = Q K^T and O += P V on mma.sync.m16n8k8.tf32 with fp32 accumulators; each operand
//     is split as x = hi + lo (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)) and each
//     product is hi*hi into one accumulator and lo*hi + hi*lo into another (lo*lo, ~2^-22
//     relative, is dropped); the tensor cores add by truncation, so both are fresh
//     fragments over at most 32 head dims (S) or one 32-key tile (O), added to the
//     running sums in fp32;
//   * the fragments are read with the contraction index permuted inside each group of 8
//     (logical column c of a fragment is element 2c of the group, c + 4 is 2c + 1): Q and K
//     then load as float2 and S's accumulator fragment is P's A fragment as it stands, so P
//     never leaves registers; V's B fragment reads the same permuted key order;
//   * Q stays in shared memory; K/V tiles of 32 keys are double-buffered with cp.async
//     (16-byte copies where bases, strides and d allow, else 4-byte), so tile i+1 loads
//     while tile i computes; rows are padded (Q and K by 8 floats, V by 4) so that no
//     fragment load takes a bank twice;
//   * scale, mask and online softmax in fp32 registers (expf, as the plain version), row
//     max and sum over the 4 lanes that share a row; masks run only on tiles that cross
//     the diagonal, the window's edge or Skv;
//   * strides are arguments, so the model layout [B, S, H, D] is read in place, and any head
//     dim up to 256 works (zero-padded to 64, 128 or 256 in shared memory only): 53 KB of
//     shared memory at D = 64 (3 blocks per SM, by registers), 101 KB at 128 (2), 213 KB at
//     256 (1).

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int Sq, Skv, H, G, d;        // G = H / K query heads per KV head; d = real head dim
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------------------
// The fp32 kernel: 3xTF32 on mma.sync.

constexpr int F_BQ = 64;          // query rows per block: 16 per warp
constexpr int F_BK = 32;          // keys per KV tile
constexpr int F_THREADS = 128;    // 4 warps
constexpr int F_KB = 32;          // head dims a fresh S fragment sums before it is added

// Copy `bytes` (16 or 4) from global to shared memory, asynchronously; zeros where !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying rows [row0, row0 + ROWS) of a [S, d] slice (row stride `ss` elements) into
// shared rows of pitch `pitch`, columns [0, D); rows past S and columns past d are zero.
// VEC floats a copy: 4 needs a 16-byte aligned slice, `ss` and d multiples of 4.
template <int ROWS, int D, int VEC, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const float* src, long long ss,
                                          int row0, int S, int d) {
  constexpr int CPR = D / VEC;
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * VEC;
    const bool ok = row0 + r < S && c < d;
    cp_async<VEC * 4>(dst + r * pitch + c, ok ? src + (long long)(row0 + r) * ss + c : src, ok);
  }
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b in 3xTF32: hi x hi into `big`, the cross terms into `small`.  The tensor cores add
// into an fp32 accumulator by truncation, so the small terms keep their own accumulator,
// and both are fresh fragments over a few products, added to the running sums in fp32
// by the caller: one accumulator over a whole KV loop read 3.5e-5 relative against the
// naive prefill after h2o-danube-3-4b's 24 fp32 layers at 4352 keys on an H100, against
// the 2e-5 limit.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  mma_tf32(big, a_hi, b_hi);
  mma_tf32(small, a_lo, b_hi);
  mma_tf32(small, a_hi, b_lo);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// blocks an SM keeps: 3 at D = 64 (4 fit its shared memory, but held to 128 registers a
// thread its fragments spill), 2 at 128, 1 at 256
template <int D> __host__ __device__ constexpr int fp32_min_blocks() {
  return D <= 64 ? 3 : D <= 128 ? 2 : 1;
}

// warps that share 16 rows, each taking D / split head dims of S's sum and of O: 2 at
// D = 256, where one block of 4 warps fills an SM's shared memory
template <int D> __host__ __device__ constexpr int fp32_split() { return D > 128 ? 2 : 1; }
template <int D> __host__ __device__ constexpr int fp32_threads() {
  return F_THREADS * fp32_split<D>();
}

template <int D> constexpr int fp32_smem_bytes() {
  return (F_BQ * (D + 8) + 2 * F_BK * (D + 8) + 2 * F_BK * (D + 4) +
          (fp32_split<D>() > 1 ? fp32_threads<D>() * F_BK / 2 : 0)) * (int)sizeof(float);
}

template <int D, int VEC>
__global__ void __launch_bounds__(fp32_threads<D>(), fp32_min_blocks<D>())
flash_fwd_tf32x3_kernel(const Args a) {
  constexpr int QP = D + 8, KP = D + 8, VP = D + 4;   // row pitches (floats)
  constexpr int NT = F_BK / 8;                        // S fragments (8 keys each) a warp
  constexpr int SPLIT = fp32_split<D>(), THREADS = fp32_threads<D>();
  constexpr int DH = D / SPLIT;                       // head dims a warp sums S over, of O
  constexpr int NO = DH / 8;                          // O fragments (8 columns each)
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + F_BQ * QP;                         // 2 stages
  float* sV = sK + 2 * F_BK * KP;                     // 2 stages
  float* sS = sV + 2 * F_BK * VP;                     // split: each warp's partial S

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;              // fragment row group, lane in group
  const int r0 = (warp % 4) * 16;                     // this warp's first row in the tile
  const int d0 = (warp / 4) * DH;                     // and its first head dim

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // KV tiles that hold at least one unmasked key for some row of this q tile
  const int q_start = qt * F_BQ + a.q_offset;        // absolute position of row 0
  const int nk = (a.Skv + F_BK - 1) / F_BK;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (q_start + F_BQ - 1) / F_BK + 1);
  int kt_begin = 0;
  if (a.window > 0) kt_begin = max(0, q_start - a.window + 1) / F_BK;

  load_rows<F_BQ, D, VEC, THREADS>(sQ, QP, q, a.q_ss, qt * F_BQ, a.Sq, a.d);
  if (kt_begin < kt_end) {
    load_rows<F_BK, D, VEC, THREADS>(sK, KP, k, a.k_ss, kt_begin * F_BK, a.Skv, a.d);
    load_rows<F_BK, D, VEC, THREADS>(sV, VP, v, a.v_ss, kt_begin * F_BK, a.Skv, a.d);
  }
  cp_async_commit();

  // this thread's rows: r0 + g (fragment elements 0, 1) and r0 + g + 8 (2, 3)
  const int qi[2] = {q_start + r0 + g, q_start + r0 + g + 8};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {     // the next tile into the other stage, then wait for this one
      load_rows<F_BK, D, VEC, THREADS>(sK + (stage ^ 1) * F_BK * KP, KP, k, a.k_ss,
                                       (kt + 1) * F_BK, a.Skv, a.d);
      load_rows<F_BK, D, VEC, THREADS>(sV + (stage ^ 1) * F_BK * VP, VP, v, a.v_ss,
                                       (kt + 1) * F_BK, a.Skv, a.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cK = sK + stage * F_BK * KP;
    const float* cV = sV + stage * F_BK * VP;

    // S = Q K^T: s[j] holds keys 8j + 2t, 8j + 2t + 1 of rows g and g + 8, summed in fp32
    // over blocks of F_KB head dims
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int k0 = d0; k0 < d0 + DH; k0 += F_KB) {
      float big[NT][4], small[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[j][e] = small[j][e] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + F_KB; kk += 8) {
        const float2 q0 = *reinterpret_cast<const float2*>(&sQ[(r0 + g) * QP + kk + 2 * t]);
        const float2 q1 =
            *reinterpret_cast<const float2*>(&sQ[(r0 + g + 8) * QP + kk + 2 * t]);
        uint32_t ah[4], al[4];
        split_tf32(q0.x, ah[0], al[0]);
        split_tf32(q1.x, ah[1], al[1]);
        split_tf32(q0.y, ah[2], al[2]);
        split_tf32(q1.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float2 kv =
              *reinterpret_cast<const float2*>(&cK[(8 * j + g) * KP + kk + 2 * t]);
          uint32_t bh[2], bl[2];
          split_tf32(kv.x, bh[0], bl[0]);
          split_tf32(kv.y, bh[1], bl[1]);
          mma_3xtf32(big[j], small[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += big[j][e] + small[j][e];
    }
    if constexpr (SPLIT > 1) {   // the two warps of a row group add their halves of S
      float* mine = sS + warp * NT * 4 * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32] = s[j][e];
      __syncthreads();
      const float* other = sS + (warp ^ 4) * NT * 4 * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += other[(j * 4 + e) * 32];
    }

    // scale, mask, online softmax update
    const int k_start = kt * F_BK;
    const bool edge = k_start + F_BK > a.Skv || (a.causal && k_start + F_BK - 1 > q_start) ||
                      (a.window > 0 && q_start + F_BQ - 1 - k_start >= a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * a.scale;
        if (edge) {
          const int ki = k_start + 8 * j + 2 * t + (e & 1);
          bool ok = ki < a.Skv;
          if (a.causal) ok = ok && ki <= qi[r];
          if (a.window > 0) ok = ok && (qi[r] - ki) < a.window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: S's fragment j is P's A fragment for keys 8j..8j+7 in the permuted order;
    // each O fragment takes the tile's sum in fresh fragments, then adds it in fp32
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32(s[j][0], ph[j][0], pl[j][0]);
      split_tf32(s[j][2], ph[j][1], pl[j][1]);
      split_tf32(s[j][1], ph[j][2], pl[j][2]);
      split_tf32(s[j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* v0 = cV + (8 * j + 2 * t) * VP + d0 + 8 * n + g;
        uint32_t bh[2], bl[2];
        split_tf32(v0[0], bh[0], bl[0]);
        split_tf32(v0[VP], bh[1], bl[1]);
        mma_3xtf32(big, small, ph[j], pl[j], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += big[e] + small[e];
    }
    __syncthreads();   // every warp is done with this stage before it takes tile kt + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qt * F_BQ + r0 + g + 8 * r;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + (long long)row * a.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = d0 + 8 * n + 2 * t;
      if (col < a.d) orow[col] = acc[n][2 * r] / denom;
      if (col + 1 < a.d) orow[col + 1] = acc[n][2 * r + 1] / denom;
    }
  }
}

template <int D, int VEC>
cudaError_t launch_fp32(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = fp32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + F_BQ - 1) / F_BQ, a.H, B);
  flash_fwd_tf32x3_kernel<D, VEC><<<grid, fp32_threads<D>(), smem, stream>>>(a);
  return cudaGetLastError();
}

// 16-byte copies need every (batch, head) slice's base 16-byte aligned and its rows too
bool fp32_vec4(const Args& a) {
  const bool bases = (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v)) % 16 == 0;
  const long long strides = a.q_sb | a.q_ss | a.q_sh | a.k_sb | a.k_ss | a.k_sh |
                            a.v_sb | a.v_ss | a.v_sh;
  return bases && strides % 4 == 0 && a.d % 4 == 0;
}

template <int D>
cudaError_t launch_fp32_any(const Args& a, int B, cudaStream_t stream) {
  return fp32_vec4(a) ? launch_fp32<D, 4>(a, B, stream) : launch_fp32<D, 1>(a, B, stream);
}

cudaError_t dispatch_fp32(const Args& a, int B, cudaStream_t stream) {
  if (a.d <= 64) return launch_fp32_any<64>(a, B, stream);
  if (a.d <= 128) return launch_fp32_any<128>(a, B, stream);
  if (a.d <= 256) return launch_fp32_any<256>(a, B, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------------------
// The tensor-core kernel: bf16, compiled per padded head dim D (64, 128, 256) and the keys
// per KV tile BN beside it (128, 128, 64).

constexpr int TC_BM = 128;        // query rows per block: 64 per consumer warpgroup
// K/V stages in flight: as many as shared memory holds beside Q
template <int D> __host__ __device__ constexpr int tc_stages() {
  return D <= 64 ? 4 : D <= 128 ? 3 : 2;
}
constexpr int TC_THREADS = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int ROW_BYTES = 128;    // a row of a 64-column chunk of a bf16 tile (the swizzle)
constexpr float LOG2E = 1.4426950408889634f;

struct TcArgs {
  void* o;
  long long o_sb, o_ss, o_sh;
  int Sq, Skv, G, d, causal, window, q_offset, nq;
  float scale_log2;              // scale * log2(e): the softmax runs in base 2
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// TMA: the map's box {64 columns, 128 or BN rows, 1, 1} at coordinates {c0, c1, c2, c3} into `dst`;
// its bytes count against the barrier's expected transactions.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout type 1 in bits
// 62-63); offsets in bytes, stored in 16-byte units.  K-major (Q, K): rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), LBO unused.  MN-major (V): SBO is the stride of
// 8-key groups (1024 bytes) and LBO that of the 64-column chunks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a wgmma operand register across the
// wait that ends the asynchronous product.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// 2^x in one MUFU operation (relative error ~2^-22; 2^-1e30 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to bf16 (to nearest, ties away; x >= 0 and finite), as fp32 bits: the bf16
// value in the upper half, zeros below.  Integer operations, no conversion unit.
__device__ __forceinline__ uint32_t bf16_hi_bits(float x) {
  return (__float_as_uint(x) + 0x8000u) & 0xFFFF0000u;
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16x2 fragments), B from
// shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (bf16x2 fragments), B from
// shared memory MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) reg_fence(r[j]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(r[kk][e]);
}

// S = Q K^T for this warpgroup's 64 rows and BN keys: D/16 steps of 16 columns; a step
// moves +32 bytes inside a 64-column chunk, and the chunks of Q (128 rows) and K (BN rows)
// lie TC_BM * 128 and BN * 128 bytes apart.
template <int D, int BN>
__device__ __forceinline__ void mma_qk(float (&sc)[BN / 2], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t dq = sw128_desc(q_addr + (kk / 4) * TC_BM * ROW_BYTES + (kk % 4) * 32, 16, 1024);
    const uint64_t dk = sw128_desc(k_addr + (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32, 16, 1024);
    if constexpr (BN == 128) wgmma_ss_n128(sc, dq, dk, kk > 0);
    else wgmma_ss_n64(sc, dq, dk, kk > 0);
  }
}

// O += A V for the 16 keys of one step at v_addr (MN-major, 64-column chunks BN * 128
// bytes apart); at D = 256 O is two m64n128 halves, the second from V's chunks 2 and 3.
template <int D, int BN>
__device__ __forceinline__ void pv_step(float (&o)[D / 2], const uint32_t (&a)[4],
                                        uint32_t v_addr) {
  constexpr uint32_t CHUNK = BN * ROW_BYTES;
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, sw128_desc(v_addr, CHUNK, 1024));
  } else if constexpr (D == 128) {
    wgmma_rs_n128(o, a, sw128_desc(v_addr, CHUNK, 1024));
  } else {
    static_assert(D == 256, "head dims are padded to 64, 128 or 256");
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, sw128_desc(v_addr, CHUNK, 1024));
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a,
                  sw128_desc(v_addr + 2 * CHUNK, CHUNK, 1024));
  }
}

// O += P_hi V + P_lo V: 16 keys a step, 2048 bytes into each chunk of V.
template <int D, int BN>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2], const uint32_t (&p_hi)[BN / 16][4],
                                       const uint32_t (&p_lo)[BN / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) pv_step<D, BN>(o, p_hi[kk], v_addr + kk * 2048);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) pv_step<D, BN>(o, p_lo[kk], v_addr + kk * 2048);
}

// Whether the KV tile at k0 needs the element mask: it crosses the diagonal, the
// window's edge or Skv (for any row of the block's 128).
template <int BN>
__device__ __forceinline__ bool edge_tile(const TcArgs& a, int k0, int qa0) {
  return k0 + BN > a.Skv || (a.causal && k0 + BN - 1 > qa0) ||
         (a.window > 0 && qa0 + TC_BM - 1 - k0 >= a.window);
}

// Lane 0 of each warp tells the producer that the warp is done with a buffer.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Online softmax of one thread's two rows over BN keys (S accumulator fragments: element
// j is row r0 + 8 * ((j >> 1) & 1), column (j >> 2) * 8 + col0 + (j & 1)), in base 2.
template <int BN>
struct Softmax {
  int qa_r0, col0;
  float scale_log2;
  float m[2];          // running max of the scaled scores
  float l[2];          // this thread's partial row sums

  // Scores -> P in place (fp32), m and l updated; alpha: how much O must shrink.
  __device__ __forceinline__ void step(float (&sc)[BN / 2], float (&alpha)[2], bool edge,
                                       int k0, const TcArgs& a) {
    float mx[2] = {NEG_INF, NEG_INF};
    if (edge) {
      // row r keeps keys k0 + col0 + c with lo[r] <= c <= hi[r]; c is (j >> 2) * 8 + (j & 1)
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = qa_r0 + r * 8, base = k0 + col0;
        hi[r] = (a.causal ? min(qi, a.Skv - 1) : a.Skv - 1) - base;
        lo[r] = a.window > 0 ? qi - a.window + 1 - base : -BN;
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        const int c = (j >> 2) * 8 + (j & 1), r = (j >> 1) & 1;
        const float x = (c >= lo[r] && c <= hi[r]) ? sc[j] * scale_log2 : NEG_INF;
        sc[j] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        sc[j] *= scale_log2;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      sc[j] = ex2(sc[j] - m[(j >> 1) & 1]);
      sum[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
  }
};

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
}

// P = P_hi + P_lo as bf16x2 A fragments (fragment e of 16-key step kk holds elements
// 8 kk + 2 e and + 1): P_hi rounded to nearest, P_lo the rest truncated, so P keeps
// < 2^-15 of relative error instead of bf16's 2^-9.
template <int BN>
__device__ __forceinline__ void split_p(const float (&p)[BN / 2], uint32_t (&p_hi)[BN / 16][4],
                                        uint32_t (&p_lo)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = p[kk * 8 + e * 2], x1 = p[kk * 8 + e * 2 + 1];
      const uint32_t h0 = bf16_hi_bits(x0), h1 = bf16_hi_bits(x1);
      p_hi[kk][e] = __byte_perm(h0, h1, 0x7632);      // the upper halves: bf16 pairs
      p_lo[kk][e] = __byte_perm(__float_as_uint(x0 - __uint_as_float(h0)),
                                __float_as_uint(x1 - __uint_as_float(h1)), 0x7632);
    }
}

// One block per (128-row q tile, head, batch); the heaviest causal tiles launch first.
// Shared memory (1024-byte aligned): Q [D/64][128 rows][128 B], then STAGES x (K, V), each
// [D/64][BN rows][128 B], then the barriers (q_full, k_full[], v_full[], k_empty[],
// v_empty[]).  Every tile is stored as TMA's 128-byte swizzle lays it out, which is what
// the wgmma descriptors read.
template <int D, int BN>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  constexpr int NC = D / 64;                   // 64-column chunks of a row
  constexpr int Q_CHUNK = TC_BM * ROW_BYTES;   // bytes of one chunk of the Q tile
  constexpr int KV_CHUNK = BN * ROW_BYTES;     // ... of a K or V tile
  constexpr int Q_TILE = NC * Q_CHUNK, KV_TILE = NC * KV_CHUNK;
  constexpr int STAGES = tc_stages<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + Q_TILE;                   // stage s at sK + s * 2 * KV_TILE
  uint64_t* bars = reinterpret_cast<uint64_t*>(sK + 2 * STAGES * KV_TILE);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int qt = a.nq - 1 - blockIdx.z;        // reversed: the longest causal rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = qt * TC_BM;
  const int qa0 = q0 + a.q_offset;             // absolute position of the tile's row 0
  const int nk = (a.Skv + BN - 1) / BN;
  int kt_end = nk;
  if (a.causal) kt_end = min(nk, (qa0 + TC_BM - 1) / BN + 1);
  int kt_begin = 0;
  if (a.window > 0) kt_begin = max(0, qa0 - a.window + 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);               // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread starts every TMA load; a stage's K is refilled once
    // its S is computed, its V once its P V is
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const int kvh = h / a.G;
      mbar_expect_tx(q_full, Q_TILE);
#pragma unroll
      for (int c = 0; c < NC; ++c) tma_load_4d(sQ + c * Q_CHUNK, &tq, q_full, 64 * c, q0, h, b);
      for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;  // lap 0 passes: stages start empty
        uint8_t* k_s = sK + s * 2 * KV_TILE;
        uint8_t* v_s = k_s + KV_TILE;
        mbar_wait(&k_empty[s], free_parity);
        mbar_expect_tx(&k_full[s], KV_TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(k_s + c * KV_CHUNK, &tk, &k_full[s], 64 * c, kt * BN, kvh, b);
        mbar_wait(&v_empty[s], free_parity);
        mbar_expect_tx(&v_full[s], KV_TILE);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(v_s + c * KV_CHUNK, &tv, &v_full[s], 64 * c, kt * BN, kvh, b);
      }
    }
  } else {
    // consumer warpgroups: S = Q K^T and O += P V on wgmma, softmax in fp32 registers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows r0, r0 + 8
    Softmax<BN> sm{qa0 + r0, (lane % 4) * 2, a.scale_log2, {NEG_INF, NEG_INF}, {0.f, 0.f}};

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float sc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];     // P of a tile as bf16x2 A fragments
    float alpha[2];

    const uint32_t q_addr = smem_u32(sQ) + wg * 64 * ROW_BYTES;
    const uint32_t kv_base = smem_u32(sK);
    const int n = kt_end - kt_begin;
    mbar_wait(q_full, 0);

    // tile i's S = Q K^T is started with tile i-1's O += P V; tile i's softmax runs while
    // the P V product does
    if (n > 0) {
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      mma_qk<D, BN>(sc, q_addr, kv_base);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(&k_empty[0], lane);
      sm.step(sc, alpha, edge_tile<BN>(a, kt_begin * BN, qa0), kt_begin * BN, a);
      split_p<BN>(sc, p_hi, p_lo);
    }
    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      const uint32_t k_addr = kv_base + s * 2 * KV_TILE;
      const uint32_t v_addr = kv_base + sp * 2 * KV_TILE + KV_TILE;
      mbar_wait(&k_full[s], (i / STAGES) & 1);
      mbar_wait(&v_full[sp], ((i - 1) / STAGES) & 1);
      wgmma_fence();
      mma_qk<D, BN>(sc, q_addr, k_addr);
      wgmma_commit();
      mma_pv<D, BN>(o, p_hi, p_lo, v_addr);
      wgmma_commit();
      wgmma_wait<1>();                             // S of tile i
      fence_regs(sc);
      release(&k_empty[s], lane);
      const int k0 = (kt_begin + i) * BN;
      sm.step(sc, alpha, edge_tile<BN>(a, k0, qa0), k0, a);
      wgmma_wait<0>();                             // O of tile i-1
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(&v_empty[sp], lane);
      rescale<D>(o, alpha);
      split_p<BN>(sc, p_hi, p_lo);
    }
    if (n > 0) {
      const int sp = (n - 1) % STAGES;
      mbar_wait(&v_full[sp], ((n - 1) / STAGES) & 1);
      wgmma_fence();
      mma_pv<D, BN>(o, p_hi, p_lo, kv_base + sp * 2 * KV_TILE + KV_TILE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(&v_empty[sp], lane);
    }

    float* l = sm.l;
    const int col0 = sm.col0;

    // the row sums over the 4 lanes that share a row, then O / l into the output
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = (j >> 1) & 1;
      const int row = q0 + r0 + r * 8;
      const int col = (j >> 2) * 8 + col0;
      if (row >= a.Sq || col >= a.d) continue;
      __nv_bfloat16* dst = out + (long long)row * a.o_ss + col;
      const float x0 = o[j] / l[r], x1 = o[j + 1] / l[r];
      if ((a.d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16(x0);
        if (col + 1 < a.d) dst[1] = __float2bfloat16(x1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map over [B, S, heads, d] read through its strides (elements), boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle; rows and columns past the tensor
// read as zero.  A dim of size 1 takes a stride of 16 bytes, which TMA accepts and never
// uses.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int d, int S, int heads,
              int B, long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)std::max(S, 1), (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {S > 1 ? (cuuint64_t)ss * 2 : 16,
                                 heads > 1 ? (cuuint64_t)sh * 2 : 16,
                                 B > 1 ? (cuuint64_t)sb * 2 : 16};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D, int BN>
cudaError_t launch_tc(const Args& a, int B, int K, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, a.q, a.d, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, TC_BM) ||
      !make_map(enc, &tk, a.k, a.d, a.Skv, K, B, a.k_ss, a.k_sh, a.k_sb, BN) ||
      !make_map(enc, &tv, a.v, a.d, a.Skv, K, B, a.v_ss, a.v_sh, a.v_sb, BN))
    return cudaErrorInvalidValue;
  const int nq = (a.Sq + TC_BM - 1) / TC_BM;
  const TcArgs t{a.o, a.o_sb, a.o_ss, a.o_sh, a.Sq, a.Skv, a.G, a.d,
                 a.causal, a.window, a.q_offset, nq, a.scale * LOG2E};
  constexpr int stages = tc_stages<D>();
  const int smem = 1024 + (TC_BM + 2 * stages * BN) * D * 2 + 8 * (1 + 4 * stages);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, nq);
  flash_fwd_wgmma_kernel<D, BN><<<grid, TC_THREADS, smem, stream>>>(tq, tk, tv, t);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim is contiguous.
// bf16 runs the tensor-core kernel and needs 16-byte aligned bases and strides (a multiple
// of 8 elements) for TMA; float32 runs the 3xTF32 tensor-core kernel.
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
  if (dtype == 0) return (int)dispatch_fp32(a, B, st);
  if (dtype == 1 && d <= 64) return (int)launch_tc<64, 128>(a, B, K, st);
  if (dtype == 1 && d <= 128) return (int)launch_tc<128, 128>(a, B, K, st);
  if (dtype == 1 && d <= 256) return (int)launch_tc<256, 64>(a, B, K, st);
  return (int)cudaErrorInvalidValue;
}
