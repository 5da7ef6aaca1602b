// Mamba-1 selective scan for Hopper (sm_90a): two entry points.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::_kernel (launched by
// ::mamba_scan).
//
// mamba_scan_kernel (repro_mamba_scan_fwd), the unfused scan: the time recurrence inside
// each thread.  Same function as the Pallas kernel, from h_0 = 0:
//     h_t[b,d,n] = a_bar[b,t,d,n] * h_{t-1}[b,d,n] + bx[b,t,d,n]
//     y[b,t,d]   = sum_n h_t[b,d,n] * c[b,t,n]
// all in fp32, plus the final state h_S [B, Di, N] when the caller asks for it (a null
// pointer skips that write).  The TPU kernel carries h in VMEM across a sequential chunk
// axis of its grid; Hopper runs blocks in no order, so here nothing crosses blocks: each
// thread owns one state element (b, d, n) and runs the whole time loop itself.
//
// What bounds it on this card.  Each element of a_bar and bx is read once and used for two
// flops, so at the serving shape (B=4, S=1024, Di=8192, N=16) one call moves ~4.4 GB for
// ~2 GFLOP: bound by memory bandwidth (~1.3 ms at 3.35 TB/s).  What the design does about it:
//   * P lanes per channel d (P = N rounded up to a power of two, at most 32): the
//     [.., Di, N] layout puts (d, n) contiguous, so a warp's loads of one timestep are one
//     contiguous 128-byte run of a_bar and one of bx;
//   * one thread per (b, d, n) gives B*Di*P threads (524,288 at the serving shape), enough
//     warps to keep the bytes in flight that the memory needs;
//   * the time loop loads U timesteps before it uses them, so each thread has U loads of
//     each input in flight; a_bar and bx are read with streaming loads (read once), c
//     through the read-only path (shared by every d of a batch row);
//   * y's sum over n is a butterfly of warp shuffles inside the P lanes of a channel, and
//     lane 0 writes it;
//   * offsets are 64-bit: a_bar and bx hold 2^29 elements at the serving shape.
// cp.async/TMA prefetch of later timesteps is later work.
//
// mamba_scan_fused_kernel (repro_mamba_scan_fused_fwd), the scan with its discretisation
// and the Mamba mixer's elementwise work on either side of it fused: what the model
// computes with _ssm_inputs (src/repro/models/ssm.py:44-61), the Pallas kernel and the
// mixer's gated output, from the raw dt projection and the scan's other inputs:
//     delta = softplus(dt[b,t,d] + delta_bias[d])
//     a_bar = exp(delta * A[d,n]),  bx = (delta * x[b,t,d]) * B[b,t,n]
//     h_t = a_bar * h_{t-1} + bx,   y[b,t,d] = sum_n h_t * C[b,t,n]
//     out[b,t,d] = (y + D[d] * x) * silu(z[b,t,d])
// in that order of products, in fp32 (dt, x and z bf16 or fp32, widened in registers),
// out in x's dtype, plus h_S.  What bounds it: the bytes of dt, x, z and out ([B, S, Di])
// and of B and C ([B, S, N]), ~0.23 GB a falcon-mamba-7b layer (1 x 3444, Di 8192, bf16)
// against ~3.6 GB of a_bar and bx that the unfused scan reads after the model wrote them,
// so ~0.07 ms at 3.35 TB/s; under that the expf and the products of every (b, t, d, n).
// What the design does about it:
//   * a_bar and bx are made in registers and never touch device memory;
//   * one thread per (b, d) carries the channel's P states (P = N rounded up to a power of
//     two) in registers, so y's sum over n is a register sum, not a shuffle tree, and each
//     step's delta and x are loaded once per channel; a block of 128 channels stages 32
//     timesteps at a time in shared memory: delta and x as coalesced rows, B and C (shared
//     by every channel of a batch row) read back as broadcasts;
//   * time split into chunks where one pass's B * ceil(Di / 128) blocks cannot fill the
//     card (a mesh divides Di by `model`, so every sharded prefill runs such shapes):
//     pass 1 runs each chunk but
//     the last from h = 0 and keeps its end state and the product of its a_bar; pass 2
//     starts each chunk from the state carried through the chunks before it (a short
//     sequential loop over them: h <- prod_c * h + end_c) and writes y, and the last chunk
//     h_S.  The chunk count comes from the shape and the SM count (the wrapper's
//     kernels/mamba_scan.py::scan_chunks), so the card's threads are filled.
//
// The mixer's work, which would otherwise be separate passes over [B, S, Di] tensors, is
// done where the kernel already holds each (t, d):
//   * prologue: each staged dt becomes softplus(dt + delta_bias[d]) in fp32 (torch's
//     softplus: v > 20 ? v : log1p(exp(v))), in every pass;
//   * epilogue: in place of y the kernel writes (y + D[d] * x) * silu(z) in x's dtype,
//     with the mixer's ops' roundings: y + x * D in fp32 (no fused multiply-add), it and
//     silu(z) (torch's x / (1 + exp(-x))) rounded to x's dtype, their product rounded
//     again, so the kernel gives the bits of a scan followed by those ops.  z is read in
//     place through its own batch and row strides (the gate half of in_proj's output).
// Both stay off the recurrence's chain: z is staged with dt and x (x and z in x's dtype,
// so bf16 stages take 36 KB of shared memory); after the loads each thread turns its own
// column of the stage's dt into delta, steps that wait on no other; during the scan it
// parks each y in the slot of delta it has consumed, and after it gates the stage's y
// from there.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int U = 4;           // timesteps loaded ahead

template <int P>
__global__ void __launch_bounds__(NTHREADS)
mamba_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                  const float* __restrict__ c, float* __restrict__ y,
                  float* __restrict__ h_out, int S, int Di, int N) {
  const int b = blockIdx.y;
  const long long d = ((long long)blockIdx.x * NTHREADS + threadIdx.x) / P;
  const int n = threadIdx.x % P;
  const bool valid = d < Di;
  // every lane of a channel's P-lane group shares `valid`, so the shuffles below only ever
  // name lanes that take part
  const unsigned mask = __ballot_sync(0xffffffffu, valid);
  if (!valid) return;
  const bool live = n < N;     // lanes past N hold h = 0 and add nothing to y

  const long long DN = (long long)Di * N;
  const long long off = (long long)b * S * DN + d * N + n;
  const float* pa = a + off;
  const float* pb = bx + off;
  const float* pc = c + (long long)b * S * N + n;
  float* py = y + (long long)b * S * Di + d;

  float h = 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U], cv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = live ? __ldcs(pa + (long long)(t + u) * DN) : 0.f;
      bv[u] = live ? __ldcs(pb + (long long)(t + u) * DN) : 0.f;
      cv[u] = live ? __ldg(pc + (long long)(t + u) * N) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = av[u] * h + bv[u];
      float v = h * cv[u];
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, P);
      if (n == 0) py[(long long)(t + u) * Di] = v;
    }
  }
  for (; t < S; ++t) {
    const float at = live ? __ldcs(pa + (long long)t * DN) : 0.f;
    const float bt = live ? __ldcs(pb + (long long)t * DN) : 0.f;
    const float ct = live ? __ldg(pc + (long long)t * N) : 0.f;
    h = at * h + bt;
    float v = h * ct;
#pragma unroll
    for (int o = P / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, P);
    if (n == 0) py[(long long)t * Di] = v;
  }
  if (h_out != nullptr && live) h_out[((long long)b * Di + d) * N + n] = h;
}

template <int P>
cudaError_t launch(const float* a, const float* bx, const float* c, float* y, float* h_out,
                   int B, int S, int Di, int N, cudaStream_t stream) {
  const long long threads = (long long)Di * P;
  const dim3 grid((unsigned)((threads + NTHREADS - 1) / NTHREADS), (unsigned)B);
  mamba_scan_kernel<P><<<grid, NTHREADS, 0, stream>>>(a, bx, c, y, h_out, S, Di, N);
  return cudaGetLastError();
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to T's precision, in fp32
template <typename T> __device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

struct Fused {
  const void* dt; const void* x; const float* A; const float* Bm; const float* C;
  void* y; float* h_out;
  float* carry_h; float* carry_p;    // [chunks - 1, B, Di, N]: each chunk's end state from
                                     // h = 0 and its a_bar product (pass 1), else null
  // delta_bias and D [Di] fp32, z [B, S, Di] in x's dtype at (z_batch, z_row, 1) strides
  const float* delta_bias; const float* D; const void* z;
  long long z_batch, z_row;
  int S, Di, N, chunk;
};

constexpr int FT = 128;        // fused kernel: threads (channels) a block; as
                               // kernels/mamba_scan.py's CHANNELS_PER_BLOCK
constexpr int TS = 32;         // timesteps staged in shared memory at a time

// MODE 0: the whole sequence in one chunk (y and h_S); 1: pass 1 (carry_h, carry_p of
// chunk blockIdx.z); 2: pass 2 (chunk blockIdx.z from its carried-in state: y, and h_S
// from the last chunk).  One thread per (b, d): the channel's P states in registers.
// dt, x, z and y in XT.
template <int P, typename XT, int MODE>
__global__ void __launch_bounds__(FT)
mamba_scan_fused_kernel(const Fused f) {
  constexpr bool GATE_OUT = MODE != 1;      // pass 1 writes no y
  // timesteps a stage: fp32 x and z staged beside delta would pass 48 KB at 32
  constexpr int T = (GATE_OUT && sizeof(XT) == 4) ? TS / 2 : TS;
  __shared__ __align__(16) float sB[T][P];
  __shared__ __align__(16) float sC[T][P];
  __shared__ float sD[T][FT];
  __shared__ XT sX[T][FT];
  __shared__ XT sZ[GATE_OUT ? T : 1][FT];
  const int b = blockIdx.y, ck = blockIdx.z, B = gridDim.y;
  const long long d0 = (long long)blockIdx.x * FT, d = d0 + threadIdx.x;
  const bool valid = d < f.Di;
  const long long BDN = (long long)B * f.Di * f.N;
  const long long state = ((long long)b * f.Di + d) * f.N;          // [B, Di, N] at n = 0
  const int t0 = ck * f.chunk, t1 = min(f.S, t0 + f.chunk);

  // states past N (and channels past Di) have a = 0, B = C = 0: h stays 0, adds nothing
  float a[P], h[P], prod[P];
#pragma unroll
  for (int n = 0; n < P; ++n) {
    a[n] = (valid && n < f.N) ? __ldg(f.A + d * f.N + n) : 0.f;
    h[n] = 0.f;
    prod[n] = 1.f;
  }
  if (MODE == 2 && valid)
    for (int c = 0; c < ck; ++c)
#pragma unroll
      for (int n = 0; n < P; ++n)
        if (n < f.N)
          h[n] = f.carry_p[c * BDN + state + n] * h[n] + f.carry_h[c * BDN + state + n];

  const long long row = (long long)b * f.S;
  const XT* x = static_cast<const XT*>(f.x);
  const XT* dtp = static_cast<const XT*>(f.dt);
  const XT* z = static_cast<const XT*>(f.z) + b * f.z_batch + d;
  XT* yo = static_cast<XT*>(f.y);
  float bias = 0.f, dskip = 0.f;
  if (valid) {
    bias = __ldg(f.delta_bias + d);
    dskip = __ldg(f.D + d);
  }
  for (int ts = t0; ts < t1; ts += T) {
    const int nt = min(T, t1 - ts);
    __syncthreads();               // the previous stage is consumed
    for (int i = threadIdx.x; i < T * P; i += FT) {
      const int tt = i / P, n = i % P;
      const bool ok = tt < nt && n < f.N;
      const long long at = (row + ts + tt) * f.N + n;
      sB[tt][n] = ok ? __ldg(f.Bm + at) : 0.f;
      if (MODE != 1) sC[tt][n] = ok ? __ldg(f.C + at) : 0.f;
    }
    for (int tt = 0; tt < nt; ++tt) {   // coalesced rows of dt, x and z
      const long long at = (row + ts + tt) * f.Di + d;
      sD[tt][threadIdx.x] = valid ? widen(__ldg(dtp + at)) : 0.f;
      sX[tt][threadIdx.x] = valid ? x[at] : narrow<XT>(0.f);
      if constexpr (GATE_OUT) sZ[tt][threadIdx.x] = valid ? z[(ts + tt) * f.z_row]
                                                          : narrow<XT>(0.f);
    }
    // delta: this thread's own column, no step waits on another
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const float v = sD[tt][threadIdx.x] + bias;
      sD[tt][threadIdx.x] = v > 20.f ? v : log1pf(expf(v));
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dt = sD[tt][threadIdx.x];
      const float dtx = dt * widen(sX[tt][threadIdx.x]);
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < P; ++n) {
        const float ab = expf(dt * a[n]);
        h[n] = ab * h[n] + dtx * sB[tt][n];
        if (MODE == 1) prod[n] *= ab;
        else y += h[n] * sC[tt][n];
      }
      if (MODE != 1 && valid) sD[tt][threadIdx.x] = y;   // its own slot, consumed above
    }
    if (GATE_OUT && valid) {
#pragma unroll 8
      for (int tt = 0; tt < nt; ++tt) {   // the mixer's ops and roundings, unfused
        const float zt = widen(sZ[tt][threadIdx.x]);
        const float v = __fadd_rn(sD[tt][threadIdx.x],
                                  __fmul_rn(widen(sX[tt][threadIdx.x]), dskip));
        const float g = zt / (1.f + expf(-zt));
        yo[(row + ts + tt) * f.Di + d] = narrow<XT>(__fmul_rn(rounded<XT>(v), rounded<XT>(g)));
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int n = 0; n < P; ++n) {
    if (n >= f.N) continue;
    if (MODE == 1) {
      f.carry_h[ck * BDN + state + n] = h[n];
      f.carry_p[ck * BDN + state + n] = prod[n];
    } else if (f.h_out != nullptr && t1 == f.S) {
      f.h_out[state + n] = h[n];
    }
  }
}

template <int P, typename XT>
cudaError_t launch_fused(const Fused& f, int B, int chunks, cudaStream_t stream) {
  const unsigned gx = (unsigned)((f.Di + FT - 1) / FT);
  if (chunks == 1) {
    mamba_scan_fused_kernel<P, XT, 0><<<dim3(gx, B, 1), FT, 0, stream>>>(f);
    return cudaGetLastError();
  }
  mamba_scan_fused_kernel<P, XT, 1><<<dim3(gx, B, chunks - 1), FT, 0, stream>>>(f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mamba_scan_fused_kernel<P, XT, 2><<<dim3(gx, B, chunks), FT, 0, stream>>>(f);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_fused(const Fused& f, int B, int chunks, cudaStream_t st) {
  if (f.N <= 4) return launch_fused<4, XT>(f, B, chunks, st);
  if (f.N <= 8) return launch_fused<8, XT>(f, B, chunks, st);
  if (f.N <= 16) return launch_fused<16, XT>(f, B, chunks, st);
  if (f.N <= 32) return launch_fused<32, XT>(f, B, chunks, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// a_bar, bx [B, S, Di, N], c [B, S, N], y [B, S, Di], h_out [B, Di, N] or null: contiguous
// fp32.  1 <= N <= 32, B >= 1, Di >= 1, S >= 0.  Returns the cudaError_t of the launch.
extern "C" int repro_mamba_scan_fwd(const float* a, const float* bx, const float* c, float* y,
                                    float* h_out, int B, int S, int Di, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 0 || Di < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return (int)launch<4>(a, bx, c, y, h_out, B, S, Di, N, st);
  if (N <= 8) return (int)launch<8>(a, bx, c, y, h_out, B, S, Di, N, st);
  if (N <= 16) return (int)launch<16>(a, bx, c, y, h_out, B, S, Di, N, st);
  if (N <= 32) return (int)launch<32>(a, bx, c, y, h_out, B, S, Di, N, st);
  return (int)cudaErrorInvalidValue;
}

// dt [B, S, Di] (the raw dt projection), x and z [B, S, Di] and y [B, S, Di], all bf16 when
// x_bf16, else fp32; A [Di, N], Bm and C [B, S, N], delta_bias and D [Di] fp32, h_out
// [B, Di, N] fp32 or null: contiguous but z, read at strides (z_batch, z_row, 1).
// `chunk` timesteps a chunk (>= 1); with more than one chunk, `scratch` holds
// 2 x (chunks - 1) x B x Di x N floats.  Returns the cudaError_t of the launches.
extern "C" int repro_mamba_scan_fused_fwd(const void* dt, const void* x, int x_bf16,
                                          const float* A, const float* Bm, const float* C,
                                          void* y, float* h_out, float* scratch,
                                          const float* delta_bias, const float* D,
                                          const void* z, long long z_batch, long long z_row,
                                          int B, int S, int Di, int N, int chunk,
                                          void* stream) {
  if (B < 1 || B > 65535 || S < 0 || Di < 1 || N < 1 || N > 32 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  if (delta_bias == nullptr || D == nullptr || (z == nullptr && S > 0))
    return (int)cudaErrorInvalidValue;
  const int chunks = S > 0 ? (S + chunk - 1) / chunk : 1;
  if (chunks > 65535 || (chunks > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  const long long BDN = (long long)B * Di * N;
  Fused f{dt, x, A, Bm, C, y, h_out,
          chunks > 1 ? scratch : nullptr, chunks > 1 ? scratch + (chunks - 1) * BDN : nullptr,
          delta_bias, D, z, z_batch, z_row, S, Di, N, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? dispatch_fused<__nv_bfloat16>(f, B, chunks, st)
                      : dispatch_fused<float>(f, B, chunks, st));
}
