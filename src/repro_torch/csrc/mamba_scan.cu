// Mamba-1 selective scan for Hopper (sm_90a): the time recurrence inside each thread.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py::_kernel (launched by
// ::mamba_scan).  Same function, from h_0 = 0:
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
// cp.async/TMA prefetch of later timesteps, and computing a_bar and bx inside the kernel
// from delta, A, B and x (which would halve the bytes the layer moves), are later work.

#include <cuda_runtime.h>
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
