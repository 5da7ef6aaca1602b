// Mamba-1 selective scan for training on Hopper (sm_90a): a forward that saves what its
// backward needs, and the backward.
//
// Replaces no TPU kernel: the reference's Pallas kernel (src/repro/kernels/mamba_scan.py::
// _kernel) is forward only, and the reference trains through an XLA associative scan
// (src/repro/models/ssm.py, `apply_ssm`).  The port's plain training scan
// (src/repro_torch/models/ssm.py::scan_chunked and scan_inloop) is that scan in ~10^4 small
// PyTorch ops a layer, which leave the card idle while the host dispatches them and move
// two [B, S, Di, N] fp32 tensors through device memory three times a layer.  This pair
// computes the same function and its gradients in three launches:
//
//     a_bar = exp(delta[b,t,d] * A[d,n]),  bx = (delta[b,t,d] * x[b,t,d]) * B[b,t,n]
//     h_t = a_bar * h_{t-1} + bx (h_0 = 0), y[b,t,d] = sum_n h_t * C[b,t,n]
//
// in that order of products, in fp32 (x bf16 or fp32, widened in registers), as the fused
// prefill kernel (csrc/mamba_scan.cu, mamba_scan_fused_kernel) computes it.  Prefill and
// training want different things (the prefill keeps every state in registers and writes
// none; training writes states and needs a reverse pass), so the pair has its own source
// and build, and the prefill's kernel is untouched.
//
// Both kernels give a channel's P states (P = N rounded up to a power of two) to P / 4
// neighbouring lanes, 4 states a thread in registers, and a block 32 channels: at
// falcon-mamba-7b's micro-batch (B 2 x Di 8192) one thread a channel would leave ~4 warps an
// SM, too few to hide the latency of expf, shared memory and the shuffles.
//
// mamba_scan_train_fwd_kernel (repro_mamba_scan_train_fwd) writes y (each channel's sum
// over its lanes by shuffles), h_S when asked, and the state at the start of every chunk
// of CH timesteps, fp32 [B, S/CH, Di, N] (the chunk index before the channel, so that a
// block writes its channels' states as one contiguous run).  CH = min(32, 256 / P): 16 at
// N = 16.  What bounds it: the expf and the products of every (b, t, d, n) (~537 M terms a
// falcon-mamba-7b micro-batch layer), then the bytes of delta, x, y and the states.
//
// mamba_scan_train_bwd_kernel (repro_mamba_scan_train_bwd): for each chunk, last to first,
// it reloads the chunk's start state, recomputes the chunk's CH states into shared memory
// (CH * P * 32 floats = 32 KB a block, never device memory), then walks the chunk in
// reverse carrying
//     g_t = dy_t * C_t + a_bar_{t+1} * g_{t+1}    (g_{S-1} also takes dh_S)
// and makes, per step,
//     ddelta_t = sum_n g_t h_{t-1} a_bar_t A + x_t sum_n g_t B_t,  dx_t = delta_t sum_n g_t B_t
// (the sums over n a channel's lanes' by shuffles; dx rounded once to x's dtype), dA's
// per-(b, d) sum in registers, and each step's dB_t = sum_d g_t delta_t x_t and dC_t =
// sum_d dy_t h_t: within a warp by a butterfly of shuffles that halves the values a lane
// holds at each level, then over the block's warps in warp order through shared memory.
// Nothing is summed with float atomics: dB, dC (per block of channels) and dA (per batch
// row) go out as fp32 partials, and mamba_scan_train_sum_kernel adds them in a fixed
// order, so two runs give the same bits.  What bounds it: two expf and ~25 products and
// adds a (b, t, d, n) term; the partials ([Di / 32, B, S, N] fp32, twice) and the states
// are read and written once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int Q = 4;          // states a thread: a channel's P states over P / Q lanes
constexpr int CPB = 32;       // channels a block (P / Q warps)
constexpr int TS = 32;        // forward: timesteps staged in shared memory at a time

__host__ __device__ constexpr int chunk_of(int P) { return 256 / P < 32 ? 256 / P : 32; }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The sum of v over the L lanes of a channel (neighbouring lanes), on each of them.
template <int L>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Fwd {
  const float* delta; const void* x; const float* A; const float* Bm; const float* C;
  float* y; float* h_out; float* states;     // states [B, chunks, Di, N]
  int S, Di, N, chunks;
};

// Stage rows [t0, t0 + nt) of the block's channels of a [B, S, Di] tensor (coalesced:
// neighbouring threads read neighbouring channels), zeros past nt and past Di.
template <int T, int ROWS, typename V>
__device__ __forceinline__ void stage_rows(float (*dst)[CPB], const V* src, long long row,
                                           int t0, int nt, long long d0, int Di) {
  for (int i = threadIdx.x; i < ROWS * CPB; i += T) {
    const int tt = i / CPB, cc = i % CPB;
    const bool ok = tt < nt && d0 + cc < Di;
    dst[tt][cc] = ok ? widen(src[(row + t0 + tt) * Di + d0 + cc]) : 0.f;
  }
}

// The same for a [B, S, N] tensor's rows, P wide.
template <int T, int ROWS, int P>
__device__ __forceinline__ void stage_states(float (*dst)[P], const float* src, long long row,
                                             int t0, int nt, int N) {
  for (int i = threadIdx.x; i < ROWS * P; i += T) {
    const int tt = i / P, n = i % P;
    dst[tt][n] = (tt < nt && n < N) ? __ldg(src + (row + t0 + tt) * N + n) : 0.f;
  }
}

template <int P, typename XT>
__global__ void __launch_bounds__(CPB * P / Q)
mamba_scan_train_fwd_kernel(const Fwd f) {
  constexpr int L = P / Q, T = CPB * L, CH = chunk_of(P);
  __shared__ __align__(16) float sB[TS][P];
  __shared__ __align__(16) float sC[TS][P];
  __shared__ float sD[TS][CPB];
  __shared__ float sX[TS][CPB];
  const int c = threadIdx.x / L, q = threadIdx.x % L, b = blockIdx.y;
  const long long d0 = (long long)blockIdx.x * CPB, d = d0 + c;
  const bool valid = d < f.Di;
  float a[Q], h[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int n = q * Q + j;
    a[j] = (valid && n < f.N) ? __ldg(f.A + d * f.N + n) : 0.f;
    h[j] = 0.f;
  }
  const long long row = (long long)b * f.S;
  for (int ts = 0; ts < f.S; ts += TS) {
    const int nt = min(TS, f.S - ts);
    __syncthreads();               // the previous stage is consumed
    stage_states<T, TS, P>(sB, f.Bm, row, ts, nt, f.N);
    stage_states<T, TS, P>(sC, f.C, row, ts, nt, f.N);
    stage_rows<T, TS>(sD, f.delta, row, ts, nt, d0, f.Di);
    stage_rows<T, TS>(sX, static_cast<const XT*>(f.x), row, ts, nt, d0, f.Di);
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const int t = ts + tt;
      if (t % CH == 0 && valid) {     // the state at the start of chunk t / CH
        float* out = f.states + (((long long)b * f.chunks + t / CH) * f.Di + d) * f.N;
#pragma unroll
        for (int j = 0; j < Q; ++j)
          if (q * Q + j < f.N) out[q * Q + j] = h[j];
      }
      const float dt = sD[tt][c];
      const float dtx = dt * sX[tt][c];
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float ab = expf(dt * a[j]);
        h[j] = ab * h[j] + dtx * sB[tt][q * Q + j];
        y += h[j] * sC[tt][q * Q + j];
      }
      y = lanes_sum<L>(y);
      if (valid && q == 0) f.y[(row + t) * f.Di + d] = y;
    }
  }
  if (valid && f.h_out != nullptr) {
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (q * Q + j < f.N) f.h_out[((long long)b * f.Di + d) * f.N + q * Q + j] = h[j];
  }
}

struct Bwd {
  const float* delta; const void* x; const float* A; const float* Bm; const float* C;
  const float* states; const float* dy; const float* dh;   // dh [B, Di, N] or null
  float* ddelta; void* dx;
  float* dA_part;                    // [B, Di, N]: each batch row's sum over time
  float* dB_part; float* dC_part;    // [Di / CPB blocks, B, S, N]: each block's sum over d
  int S, Di, N, chunks;
};

// The warp's sums over its channels of v[0..2Q) (v[j]: state q*Q + j of dB, v[Q + j] of
// dC): each level halves the values a lane holds, exchanging the other half with the lane
// OFF away (another channel, the same q), from OFF = 16 down to L or until one is left.
template <int OFF, int HALF, int L>
__device__ __forceinline__ void fold(float (&v)[2 * Q], int lane) {
  if constexpr (OFF >= L && HALF >= 1) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[i] : v[i + HALF];
      const float keep = upper ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    fold<OFF / 2, HALF / 2, L>(v, lane);
  }
}

template <int P>
constexpr int bwd_smem_floats() {
  constexpr int L = P / Q, T = CPB * L, CH = chunk_of(P);
  // sH [CH][Q][T], sB and sC [CH][P], sD, sX and sG [CH][CPB], sR [CH][T / 32][2P]
  return CH * Q * T + 2 * CH * P + 3 * CH * CPB + CH * (T / 32) * 2 * P;
}

template <int P, typename XT>
__global__ void __launch_bounds__(CPB * P / Q)
mamba_scan_train_bwd_kernel(const Bwd f) {
  constexpr int L = P / Q, T = CPB * L, W = T / 32, CH = chunk_of(P);
  // the fold levels (channel bits of the lane) that halve the 2Q values, and what is left
  constexpr int CB = 5 - (L == 1 ? 0 : L == 2 ? 1 : L == 4 ? 2 : 3);
  constexpr int FL = CB < 3 ? CB : 3, R = (2 * Q) >> FL;
  extern __shared__ float smem[];
  float (*sH)[Q][T] = reinterpret_cast<float (*)[Q][T]>(smem);   // state before each step
  float (*sB)[P] = reinterpret_cast<float (*)[P]>(smem + CH * Q * T);
  float (*sC)[P] = sB + CH;
  float (*sD)[CPB] = reinterpret_cast<float (*)[CPB]>(smem + CH * Q * T + 2 * CH * P);
  float (*sX)[CPB] = sD + CH;
  float (*sG)[CPB] = sX + CH;                                       // dy
  float (*sR)[W][2 * P] = reinterpret_cast<float (*)[W][2 * P]>(sG + CH);
  const int tid = threadIdx.x, c = tid / L, q = tid % L, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y, B = gridDim.y;
  const long long d0 = (long long)blockIdx.x * CPB, d = d0 + c;
  const bool valid = d < f.Di;
  const long long state = ((long long)b * f.Di + d) * f.N + q * Q;   // [B, Di, N]
  // states past N (and channels past Di) have A = 0, B = C = 0 and dh = 0: their h and g
  // stay 0 and add nothing
  float a[Q], g[Q], dA[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const bool on = valid && q * Q + j < f.N;
    a[j] = on ? __ldg(f.A + d * f.N + q * Q + j) : 0.f;
    g[j] = (on && f.dh != nullptr) ? __ldg(f.dh + state + j) : 0.f;
    dA[j] = 0.f;
  }
  // where this lane's folded sums go in sR, and whether it holds them (lanes that differ
  // only in the channel bits summed after the fold hold the same sums)
  int kbase = 0;
  bool rep = true;
#pragma unroll
  for (int l = 0; l < FL; ++l)
    if (lane & (16 >> l)) kbase += Q >> l;
#pragma unroll
  for (int o = 16 >> FL; o >= L; o >>= 1) rep = rep && !(lane & o);
  const long long row = (long long)b * f.S;
  XT* dx = static_cast<XT*>(f.dx);
  const long long BSN = (long long)B * f.S * f.N;
  float* dB_part = f.dB_part + blockIdx.x * BSN;
  float* dC_part = f.dC_part + blockIdx.x * BSN;
  for (int ck = f.chunks - 1; ck >= 0; --ck) {
    const int t0 = ck * CH, nt = min(CH, f.S - t0);
    __syncthreads();               // the previous chunk's stage and sums are consumed
    stage_states<T, CH, P>(sB, f.Bm, row, t0, nt, f.N);
    stage_states<T, CH, P>(sC, f.C, row, t0, nt, f.N);
    stage_rows<T, CH>(sD, f.delta, row, t0, nt, d0, f.Di);
    stage_rows<T, CH>(sX, static_cast<const XT*>(f.x), row, t0, nt, d0, f.Di);
    stage_rows<T, CH>(sG, f.dy, row, t0, nt, d0, f.Di);
    __syncthreads();
    // the chunk's states again, from its saved start
    float h[Q];
    const float* start = f.states + (((long long)b * f.chunks + ck) * f.Di + d) * f.N + q * Q;
#pragma unroll
    for (int j = 0; j < Q; ++j) h[j] = (valid && q * Q + j < f.N) ? __ldg(start + j) : 0.f;
    for (int tt = 0; tt < nt; ++tt) {
      const float dt = sD[tt][c];
      const float dtx = dt * sX[tt][c];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        sH[tt][j][tid] = h[j];
        h[j] = expf(dt * a[j]) * h[j] + dtx * sB[tt][q * Q + j];
      }
    }
    // the chunk in reverse
    for (int tt = nt - 1; tt >= 0; --tt) {
      const float dt = sD[tt][c], xv = sX[tt][c], dyv = sG[tt][c];
      const float dtx = dt * xv;
      float v[2 * Q];
      float sgb = 0.f, sdd = 0.f;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float bn = sB[tt][q * Q + j];
        const float hp = sH[tt][j][tid];
        const float ab = expf(dt * a[j]);
        const float ht = ab * hp + dtx * bn;
        const float gt = g[j] + dyv * sC[tt][q * Q + j];
        v[j] = gt * dtx;                       // dB's term
        v[Q + j] = dyv * ht;                   // dC's term
        sgb += gt * bn;
        const float gha = gt * hp * ab;        // d(a_bar) * a_bar
        dA[j] += gha * dt;
        sdd += gha * a[j];
        g[j] = gt * ab;
      }
      sgb = lanes_sum<L>(sgb);
      sdd = lanes_sum<L>(sdd);
      if (valid && q == 0) {
        const long long at = (row + t0 + tt) * f.Di + d;
        f.ddelta[at] = sdd + xv * sgb;
        put(dx + at, dt * sgb);
      }
      fold<16, Q, L>(v, lane);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int o = 16 >> FL; o >= L; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
      if (rep) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int k = kbase + i;             // which (k / Q: dB or dC) and state k % Q
          sR[tt][warp][(k / Q) * P + q * Q + k % Q] = v[i];
        }
      }
    }
    __syncthreads();
    // the warps' sums added in warp order: the block's partial of each step's dB and dC
    for (int i = tid; i < nt * 2 * P; i += T) {
      const int tt = i / (2 * P), k = i % (2 * P), n = k % P;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) s += sR[tt][w][k];
      if (n < f.N) (k < P ? dB_part : dC_part)[(row + t0 + tt) * f.N + n] = s;
    }
  }
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (q * Q + j < f.N) f.dA_part[state + j] = dA[j];
}

// dB and dC: the blocks' partials added in block order; dA: the batch rows' in row order.
__global__ void mamba_scan_train_sum_kernel(const float* __restrict__ dB_part,
                                            const float* __restrict__ dC_part,
                                            const float* __restrict__ dA_part,
                                            float* __restrict__ dB, float* __restrict__ dC,
                                            float* __restrict__ dA, long long BSN,
                                            long long DN, int blocks, int B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < BSN) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      sb += dB_part[k * BSN + i];
      sc += dC_part[k * BSN + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  if (i < DN) {
    float s = 0.f;
    for (int k = 0; k < B; ++k) s += dA_part[k * DN + i];
    dA[i] = s;
  }
}

template <int P, typename XT>
cudaError_t fwd_p(const Fwd& f, int B, cudaStream_t st) {
  const dim3 grid((unsigned)((f.Di + CPB - 1) / CPB), (unsigned)B);
  mamba_scan_train_fwd_kernel<P, XT><<<grid, CPB * P / Q, 0, st>>>(f);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t fwd(const Fwd& f, int B, int P, cudaStream_t st) {
  switch (P) {
    case 4: return fwd_p<4, XT>(f, B, st);
    case 8: return fwd_p<8, XT>(f, B, st);
    case 16: return fwd_p<16, XT>(f, B, st);
    case 32: return fwd_p<32, XT>(f, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int P, typename XT>
cudaError_t bwd_p(const Bwd& f, int B, cudaStream_t st) {
  const size_t smem = bwd_smem_floats<P>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mamba_scan_train_bwd_kernel<P, XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((f.Di + CPB - 1) / CPB), (unsigned)B);
  mamba_scan_train_bwd_kernel<P, XT><<<grid, CPB * P / Q, smem, st>>>(f);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t bwd(const Bwd& f, int B, int P, cudaStream_t st) {
  switch (P) {
    case 4: return bwd_p<4, XT>(f, B, st);
    case 8: return bwd_p<8, XT>(f, B, st);
    case 16: return bwd_p<16, XT>(f, B, st);
    case 32: return bwd_p<32, XT>(f, B, st);
    default: return cudaErrorInvalidValue;
  }
}

int padded(int N) { return N <= 4 ? 4 : N <= 8 ? 8 : N <= 16 ? 16 : 32; }

}  // namespace

// Timesteps a saved state covers at state size N (the wrapper sizes `states` with it).
extern "C" int repro_mamba_scan_train_chunk(int N) { return chunk_of(padded(N)); }

// delta [B, S, Di] fp32, x [B, S, Di] (bf16 when x_bf16, else fp32), A [Di, N] fp32, Bm and C
// [B, S, N] fp32, y [B, S, Di] fp32, h_out [B, Di, N] or null, states [B, ceil(S / chunk), Di,
// N] fp32: contiguous.  1 <= N <= 32, B >= 1, Di >= 1, S >= 1.  Returns the cudaError_t of
// the launch.
extern "C" int repro_mamba_scan_train_fwd(const float* delta, const void* x, int x_bf16,
                                          const float* A, const float* Bm, const float* C,
                                          float* y, float* h_out, float* states, int B, int S,
                                          int Di, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Di < 1 || N < 1 || N > 32) return (int)cudaErrorInvalidValue;
  const int P = padded(N), ch = chunk_of(P);
  Fwd f{delta, x, A, Bm, C, y, h_out, states, S, Di, N, (S + ch - 1) / ch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? fwd<__nv_bfloat16>(f, B, P, st) : fwd<float>(f, B, P, st));
}

// The forward's inputs and `states`; dy [B, S, Di] fp32, dh [B, Di, N] fp32 or null.
// Writes ddelta [B, S, Di] fp32, dx [B, S, Di] in x's dtype, dA [Di, N], dB and dC [B, S, N]
// fp32, through the scratch dA_part [B, Di, N] and dB_part, dC_part [ceil(Di / 32), B, S, N]
// fp32.  Returns the cudaError_t of the first launch that failed, else of the last.
extern "C" int repro_mamba_scan_train_bwd(const float* delta, const void* x, int x_bf16,
                                          const float* A, const float* Bm, const float* C,
                                          const float* states, const float* dy,
                                          const float* dh, float* ddelta, void* dx,
                                          float* dA, float* dB, float* dC, float* dA_part,
                                          float* dB_part, float* dC_part, int B, int S, int Di,
                                          int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Di < 1 || N < 1 || N > 32) return (int)cudaErrorInvalidValue;
  const int P = padded(N), ch = chunk_of(P);
  Bwd f{delta, x, A, Bm, C, states, dy, dh, ddelta, dx, dA_part, dB_part, dC_part,
        S, Di, N, (S + ch - 1) / ch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_bf16 ? bwd<__nv_bfloat16>(f, B, P, st) : bwd<float>(f, B, P, st);
  if (err != cudaSuccess) return (int)err;
  const long long BSN = (long long)B * S * N, DN = (long long)Di * N;
  const long long n = BSN > DN ? BSN : DN;
  const int threads = 256;
  mamba_scan_train_sum_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
      dB_part, dC_part, dA_part, dB, dC, dA, BSN, DN, (Di + CPB - 1) / CPB, B);
  return (int)cudaGetLastError();
}
