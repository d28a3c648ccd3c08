// Mamba-1 selective scan ("B6") on Hopper (sm_90a). Built by
// repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file
// (wrapper: repro_torch/kernels/mamba_scan.py).
//
// What it replaces (JAX reference): the Pallas kernel `_kernel` of
// src/repro/kernels/mamba_scan.py:21 (entry mamba_scan_fwd, :50), which
// computes ref.mamba_scan_ref (src/repro/kernels/ref.py:46): from h = 0,
// for t = 0 .. S-1 and every channel c and state n,
//   h[c, n] = exp(dt[t, c] * A[c, n]) * h[c, n] + (dt[t, c] * B[t, n]) * u[t, c]
//   y[t, c] = sum_n h[c, n] * C[t, n]
// and returns y (B, S, d) and the last h (B, d, N), all f32 and contiguous
// (u, dt (B, S, d); B, C (B, S, N); A (d, N)). The Pallas grid (B, d/bd,
// S/chunk) carries a VMEM state over sequential chunks and needs
// S % chunk == 0 and d % bd == 0; this kernel takes any S >= 1, any d >= 1
// and 1 <= N <= 32 (the repo has N = 4 and 16).
//
// What bounds it. At falcon-mamba-7b's prefill (B=1, S=2048, d=8192, N=16)
// the kernel must read u and dt and write y, 3 * S * d * 4 B = 201 MB
// (B, C and A add 0.8 MB): 0.060 ms at 3.35 TB/s. It also evaluates
// S * d * N = 268 M exponentials, each one MUFU.EX2 on the special-function
// units (16 per SM and clock, about 0.07 ms on 132 SMs) plus a few FMAs of
// range reduction; the rest is about 7 f32 operations per (t, c, n), 1.9
// GFLOP, 0.028 ms at the 67 TFLOP/s f32 peak. So bytes and exponentials
// bound it at the same order, 0.06-0.07 ms.
//
// What the design does about it, for now: it is simple and right, and
// keeps the card busy. Each thread owns one (channel, state) pair: L lanes
// per channel (L the power of two >= N), 256 / L channels per 256-thread
// block, grid (ceil(d / (256 / L)), B). At falcon-mamba's prefill that is
// 512 blocks, 4,096 warps resident at once on 132 SMs, where a thread per
// channel would give 64 blocks of 128 threads, two warps per SM and no way
// to hide the latency of the time loop. The time loop runs inside the
// block over tiles of time steps: the tile's u and dt rows are staged in
// shared memory with loads coalesced along d, its B and C rows (contiguous)
// once per block, then each step is one exp and a few multiplies per
// thread, y summed over the channel's lanes with xor shuffles (every lane
// ends with the same bits), staged in shared memory and written once per
// (t, c) with coalesced stores; h_last is written once. u and dt are read
// from device memory once, y written once: the byte bound's traffic.
// h's update rounds every product and sum (no FMA contraction), as the
// plain version computes it; exp is expf, not __expf, and the build uses
// no --use_fast_math. The time loop is sequential and uses no atomics, so
// two calls give the same bits. The costs left: ~25 instructions per
// (t, c, n) where a thread owning several states would amortise the
// shared loads and shuffles, and a block that waits on its tile's loads
// (no double buffering). Fusing the softplus, the D skip and the SiLU gate,
// or a chunk-parallel scan, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxState = 32;

// Time steps per staged tile: 3 * tile * (256 / L) floats of u, dt and y
// stay within 24 KB of static shared memory.
template <int L>
constexpr int kTile = (8 * L < 64) ? 8 * L : 64;

template <int L>
__global__ void __launch_bounds__(kThreads)
    scan_fwd(const float* __restrict__ u, const float* __restrict__ dt,
             const float* __restrict__ Bm, const float* __restrict__ Cm,
             const float* __restrict__ A, float* __restrict__ y,
             float* __restrict__ h_last, int S, int d, int N) {
  constexpr int kCh = kThreads / L;  // channels per block
  constexpr int kT = kTile<L>;
  __shared__ float u_s[kT][kCh];
  __shared__ float dt_s[kT][kCh];
  __shared__ float y_s[kT][kCh];
  __shared__ float b_s[kT][L];
  __shared__ float c_s[kT][L];

  const int tid = threadIdx.x;
  const int n = tid % L;  // this thread's state
  const int c = tid / L;  // its channel within the block
  const int c0 = blockIdx.x * kCh;
  const int ch = c0 + c;
  const bool live = ch < d && n < N;
  const long row0 = (long)blockIdx.y * S;  // first (b, t) row of this batch
  // Dead lanes (n >= N or ch >= d) see A = B = C = u = dt = 0: their h
  // stays 0 and adds 0 to y.
  const float a = live ? A[(long)ch * N + n] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int T = min(kT, S - t0);
    for (int i = tid; i < kT * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      float uv = 0.f, dv = 0.f;
      if (tt < T && c0 + cc < d) {
        const long off = (row0 + t0 + tt) * d + c0 + cc;
        uv = u[off];
        dv = dt[off];
      }
      u_s[tt][cc] = uv;
      dt_s[tt][cc] = dv;
    }
    for (int i = tid; i < kT * L; i += kThreads) {
      const int tt = i / L, nn = i % L;
      float bv = 0.f, cv = 0.f;
      if (tt < T && nn < N) {
        const long off = (row0 + t0 + tt) * N + nn;
        bv = Bm[off];
        cv = Cm[off];
      }
      b_s[tt][nn] = bv;
      c_s[tt][nn] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < T; ++tt) {
      const float dv = dt_s[tt][c];
      const float da = expf(__fmul_rn(dv, a));
      const float dbu = __fmul_rn(__fmul_rn(dv, b_s[tt][n]), u_s[tt][c]);
      h = __fadd_rn(__fmul_rn(da, h), dbu);
      float p = __fmul_rn(h, c_s[tt][n]);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) y_s[tt][c] = p;
    }
    __syncthreads();
    // No barrier after the stores: the next tile's staging writes only
    // u_s, dt_s, b_s and c_s, which no thread reads past the barrier above,
    // and y_s is written again only after the next tile's first barrier.
    for (int i = tid; i < T * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (c0 + cc < d) y[(row0 + t0 + tt) * d + c0 + cc] = y_s[tt][cc];
    }
  }
  if (live) h_last[((long)blockIdx.y * d + ch) * N + n] = h;
}

template <int L>
int launch(const float* u, const float* dt, const float* Bm, const float* Cm,
           const float* A, float* y, float* h_last, int B, int S, int d,
           int N, cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  dim3 grid((d + kCh - 1) / kCh, B);
  scan_fwd<L><<<grid, kThreads, 0, stream>>>(u, dt, Bm, Cm, A, y, h_last, S,
                                             d, N);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*,
                         const float*, const float*, float*, float*, int, int,
                         int, int, cudaStream_t);

}  // namespace

extern "C" {

// u, dt, y: (B, S, d); Bm, Cm: (B, S, N); A: (d, N); h_last: (B, d, N);
// all f32, contiguous, on one card. B <= 65535, 1 <= N <= 32. Returns the
// first CUDA error of the launch (0 when it was accepted).
int corais_mamba_scan(const void* u, const void* dt, const void* Bm,
                      const void* Cm, const void* A, void* y, void* h_last,
                      int B, int S, int d, int N, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || d < 1 || N < 1 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  // one kernel per lane count L = the power of two >= N
  static const LaunchFn kLaunch[] = {launch<1>, launch<2>,  launch<4>,
                                     launch<8>, launch<16>, launch<32>};
  int log2_lanes = 0;
  while ((1 << log2_lanes) < N) ++log2_lanes;
  return kLaunch[log2_lanes](
      static_cast<const float*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<const float*>(A), static_cast<float*>(y),
      static_cast<float*>(h_last), B, S, d, N,
      static_cast<cudaStream_t>(stream));
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
