// Backward of the mamba-1 selective scan's gated entry ("B6b") on Hopper
// (sm_90a). Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file
// (wrapper: repro_torch/kernels/mamba_scan.py, mamba_scan_gated_bwd_cuda).
//
// What it computes. The forward (B6's gated entry, mamba_scan.cu) is, per
// batch row, channel c and state n, from h = 0:
//   dt_t = softplus(dt_raw_t + dt_bias)  (F.softplus: x above 20 stays x)
//   a_t  = exp(dt_t * A),  h_t = a_t * h_{t-1} + dt_t * B_t * u_t
//   out_t = (sum_n h_t * C_t + D * u_t) * silu(z_t)
// The JAX reference has no Pallas backward for its scan: it differentiates
// the jnp chunked scan and the block's tail (src/repro/models/ssm.py:59-120)
// with jax.grad. This kernel is the port's gradient of that function. Given
// dout and dh_last (the gradient of h_last, or none), with dy = dout *
// silu(z) and the adjoint g_t = C_t * dy_t + a_{t+1} * g_{t+1} (g after the
// last step = dh_last):
//   du_t     = dt_t * sum_n g_t B_t + D * dy_t
//   ddt_t    = sum_n g_t A a_t h_{t-1} + u_t * sum_n g_t B_t
//   d dt_raw = ddt times softplus's derivative (1 above 20, else sigmoid)
//   dz_t     = dout_t * (y_t + D u_t) * silu'(z_t),  y_t = sum_n h_t C_t
//   dB_t[n]  = sum_c g_t dt_t u_t,   dC_t[n] = sum_c dy_t h_t
//   dA[c, n] = sum_{b,t} g_t dt_t a_t h_{t-1},  dD = sum dy u,
//   d dt_bias = sum d dt_raw.
// Its plain version is ref.mamba_scan_gated_bwd_torch.
//
// Design (a simple kernel; its time against its bound is in PERF.md):
// * Saved states. B6 writes the state entering each of its chunks of
//   kChunk = 128 steps (its kSegments * kSegLen) when asked; the backward
//   walks the chunks in reverse and recomputes h inside a chunk from that
//   state, so no (B, S, d, N) tensor is ever stored.
// * Tiles. A block owns kC channels (32, or 16 at N > 16) of one batch row;
//   a thread owns one (channel, state) pair, the NP states of a channel on
//   NP consecutive lanes (NP = the power of two >= N). Each chunk's u, dt,
//   dy, dout and z rows and its B and C rows are staged in shared memory.
// * Two passes per chunk. Pass 1 walks the chunk forward from its saved
//   state and keeps the state entering every sub-segment of kSub = 16 steps
//   (shared memory, one slot a thread). Pass 2 takes the sub-segments in
//   reverse: it recomputes their 16 states and decays into registers, then
//   carries g backwards over them.
// * Reductions. The sums over states (du, ddt, y) are 16 per sub-segment
//   and lane; a butterfly reduce-scatter over the channel's NP lanes leaves
//   each lane the full sums of 16 / NP steps (one at NP = 16), so one lane
//   finishes each (t, c). The sums over channels (dB, dC) go through the
//   warp's channel lanes by shuffles, then over the block's warps in shared
//   memory, into one partial per block and step; the sums over batch rows
//   and steps (dA, dD, d dt_bias) into one partial per batch row. The
//   wrapper adds the partials with torch.sum. No atomics: every sum runs
//   in a fixed order, so two calls give the same bits.
// * Arithmetic. The exponentials, the softplus and the SiLU are the
//   forward's short forms (mamba_scan.cu), so the recomputed states follow
//   the forward's; the sigmoids are 1 / (1 + ex2(-x log2 e)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // B6's chunk: its saved states are this apart
constexpr int kSub = 16;     // steps recomputed into registers at a time
constexpr int kSubs = kChunk / kSub;
constexpr int kMaxState = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <int NP>
struct Plan {
  static constexpr int kC = NP > 16 ? 16 : 32;  // channels a block
  static constexpr int kThreads = kC * NP;
  static constexpr int kWarps = kThreads / 32;
  // shared memory, in floats: six (t, c) rows of the chunk (u, dt_raw +
  // dt_bias, dt, dy, dout, z), B and C (t, n), the warps' dB and dC
  // partials of a sub-segment, and each thread's sub-segment states
  static constexpr int kRow = kChunk * kC;
  static constexpr int kBC = kChunk * NP;
  static constexpr int kPart = kWarps * kSub * 2 * NP;
  static constexpr int kCk = kSubs * kThreads;
  static constexpr int kSmemBytes = 4 * (6 * kRow + 2 * kBC + kPart + kCk);
};

struct Params {
  const float* u;
  const float* dt_raw;
  const float* dt_bias;
  const float* Bm;
  const float* Cm;
  const float* A;
  const float* D;
  const void* z;
  long long z_row;  // elements between consecutive (b, t) rows of z
  const void* dout;
  const float* states;   // (B, nchunks, d, N): the state entering each chunk
  const float* dh_last;  // (B, d, N) or null
  float* du;
  float* ddt;
  void* dz;
  float* dBp;  // (B, nblk, S, N) partials over each block's channels
  float* dCp;
  float* dAp;  // (B, d, N) partials over each batch row's steps
  float* dDp;  // (B, d)
  float* dbp;  // (B, d)
  int S, d, N, nchunks, nblk;
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the forward's softplus (mamba_scan.cu): x above 20 stays x, else
// max(x, 0) + log1p(exp(-|x|)) by the odd atanh series
__device__ __forceinline__ float softplus(float x) {
  if (x > 20.f) return x;
  const float e = ex2(-fabsf(x) * kLog2e);
  const float r = __fdividef(e, 2.f + e);
  const float r2 = r * r;
  float q = 1.f / 15.f;
  q = fmaf(q, r2, 1.f / 13.f);
  q = fmaf(q, r2, 1.f / 11.f);
  q = fmaf(q, r2, 1.f / 9.f);
  q = fmaf(q, r2, 1.f / 7.f);
  q = fmaf(q, r2, 1.f / 5.f);
  q = fmaf(q, r2, 1.f / 3.f);
  q = fmaf(q, r2, 1.f);
  return fmaxf(x, 0.f) + 2.f * r * q;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + ex2(-x * kLog2e));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Butterfly reduce-scatter of v[0 .. M) over the lanes that differ in the
// bits O, O/2, ..., 1 of n: at each bit a lane keeps one half of its live
// values, adds its partner's copy of that half, and hands over the other;
// with one value left, partners add theirs. Each sum is formed in one lane
// (or in both partners in the same order), so the bits are fixed.
template <int O, int M>
__device__ __forceinline__ void reduce_scatter(float (&v)[kSub], int n) {
  if constexpr (O >= 1) {
    if constexpr (M >= 2) {
      constexpr int H = M / 2;
      const bool hi = (n & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? v[i] : v[i + H];
        const float keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      reduce_scatter<O / 2, H>(v, n);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      reduce_scatter<O / 2, 1>(v, n);
    }
  }
}

template <int NP, typename Z>
__global__ void __launch_bounds__(Plan<NP>::kThreads, 1)
    scan_bwd(Params p) {
  using P = Plan<NP>;
  extern __shared__ __align__(16) float sm[];
  float* us = sm;
  float* xs = us + P::kRow;
  float* dts = xs + P::kRow;
  float* dys = dts + P::kRow;
  float* dos = dys + P::kRow;
  float* zs = dos + P::kRow;
  float* bs = zs + P::kRow;
  float* cs = bs + P::kBC;
  float* part = cs + P::kBC;  // [warp][step][dB, dC][state]
  float* ck = part + P::kPart;  // [sub-segment][thread]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / NP, n = tid % NP;
  const int c0 = blockIdx.x * P::kC, c = c0 + cl;
  const int b = blockIdx.y;
  const bool live_c = c < p.d;
  const bool live = live_c && n < p.N;
  const long sn = ((long)b * p.d + c) * p.N + n;  // this thread's (b, c, n)
  const float av = live ? p.A[(long)c * p.N + n] : 0.f;
  const float a2 = av * kLog2e;
  const float dskip = live_c ? p.D[c] : 0.f;
  const long row0 = (long)b * p.S;
  const Z* zg = static_cast<const Z*>(p.z);
  const Z* dog = static_cast<const Z*>(p.dout);
  Z* dzg = static_cast<Z*>(p.dz);

  // the steps of a sub-segment whose sums this lane finishes
  constexpr int kHeld = kSub / NP > 0 ? kSub / NP : 1;
  int base = 0;
  bool writer = live_c;
  {
    int m = kSub;
    for (int o = NP / 2; o >= 1; o >>= 1) {
      if (m >= 2) {
        m >>= 1;
        if (n & o) base += m;
      } else if (n & o) {
        writer = false;  // its partner holds the same sum
      }
    }
  }

  float gn = (live && p.dh_last) ? p.dh_last[sn] : 0.f;  // a_{t+1} g_{t+1}
  float dA = 0.f, dD = 0.f, dbias = 0.f;
  for (int k = p.nchunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int rows = min(kChunk, p.S - t0);
    __syncthreads();  // the previous chunk is done with shared memory
    for (int v = tid; v < P::kRow; v += P::kThreads) {
      const int t = v / P::kC, ch = c0 + v % P::kC;
      float uu = 0.f, x = 0.f, dtv = 0.f, dy = 0.f, dov = 0.f, zv = 0.f;
      if (t < rows && ch < p.d) {  // rows past S: identity steps
        const long g = (row0 + t0 + t) * p.d + ch;
        uu = p.u[g];
        x = p.dt_raw[g] + p.dt_bias[ch];
        dtv = softplus(x);
        dov = to_f(dog[g]);
        zv = to_f(zg[(row0 + t0 + t) * p.z_row + ch]);
        dy = dov * __fdividef(zv, 1.f + ex2(-zv * kLog2e));
      }
      us[v] = uu;
      xs[v] = x;
      dts[v] = dtv;
      dys[v] = dy;
      dos[v] = dov;
      zs[v] = zv;
    }
    for (int v = tid; v < P::kBC; v += P::kThreads) {
      const int t = v / NP, nn = v % NP;
      const bool ok = t < rows && nn < p.N;
      const long g = (row0 + t0 + t) * p.N + nn;
      bs[v] = ok ? p.Bm[g] : 0.f;
      cs[v] = ok ? p.Cm[g] : 0.f;
    }
    const float h0 =
        live ? p.states[(((long)b * p.nchunks + k) * p.d + c) * p.N + n] : 0.f;
    __syncthreads();
    const int subs = (rows + kSub - 1) / kSub;

    // pass 1: the state entering each sub-segment
    float h = h0;
    for (int j = 0; j < subs; ++j) {
      ck[j * P::kThreads + tid] = h;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = j * kSub + i;
        const float dtv = dts[t * P::kC + cl];
        h = fmaf(ex2(dtv * a2), h, dtv * us[t * P::kC + cl] * bs[t * NP + n]);
      }
    }

    // pass 2: the sub-segments in reverse
    for (int j = subs - 1; j >= 0; --j) {
      const float hin = ck[j * P::kThreads + tid];
      float hv[kSub], ev[kSub];
      h = hin;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = j * kSub + i;
        const float dtv = dts[t * P::kC + cl];
        ev[i] = ex2(dtv * a2);
        h = fmaf(ev[i], h, dtv * us[t * P::kC + cl] * bs[t * NP + n]);
        hv[i] = h;
      }
      float s1[kSub], s2[kSub], s3[kSub];  // sum_n g B, g A a h_{t-1}, h C
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        const int t = j * kSub + i;
        const int ti = t * P::kC + cl;
        const float dy = dys[ti], dtv = dts[ti];
        const float bn = bs[t * NP + n], cn = cs[t * NP + n];
        const float g = fmaf(cn, dy, gn);
        const float q = g * ev[i] * (i ? hv[i - 1] : hin);
        s1[i] = g * bn;
        s2[i] = q * av;
        s3[i] = hv[i] * cn;
        dA = fmaf(q, dtv, dA);
        float pb = g * (dtv * us[ti]), pc = dy * hv[i];
#pragma unroll
        for (int o = NP; o < 32; o <<= 1) {  // over the warp's channels
          pb += __shfl_xor_sync(kFull, pb, o);
          pc += __shfl_xor_sync(kFull, pc, o);
        }
        if (lane < NP) {
          part[((warp * kSub + i) * 2) * NP + n] = pb;
          part[((warp * kSub + i) * 2 + 1) * NP + n] = pc;
        }
        gn = ev[i] * g;
      }
      reduce_scatter<NP / 2, kSub>(s1, n);
      reduce_scatter<NP / 2, kSub>(s2, n);
      reduce_scatter<NP / 2, kSub>(s3, n);
#pragma unroll
      for (int m = 0; m < kHeld; ++m) {
        const int t = j * kSub + base + m;
        if (!writer || t >= rows) continue;
        const int ti = t * P::kC + cl;
        const float uu = us[ti], dtv = dts[ti], dy = dys[ti], zv = zs[ti];
        const float sg = sigmoid(zv);
        const float dz = dos[ti] * fmaf(dskip, uu, s3[m]) *
                         (sg * (1.f + zv * (1.f - sg)));
        const float ddt = fmaf(uu, s1[m], s2[m]);
        const float x = xs[ti];
        const float dx = x > 20.f ? ddt : ddt * sigmoid(x);
        const long g = (row0 + t0 + t) * p.d + c;
        p.du[g] = fmaf(dtv, s1[m], dskip * dy);
        p.ddt[g] = dx;
        dzg[g] = from_f<Z>(dz);
        dD = fmaf(dy, uu, dD);
        dbias += dx;
      }
      __syncthreads();  // every warp's dB and dC partials are in
      for (int v = tid; v < kSub * 2 * NP; v += P::kThreads) {
        const int i = v / (2 * NP), which = (v / NP) % 2, nn = v % NP;
        const int t = j * kSub + i;
        float sum = 0.f;
        for (int w = 0; w < P::kWarps; ++w) sum += part[w * kSub * 2 * NP + v];
        if (t < rows && nn < p.N)
          (which ? p.dCp : p.dBp)[(((long)b * p.nblk + blockIdx.x) * p.S +
                                   t0 + t) * p.N + nn] = sum;
      }
      __syncthreads();  // read before the next sub-segment writes them
    }
  }
  if (live) p.dAp[sn] = dA;
#pragma unroll
  for (int o = 1; o < NP; o <<= 1) {  // over the channel's lanes
    dD += __shfl_xor_sync(kFull, dD, o);
    dbias += __shfl_xor_sync(kFull, dbias, o);
  }
  if (n == 0 && live_c) {
    p.dDp[(long)b * p.d + c] = dD;
    p.dbp[(long)b * p.d + c] = dbias;
  }
}

template <int NP, typename Z>
int launch(const Params& p, int B, cudaStream_t stream) {
  using P = Plan<NP>;
  auto kern = scan_bwd<NP, Z>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.nblk, B);
  kern<<<grid, P::kThreads, P::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Z>
int launch_plan(const Params& p, int B, int log2_np, cudaStream_t st) {
  switch (log2_np) {
    case 0: return launch<1, Z>(p, B, st);
    case 1: return launch<2, Z>(p, B, st);
    case 2: return launch<4, Z>(p, B, st);
    case 3: return launch<8, Z>(p, B, st);
    case 4: return launch<16, Z>(p, B, st);
    case 5: return launch<32, Z>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

int log2_states(int N) {
  int k = 0;
  while ((1 << k) < N) ++k;
  return k;
}

}  // namespace

extern "C" {

// The forward's chunk the saved states must be taken at.
int corais_mamba_scan_bwd_chunk() { return kChunk; }

// Channels a block owns at state width N: the partials dBp and dCp have
// ceil(d / this) blocks.
int corais_mamba_scan_bwd_block_channels(int N) { return N > 16 ? 16 : 32; }

// B6b. u, dt_raw: (B, S, d) f32; dt_bias, D: (d,) f32; Bm, Cm: (B, S, N)
// f32; A: (d, N) f32; z: (B, S, d) bf16 (z_bf16 = 1) or f32, unit last
// stride, row (b, t) at z + (b * S + t) * z_row elements; dout: (B, S, d)
// in z's dtype, contiguous; states: (B, ceil(S / 128), d, N) f32, B6's
// saved chunk states; dh_last: (B, d, N) f32 or null. Writes du, ddt: (B,
// S, d) f32; dz: (B, S, d) in z's dtype; the partials dBp, dCp: (B, nblk,
// S, N), dAp: (B, d, N), dDp, dbp: (B, d), all f32. All contiguous, on one
// card. Returns the first CUDA error of the launch (0 when accepted).
int corais_mamba_scan_gated_bwd(
    const void* u, const void* dt_raw, const void* dt_bias, const void* Bm,
    const void* Cm, const void* A, const void* D, const void* z,
    long long z_row, int z_bf16, const void* dout, const void* states,
    const void* dh_last, void* du, void* ddt, void* dz, void* dBp, void* dCp,
    void* dAp, void* dDp, void* dbp, int B, int S, int d, int N, int nblk,
    void* stream) {
  if (B < 1 || B > 65535 || S < 1 || d < 1 || N < 1 || N > kMaxState ||
      z_row < d ||
      nblk != (d + corais_mamba_scan_bwd_block_channels(N) - 1) /
                  corais_mamba_scan_bwd_block_channels(N))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.u = static_cast<const float*>(u);
  p.dt_raw = static_cast<const float*>(dt_raw);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.A = static_cast<const float*>(A);
  p.D = static_cast<const float*>(D);
  p.z = z;
  p.z_row = z_row;
  p.dout = dout;
  p.states = static_cast<const float*>(states);
  p.dh_last = static_cast<const float*>(dh_last);
  p.du = static_cast<float*>(du);
  p.ddt = static_cast<float*>(ddt);
  p.dz = dz;
  p.dBp = static_cast<float*>(dBp);
  p.dCp = static_cast<float*>(dCp);
  p.dAp = static_cast<float*>(dAp);
  p.dDp = static_cast<float*>(dDp);
  p.dbp = static_cast<float*>(dbp);
  p.S = S;
  p.d = d;
  p.N = N;
  p.nchunks = (S + kChunk - 1) / kChunk;
  p.nblk = nblk;
  const int lg = log2_states(N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return z_bf16 ? launch_plan<__nv_bfloat16>(p, B, lg, st)
                : launch_plan<float>(p, B, lg, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
