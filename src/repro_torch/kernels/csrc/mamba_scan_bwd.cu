// Backward of the mamba-1 selective scan's gated entry ("B6b") on Hopper
// (sm_90a), chunk-parallel over time on the forward's plan. Built by
// repro_torch/kernels/build.py with
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
// The bf16 state (the reference's ssm_scan_dtype="bfloat16", a flag of the
// entry, as of B6's): the states are recomputed with the forward's
// roundings (mamba_scan.cu's header note): a_t = exp(dt_t * A) and
// dt_t * u_t * B_t rounded to bf16 where they are formed, a segment's
// decay the product of its a_t, the state entering each segment and after
// each step of its walk rounded to bf16; a_t is that bf16 value wherever
// the formulas above read it. The gradient arithmetic stays f32. Its
// segments are 8 steps, B6's 16, so its recomputed states round at other
// points inside a chunk than B6's (each chunk starts from B6's state). The flag is a template parameter: the f32 kernels
// are compiled as before.
//
// What bounds it. At hymba-1.5b's training shape (B=8, S=1024, d=3200,
// N=16) it reads u, dt_raw (f32), z and dout (bf16) and writes du, d dt_raw
// (f32) and dz (bf16), 22 bytes per (t, c), beside B, C, the chunk states
// and the partials: 0.18 ms of device memory at 3.35 TB/s. It also
// evaluates 419 M exponentials (one MUFU.EX2 each, ~0.11 ms on 132 SMs)
// and ~16 other f32 operations per (t, c, n) that no design avoids. On
// the H100 the rate its warps dispatch instructions bounds it, not bytes
// or exponentials: the state loop runs ~375 instructions a state and warp
// (~24 f32 per (t, c, n), the rest the segment scans, the channel sums and
// addresses), 70 % of the time, and each chunk's loads, softplus,
// gradients and cluster fold the rest; with its device-memory traffic or
// its exponentials removed it is 12 % and 2 % faster
// (tools/b6b_ablation.py; PERF.md section 6).
//
// What the design does about it (B6's plan, mamba_scan.cu):
// * Saved states. B6 writes the state entering each of its chunks of
//   kChunk = 128 steps when asked; the backward walks the chunks in
//   reverse and recomputes h inside a chunk from that state, so no (B, S,
//   d, N) tensor is ever stored.
// * Tiles and ring. A block owns kChannels consecutive channels of one
//   batch row. Each chunk's u, dt_raw, z and dout rows (z and dout in their
//   stored dtype), its B and C (transposed to [segment][state][step] by
//   4-byte copies, so that a thread reads 4 steps of one state in one
//   16-byte load) and its chunk states go through a 2-stage cp.async ring:
//   the chunk before the current one in time loads while it computes.
// * Work per thread. Within a chunk a thread owns one channel and one
//   segment of kSegLen = 8 steps (a warp: 2 channels times the 16
//   segments). The softplus and the SiLU are computed once per (t, c) at
//   the chunk's start; dt, dt * u and dy stay in registers. The thread
//   walks the states kStates at a time, their walks interleaved (for the
//   latency of each chain); for each state it keeps its segment's
//   exp(dt * A) in registers, one exponential per (t, c, n), never two, and
//   the segment's recomputed h_t. The sums over states (du, ddt, y)
//   accumulate in the thread's registers, in state order, with no shuffle.
// * Both recurrences segment-parallel. Each segment composes its (decay,
//   value) pair for h forward and for the adjoint g backward, the decay as
//   one exponential exp(A * sum dt) shared by both; Hillis-Steele warp
//   scans over the channel's segments (shuffles over segments, not over
//   states) combine them, h from B6's saved state at the chunk's start, g
//   from the adjoint leaving the later chunk (or dh_last), carried in
//   shared memory. The segment then walks its steps forward once for h and
//   back once for g, forming q = g a h_{t-1} and every per-step term.
// * Sums over channels (dB, dC). The warp's two channel lanes trade one
//   value per step and state (one shuffle), then, after one barrier per
//   group of states, the block's warps are added in order, over that
//   state's B and C in shared memory, which no later state reads; this and
//   the sum of dA over the segments run while the next group composes its
//   pairs, so that their latency is not the barrier's. At the chunk's end
//   a thread block cluster of kCluster blocks on the same batch row adds
//   its blocks' sums through distributed shared memory in rank order, so
//   one partial covers kChannels * kCluster = 128 channels (4x fewer
//   partials than one per 32 channels); the wrapper's torch.sum of the
//   partials stays the last step. dA, dD and d dt_bias go out as one
//   partial per batch row. No atomics: every sum runs in a fixed order, so
//   two calls give the same bits.
// * Arithmetic. The exponentials (ex2.approx.ftz), the softplus and the
//   SiLU are the forward's short forms (mamba_scan.cu), so the recomputed
//   states follow the forward's; the sigmoids are 1 / (1 + ex2(-x log2 e)).
// * Plan. (kChannels, kSegLen, kCluster, kStates) = (32, 8, 4, 2): 512
//   threads of at most 128 registers and ~207 KB of shared memory at N = 16
//   with z in bf16, one block and 16 warps an SM. Two such blocks an SM do
//   not fit: they would have 64 registers a thread, and a block's stage ring
//   alone takes 135 KB (the warps' sums of two groups of states 64 KB more)
//   against the 113 KB each of two blocks may have. Where that shared memory
//   does not fit (N above 16, or z in f32), the Narrow plan: 16 channels a
//   block, 8 blocks a cluster, one state at a time (256 threads, two blocks
//   an SM at N = 16). 16-step segments (the forward's) would hold ~150
//   values a thread (dt, dt * u, dy, the three state sums, exp(dt * A) and
//   h) against the 128 registers of 16 warps an SM; tools/b6b_ablation.py
//   times the plans beside each other.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 128;  // B6's chunk: its saved states are this apart
// the plan: channels a block, steps a segment, blocks a cluster, states a
// thread walks at once
constexpr int kChannels = 32, kSegLen = 8, kCluster = 4, kStates = 2;
constexpr int kSegments = kChunk / kSegLen;
constexpr int kWarpChannels = 32 / kSegments;
// channel sums of a state a lane holds after its warp's exchange
constexpr int kHeld = 2 * kSegLen / kWarpChannels;
constexpr int kPartial = kChannels * kCluster;  // channels a partial covers
constexpr int kPad = 4;  // floats after each segment of a (t, c) tile
constexpr int kMaxState = 32;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kSegments == 16 && kHeld == 8,
              "a warp holds 2 channels of 16 segments");

template <int C, int K, int U>
struct Plan {
  static constexpr int kChannels = C, kCluster = K, kStates = U;
  static constexpr int kThreads = C * kSegments;
  static constexpr int kWarps = kThreads / 32;
  // 16 warps an SM: 128 registers a thread
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
  static constexpr int kSegUd = kSegLen * C + kPad;
  static constexpr int kUd = kSegments * kSegUd;
  static_assert(C % 4 == 0 && C % kWarpChannels == 0 && C * K == kPartial &&
                    K >= 1 && K <= 8 && (U == 1 || U == 2) &&
                    kThreads >= 32 * kHeld,
                "16-byte rows, whole warps, a portable cluster, a thread "
                "for each of a warp's channel sums");
};
using Wide = Plan<kChannels, kCluster, kStates>;
// where Wide's shared memory does not fit (N above 16, or z in f32): 16
// channels a block, one state at a time, the same channels a partial
using Narrow = Plan<16, kPartial / 16, 1>;

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
  float* dBp;  // (B, nblk, S, N) partials, one per cluster's channels
  float* dCp;
  float* dAp;  // (B, d, N) partials over each batch row's steps
  float* dDp;  // (B, d)
  float* dbp;  // (B, d)
  int S, d, N, nchunks, nblk;
  int vec_ud, vec_z, vec_do, vec_out;  // 16-byte paths allowed
};

// Shared memory, in floats. A stage: the u and dt_raw tiles
// [segment][step][channel] (+ kPad a segment), the z and dout tiles in z's
// dtype (+ 16 bytes a segment), B and C [segment][state][step] (+ 4 floats
// a segment), the chunk states [channel][state]. Then the fixed part:
// A * log2 e and A, the adjoint's carry, dA's sums, all [channel][state],
// and the warps' channel sums of two groups of states.
template <class P, typename Z>
struct Layout {
  static constexpr int kSegZ = kSegLen * P::kChannels + 16 / sizeof(Z);
  static constexpr int kZt = kSegments * kSegZ * sizeof(Z) / 4;
  static constexpr int kXs = 2 * P::kStates * P::kWarps * 32 * kHeld;
  int bc, stage, fixed;
  __host__ __device__ explicit Layout(int N)
      : bc(kSegments * (N * kSegLen + 4)),
        stage(2 * P::kUd + 2 * kZt + 2 * bc + P::kChannels * N),
        fixed(4 * P::kChannels * N + kXs) {}
  __host__ __device__ size_t bytes() const {
    return 4 * (size_t)(2 * stage + fixed);
  }
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Split barriers over the cluster's threads, so that a block works while
// the others arrive: with release and acquire, where each block's shared
// memory must be seen by the others; relaxed, where the reads it waits for
// have completed (their values were stored).
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the forward's softplus (mamba_scan.cu): x above 20 stays x, else
// max(x, 0) + log1p(exp(-|x|)) by the odd atanh series; and its
// derivative, sigmoid(x) (1 above 20), from the same exponential
__device__ __forceinline__ float softplus(float x, float& dsp) {
  const float e = ex2(-fabsf(x) * kLog2e);
  dsp = x > 20.f ? 1.f : __fdividef(x >= 0.f ? 1.f : e, 1.f + e);
  if (x > 20.f) return x;
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

// x, or (R) x rounded to the nearest bf16 value: the bf16 state
template <bool R>
__device__ __forceinline__ float rnd(float x) {
  return R ? __bfloat162float(__float2bfloat16_rn(x)) : x;
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

// a value of the segment off below / above in the channel's segment lanes
__device__ __forceinline__ float seg_up(float v, int off) {
  return __shfl_up_sync(kFull, v, off, kSegments);
}
__device__ __forceinline__ float seg_down(float v, int off) {
  return __shfl_down_sync(kFull, v, off, kSegments);
}

// Starts the copies of chunk k (rows t0 .. t0 + 127 of batch row b) into a
// stage: zeros for rows past S and channels past d (identity steps).
template <class P, typename Z>
__device__ void load_chunk(const Params& p, const Layout<P, Z>& L, float* st,
                           int b, int k, int c0, int tid) {
  constexpr int C = P::kChannels;
  float* us = st;
  float* xs = us + P::kUd;
  Z* zs = reinterpret_cast<Z*>(xs + P::kUd);
  Z* ds = reinterpret_cast<Z*>(xs + P::kUd + Layout<P, Z>::kZt);
  float* bt = xs + P::kUd + 2 * Layout<P, Z>::kZt;
  float* ct = bt + L.bc;
  float* h0 = ct + L.bc;
  const int t0 = k * kChunk;
  const int N = p.N;
  for (int v = tid; v < C * N; v += P::kThreads) {
    const int cc = v / N;
    if (c0 + cc < p.d)
      cp4(h0 + v, p.states + (((long)b * p.nchunks + k) * p.d + c0) * N + v);
    else
      h0[v] = 0.f;
  }
  const int rows = min(kChunk, p.S - t0);
  const long row0 = (long)b * p.S + t0;
  for (int v = tid; v < kChunk * (C / 4); v += P::kThreads) {
    const int t = v / (C / 4), c = (v % (C / 4)) * 4;
    const int si = (t / kSegLen) * P::kSegUd + (t % kSegLen) * C + c;
    const long g = (row0 + t) * p.d + c0 + c;
    if (t < rows && p.vec_ud && c0 + c + 4 <= p.d) {
      cp16(us + si, p.u + g);
      cp16(xs + si, p.dt_raw + g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = t < rows && c0 + c + j < p.d;
        us[si + j] = ok ? p.u[g + j] : 0.f;
        xs[si + j] = ok ? p.dt_raw[g + j] : 0.f;
      }
    }
  }
  constexpr int kZv = 16 / sizeof(Z);  // elements a 16-byte copy
  const Z* zg = static_cast<const Z*>(p.z);
  const Z* dg = static_cast<const Z*>(p.dout);
  for (int v = tid; v < kChunk * (C / kZv); v += P::kThreads) {
    const int t = v / (C / kZv), c = (v % (C / kZv)) * kZv;
    const int si =
        (t / kSegLen) * Layout<P, Z>::kSegZ + (t % kSegLen) * C + c;
    const long zi = (row0 + t) * p.z_row + c0 + c;
    const long di = (row0 + t) * p.d + c0 + c;
    const bool full = t < rows && c0 + c + kZv <= p.d;
    if (full && p.vec_z) {
      cp16(zs + si, zg + zi);
    } else {
      for (int j = 0; j < kZv; ++j)
        zs[si + j] = t < rows && c0 + c + j < p.d ? zg[zi + j] : from_f<Z>(0.f);
    }
    if (full && p.vec_do) {
      cp16(ds + si, dg + di);
    } else {
      for (int j = 0; j < kZv; ++j)
        ds[si + j] = t < rows && c0 + c + j < p.d ? dg[di + j] : from_f<Z>(0.f);
    }
  }
  // B and C, [segment][state][step]: one 4-byte copy a value, states
  // fastest so that each warp reads whole rows of device memory
  for (int v = tid; v < kChunk * N; v += P::kThreads) {
    const int t = v / N, n = v % N;
    const int si = (t / kSegLen) * (N * kSegLen + 4) + n * kSegLen + t % kSegLen;
    if (t < rows) {
      cp4(bt + si, p.Bm + (row0 + t) * N + n);
      cp4(ct + si, p.Cm + (row0 + t) * N + n);
    } else {
      bt[si] = 0.f;
      ct[si] = 0.f;
    }
  }
}

// Writes a chunk's du, d dt_raw (f32) and dz (z's dtype), staged over its
// u, dt_raw and z tiles, as rows of 4-channel vectors.
template <class P, typename Z>
__device__ void write_chunk(const Params& p, const float* st, int b, int t0,
                            int rows, int c0, int tid) {
  constexpr int C = P::kChannels;
  const float* dus = st;
  const float* dxs = dus + P::kUd;
  const Z* dzs = reinterpret_cast<const Z*>(dxs + P::kUd);
  Z* dzg = static_cast<Z*>(p.dz);
  const long row0 = (long)b * p.S + t0;
  for (int v = tid; v < kChunk * (C / 4); v += P::kThreads) {
    const int t = v / (C / 4), c = (v % (C / 4)) * 4;
    if (t >= rows || c0 + c >= p.d) continue;
    const int si = (t / kSegLen) * P::kSegUd + (t % kSegLen) * C + c;
    const int zi =
        (t / kSegLen) * Layout<P, Z>::kSegZ + (t % kSegLen) * C + c;
    const long g = (row0 + t) * p.d + c0 + c;
    if (p.vec_out && c0 + c + 4 <= p.d) {
      *reinterpret_cast<float4*>(p.du + g) =
          *reinterpret_cast<const float4*>(dus + si);
      *reinterpret_cast<float4*>(p.ddt + g) =
          *reinterpret_cast<const float4*>(dxs + si);
      if constexpr (sizeof(Z) == 2) {
        *reinterpret_cast<uint2*>(dzg + g) =
            *reinterpret_cast<const uint2*>(dzs + zi);
      } else {
        *reinterpret_cast<float4*>(dzg + g) =
            *reinterpret_cast<const float4*>(dzs + zi);
      }
    } else {
      for (int j = 0; j < 4 && c0 + c + j < p.d; ++j) {
        p.du[g + j] = dus[si + j];
        p.ddt[g + j] = dxs[si + j];
        dzg[g + j] = dzs[zi + j];
      }
    }
  }
}

template <class P, typename Z, bool R>
__global__ void __cluster_dims__(P::kCluster, 1, 1)
    __launch_bounds__(P::kThreads, P::kMinBlocks) scan_bwd(Params p) {
  constexpr int C = P::kChannels, W = P::kWarps, U = P::kStates;
  constexpr int kWarpVals = 32 * kHeld;  // a warp's channel sums of a state
  using Lay = Layout<P, Z>;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const Lay L(p.N);
  const int N = p.N;
  float* a2s = sm + 2 * L.stage;  // [channel][state]: A * log2(e)
  float* as = a2s + C * N;        // A
  float* gc = as + C * N;   // the adjoint entering from the later chunk
  float* dAs = gc + C * N;  // dA over the row's steps
  // [group & 1][state of the group][warp][step][lane]: the warps' channel
  // sums of a group of states
  float* xw = dAs + C * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = lane % kSegments, cw = lane / kSegments;
  const int cl = warp * kWarpChannels + cw;  // this thread's channel
  const int c0 = blockIdx.x * C, c = c0 + cl;
  const int b = blockIdx.y;
  const bool live_c = c < p.d;
  const float bias = live_c ? p.dt_bias[c] : 0.f;
  const float dskip = live_c ? p.D[c] : 0.f;
  for (int i = tid; i < C * N; i += P::kThreads) {
    const int cc = i / N;
    const bool ok = c0 + cc < p.d;
    const float av = ok ? p.A[(long)c0 * N + i] : 0.f;
    a2s[i] = av * kLog2e;
    as[i] = av;
    gc[i] = ok && p.dh_last ? p.dh_last[((long)b * p.d + c0) * N + i] : 0.f;
    dAs[i] = 0.f;
  }

  // the channel sum this thread adds over the warps: value j = step * 32
  // + lane of each warp's, of state sum_v of a group (the group's states
  // spread over the block's threads), and where the sum goes in that
  // state's B and C (which of the two, segment and step)
  const int segbc = N * kSegLen + 4;
  const int sum_j = tid % kWarpVals, sum_v = tid / kWarpVals;
  const int sum_m = (lane / kSegments) * kHeld + sum_j / 32;  // (which, step)
  const int sum_off = (lane % kSegments) * segbc + sum_m % kSegLen;

  float dD = 0.f, dbias = 0.f;
  load_chunk<P, Z>(p, L, sm, b, p.nchunks - 1, c0, tid);
  cp_commit();
  for (int it = 0; it < p.nchunks; ++it) {
    const int k = p.nchunks - 1 - it;
    const int t0 = k * kChunk;
    const int rows = min(kChunk, p.S - t0);
    float* st = sm + (it & 1) * L.stage;
    if (k > 0) {
      load_chunk<P, Z>(p, L, sm + ((it + 1) & 1) * L.stage, b, k - 1, c0, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float* us = st;
    float* xs = us + P::kUd;
    Z* zs = reinterpret_cast<Z*>(xs + P::kUd);
    const Z* ds = reinterpret_cast<const Z*>(xs + P::kUd + Lay::kZt);
    float* bt = xs + P::kUd + 2 * Lay::kZt;
    float* ct = bt + L.bc;
    const float* h0s = ct + L.bc;
    float* sum_dst = (sum_m >= kSegLen ? ct : bt) + sum_off;

    // dt, dt * u and dy of this thread's steps; softplus's derivative is
    // kept over dt_raw for the end of the chunk
    const int ui = s * P::kSegUd + cl;
    const int zi = s * Lay::kSegZ + cl;
    float dv[kSegLen], duv[kSegLen], dyv[kSegLen], sdv = 0.f;
#pragma unroll
    for (int i = 0; i < kSegLen; ++i) {
      const bool ok = live_c && s * kSegLen + i < rows;  // else identity
      const float uu = us[ui + i * C];
      const float x = xs[ui + i * C] + bias;
      const float zv = to_f(zs[zi + i * C]);
      const float dov = to_f(ds[zi + i * C]);
      float dsp;
      const float sp = softplus(x, dsp);
      dv[i] = ok ? sp : 0.f;
      xs[ui + i * C] = dsp;
      dyv[i] = ok ? dov * __fdividef(zv, 1.f + ex2(-zv * kLog2e)) : 0.f;
      duv[i] = dv[i] * uu;
      sdv += dv[i];
      dD = fmaf(dyv[i], uu, dD);
    }
    float s1[kSegLen], s2[kSegLen], s3[kSegLen];  // sum_n g B, q A, h C
#pragma unroll
    for (int i = 0; i < kSegLen; ++i) s1[i] = s2[i] = s3[i] = 0.f;

    // The states go in groups of U (one at the end if N is odd). A group's
    // channel sums and its dA are folded while the next group composes its
    // pairs (fold_prev), off the barrier's critical path.
    float dA_prev[U] = {};
    int prev_n0 = 0, prev_u = 0, grp = 0;
    auto fold_prev = [&]() {
#pragma unroll
      for (int v = 0; v < U; ++v) {
        const bool on = v < prev_u;
#pragma unroll
        for (int o = 1; o < kSegments; o <<= 1)  // over the channel's segments
          dA_prev[v] += __shfl_xor_sync(kFull, dA_prev[v], o);
        if (on && s == 0) dAs[cl * N + prev_n0 + v] += dA_prev[v];
      }
      // the sums over the block's warps, in order, over the states' B, C
      for (int v = sum_v; v < prev_u; v += P::kThreads / kWarpVals) {
        const float* xi =
            xw + (((grp + 1) & 1) * U + v) * W * kWarpVals + sum_j;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w)  // warps
          sum += xi[w * kWarpVals];
        sum_dst[(prev_n0 + v) * kSegLen] = sum;
      }
    };
    // the states n0 .. n0 + UG - 1, each as one thread walks it, the UG
    // walks interleaved
    auto group = [&](auto ug, int n0) {
      constexpr int UG = decltype(ug)::value;
      float a2[UG], av[UG], h0[UG], gin[UG], ac[UG];
      const float* bseg[UG];
      const float* cseg[UG];
#pragma unroll
      for (int v = 0; v < UG; ++v) {
        const int cn = cl * N + n0 + v;
        a2[v] = a2s[cn];
        av[v] = as[cn];
        h0[v] = h0s[cn];
        gin[v] = gc[cn];
        bseg[v] = bt + s * segbc + (n0 + v) * kSegLen;
        cseg[v] = ct + s * segbc + (n0 + v) * kSegLen;
        // the segment's decay, one exponential (or, R, the product of its
        // rounded decays, formed below)
        ac[v] = R ? 1.f : ex2(sdv * a2[v]);
      }
      // the segment's (decay, value) pairs: h forward from 0, the adjoint
      // backward from 0; exp(dt * A) once per (t, c, n)
      float ea[UG][kSegLen], hb[UG], gb[UG];
#pragma unroll
      for (int v = 0; v < UG; ++v) hb[v] = gb[v] = 0.f;
#pragma unroll
      for (int i = 0; i < kSegLen; i += 4) {
#pragma unroll
        for (int v = 0; v < UG; ++v) {
          const float4 bq = *reinterpret_cast<const float4*>(bseg[v] + i);
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ea[v][i + j] = rnd<R>(ex2(dv[i + j] * a2[v]));
            if (R) ac[v] *= ea[v][i + j];
            hb[v] = fmaf(ea[v][i + j], hb[v],
                         rnd<R>(duv[i + j] * bv[j]));
          }
        }
      }
#pragma unroll
      for (int i = kSegLen - 4; i >= 0; i -= 4) {
#pragma unroll
        for (int v = 0; v < UG; ++v) {
          const float4 cq = *reinterpret_cast<const float4*>(cseg[v] + i);
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int j = 3; j >= 0; --j)
            gb[v] = ea[v][i + j] * fmaf(cv[j], dyv[i + j], gb[v]);
        }
      }
      fold_prev();
      // inclusive scans over the channel's segments: h lowest first, the
      // adjoint highest first
      float ah[UG], ag[UG];
#pragma unroll
      for (int v = 0; v < UG; ++v) ah[v] = ag[v] = ac[v];
#pragma unroll
      for (int off = 1; off < kSegments; off <<= 1) {
#pragma unroll
        for (int v = 0; v < UG; ++v) {
          const float al = seg_up(ah[v], off), bl = seg_up(hb[v], off);
          const float ar = seg_down(ag[v], off), br = seg_down(gb[v], off);
          if (s >= off) {
            hb[v] = fmaf(ah[v], bl, hb[v]);
            ah[v] *= al;
          }
          if (s + off < kSegments) {
            gb[v] = fmaf(ag[v], br, gb[v]);
            ag[v] *= ar;
          }
        }
      }
      // the scans applied to the carries: h leaving each segment from the
      // chunk's saved state, the adjoint leaving it from the later chunk's;
      // a segment starts from its neighbour's
      float hin[UG], x[UG], gout[UG];
#pragma unroll
      for (int v = 0; v < UG; ++v) {
        const float hout = seg_up(rnd<R>(fmaf(ah[v], h0[v], hb[v])), 1);
        gout[v] = fmaf(ag[v], gin[v], gb[v]);
        const float gnext = seg_down(gout[v], 1);
        hin[v] = s == 0 ? h0[v] : hout;
        x[v] = s == kSegments - 1 ? gin[v] : gnext;
      }
      __syncwarp();  // every lane of the channel has read the carries
      if (s == 0) {
#pragma unroll
        for (int v = 0; v < UG; ++v) gc[cl * N + n0 + v] = gout[v];
      }
      // the segment walked forward for h ...
      float hv[UG][kSegLen];
#pragma unroll
      for (int v = 0; v < UG; ++v) {
        float h = hin[v];
#pragma unroll
        for (int i = 0; i < kSegLen; i += 4) {
          const float4 bq = *reinterpret_cast<const float4*>(bseg[v] + i);
          const float4 cq = *reinterpret_cast<const float4*>(cseg[v] + i);
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            h = rnd<R>(
                fmaf(ea[v][i + j], h, rnd<R>(duv[i + j] * bv[j])));
            hv[v][i + j] = h;
            s3[i + j] = fmaf(h, cv[j], s3[i + j]);
          }
        }
      }
      // ... and backward for g, with every per-step term; q = g a h_{t-1}
      // is the adjoint passed on times h_{t-1}. Each step's channel sums
      // go to the group's stage in shared memory.
      float* xo = xw + ((grp & 1) * U * W + warp) * kWarpVals + lane;
      float dA[UG];
#pragma unroll
      for (int v = 0; v < UG; ++v) dA[v] = 0.f;
#pragma unroll
      for (int i = kSegLen - 4; i >= 0; i -= 4) {
#pragma unroll
        for (int v = 0; v < UG; ++v) {
          const float4 bq = *reinterpret_cast<const float4*>(bseg[v] + i);
          const float4 cq = *reinterpret_cast<const float4*>(cseg[v] + i);
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            const int t = i + j;
            const float g = fmaf(cv[j], dyv[t], x[v]);
            x[v] = ea[v][t] * g;
            const float q = x[v] * (t ? hv[v][t - 1] : hin[v]);
            s1[t] = fmaf(g, bv[j], s1[t]);
            s2[t] = fmaf(q, av[v], s2[t]);
            dA[v] = fmaf(q, dv[t], dA[v]);
            float keep = g * duv[t];            // dB's term
            const float pc = dyv[t] * hv[v][t];  // dC's
            if (kWarpChannels > 1) {  // channel sum
              // the upper channel's lanes trade dB's terms for dC's
              const float send = cw ? keep : pc;
              keep = (cw ? pc : keep) + __shfl_xor_sync(kFull, send, 16);
            }
            xo[(v * W * kHeld + t) * 32] = keep;
          }
        }
      }
#pragma unroll
      for (int v = 0; v < UG; ++v) dA_prev[v] = dA[v];
      __syncthreads();  // the group's channel sums
      prev_n0 = n0;
      prev_u = UG;
      ++grp;
    };
    int n0 = 0;
    for (; n0 + U <= N; n0 += U) group(std::integral_constant<int, U>(), n0);
    if (n0 < N) group(std::integral_constant<int, 1>(), n0);
    fold_prev();
    cluster_arrive_release();  // this block's channel sums are in

    // du, d dt_raw and dz of this thread's steps, over u, dt_raw and z
#pragma unroll
    for (int i = 0; i < kSegLen; ++i) {
      const int ti = ui + i * C;
      const float uu = us[ti], sgx = xs[ti];
      const float zv = to_f(zs[zi + i * C]);
      const float dov = to_f(ds[zi + i * C]);
      const float sg = sigmoid(zv);
      const float dx = fmaf(uu, s1[i], s2[i]) * sgx;
      us[ti] = fmaf(dv[i], s1[i], dskip * dyv[i]);
      xs[ti] = dx;
      zs[zi + i * C] = from_f<Z>(dov * fmaf(dskip, uu, s3[i]) *
                                 (sg * (1.f + zv * (1.f - sg))));
      if (live_c && s * kSegLen + i < rows) dbias += dx;
    }
    __syncthreads();  // the block's gradients are staged
    write_chunk<P, Z>(p, st, b, t0, rows, c0, tid);
    cluster_wait_acquire();  // every block's channel sums are in
    // the cluster's sums over its blocks, in rank order, one slice a block:
    // 4 steps of one state a thread, one 16-byte load from each block
    const int per = 2 * (kChunk / 4) * N / P::kCluster;
    const int rank = (int)cluster.block_rank();
    const long part =
        ((long)b * p.nblk + blockIdx.x / P::kCluster) * p.S + t0;
    for (int e = rank * per + tid; e < (rank + 1) * per; e += P::kThreads) {
      const int which = e / ((kChunk / 4) * N), n = e % N;
      const int t = ((e / N) % (kChunk / 4)) * 4;
      if (t >= rows) continue;
      const float* src = (which ? ct : bt) + (t / kSegLen) * segbc +
                         n * kSegLen + t % kSegLen;
      float4 vals[P::kCluster];
#pragma unroll
      for (int r = 0; r < P::kCluster; ++r)
        vals[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(src, r));
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < P::kCluster; ++r) {  // ranks
        sum.x += vals[r].x;
        sum.y += vals[r].y;
        sum.z += vals[r].z;
        sum.w += vals[r].w;
      }
      float* dst = (which ? p.dCp : p.dBp) + (part + t) * N + n;
      const float o[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t + j < rows) dst[j * N] = o[j];
    }
    cluster_arrive_relaxed();  // this block's reads of the sums are done
    cluster_wait();  // every block's are: the stage can be refilled
  }
  for (int i = tid; i < C * N; i += P::kThreads)
    if (c0 + i / N < p.d) p.dAp[((long)b * p.d + c0) * N + i] = dAs[i];
#pragma unroll
  for (int o = 1; o < kSegments; o <<= 1) {  // over the channel's segments
    dD += __shfl_xor_sync(kFull, dD, o);
    dbias += __shfl_xor_sync(kFull, dbias, o);
  }
  if (s == 0 && live_c) {
    p.dDp[(long)b * p.d + c] = dD;
    p.dbp[(long)b * p.d + c] = dbias;
  }
}

template <class P, typename Z, bool R>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = Layout<P, Z>(p.N).bytes();
  auto kern = scan_bwd<P, Z, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.nblk * P::kCluster, B);
  kern<<<grid, P::kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Wide where its shared memory fits, else Narrow
template <typename Z, bool R>
int launch_states(const Params& p, int B, cudaStream_t stream) {
  if (Layout<Wide, Z>(p.N).bytes() <= kMaxSmem)
    return launch<Wide, Z, R>(p, B, stream);
  if (Layout<Narrow, Z>(p.N).bytes() <= kMaxSmem)
    return launch<Narrow, Z, R>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

// the f32 state, or (bf16_state) the bf16 one
template <typename Z>
int launch_plan(const Params& p, int B, int bf16_state, cudaStream_t stream) {
  return bf16_state ? launch_states<Z, true>(p, B, stream)
                    : launch_states<Z, false>(p, B, stream);
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// The forward's chunk the saved states must be taken at.
int corais_mamba_scan_bwd_chunk() { return kChunk; }

// Channels one partial of dB and dC covers (a cluster's): dBp and dCp have
// ceil(d / this) of them, at every N.
int corais_mamba_scan_bwd_block_channels() {
  return kPartial;
}

// B6b. u, dt_raw: (B, S, d) f32; dt_bias, D: (d,) f32; Bm, Cm: (B, S, N)
// f32; A: (d, N) f32; z: (B, S, d) bf16 (z_bf16 = 1) or f32, unit last
// stride, row (b, t) at z + (b * S + t) * z_row elements; dout: (B, S, d)
// in z's dtype, contiguous; states: (B, ceil(S / 128), d, N) f32, B6's
// saved chunk states; dh_last: (B, d, N) f32 or null. Writes du, ddt: (B,
// S, d) f32; dz: (B, S, d) in z's dtype; the partials dBp, dCp: (B, nblk,
// S, N), dAp: (B, d, N), dDp, dbp: (B, d), all f32. All contiguous, on one
// card. bf16_state = 1 recomputes the forward's bf16 states (the file's
// header note). Returns the first CUDA error of the launch (0 when
// accepted).
int corais_mamba_scan_gated_bwd(
    const void* u, const void* dt_raw, const void* dt_bias, const void* Bm,
    const void* Cm, const void* A, const void* D, const void* z,
    long long z_row, int z_bf16, const void* dout, const void* states,
    const void* dh_last, void* du, void* ddt, void* dz, void* dBp, void* dCp,
    void* dAp, void* dDp, void* dbp, int B, int S, int d, int N, int nblk,
    int bf16_state, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || d < 1 || N < 1 || N > kMaxState ||
      z_row < d || nblk != (d + kPartial - 1) / kPartial)
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
  const int esize = z_bf16 ? 2 : 4;
  p.vec_ud = aligned(u, 16) && aligned(dt_raw, 16) && d % 4 == 0;
  p.vec_z = aligned(z, 16) && (z_row * esize) % 16 == 0;
  p.vec_do = aligned(dout, 16) && (d * esize) % 16 == 0;
  p.vec_out = aligned(du, 16) && aligned(ddt, 16) && aligned(dz, 4 * esize) &&
              d % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return z_bf16 ? launch_plan<__nv_bfloat16>(p, B, bf16_state, st)
                : launch_plan<float>(p, B, bf16_state, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
