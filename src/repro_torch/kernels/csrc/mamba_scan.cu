// Mamba-1 selective scan ("B6") on Hopper (sm_90a), chunk-parallel over
// time, with an optional fused prologue (dt's softplus) and epilogue (the D
// skip and the SiLU gate). Built by repro_torch/kernels/build.py with
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
// and returns y (B, S, d) and the last h (B, d, N), all f32 (u, dt (B, S,
// d); B, C (B, S, N); A (d, N)). That is `corais_mamba_scan`. The gated
// entry `corais_mamba_scan_gated` computes the SSM block's tail around it
// (src/repro/models/ssm.py:114-120): dt = softplus(dt_raw + dt_bias) with
// F.softplus's rule (x above 20 stays x), the scan, then
// out = (y + D * u) * silu(z), stored once in z's dtype (bf16 or f32); z is
// read through an explicit row stride (the strided half of in_proj's
// output, never copied). Any S >= 1, any d >= 1, 1 <= N <= 32, B <= 65535.
// For training the gated entry also writes, when given a buffer, the state
// entering each chunk of the walk below, from which its backward
// (mamba_scan_bwd.cu, "B6b") recomputes the states of a chunk.
//
// What bounds it. At falcon-mamba-7b's prefill (B=1, S=2048, d=8192, N=16)
// the bare scan reads u and dt and writes y, 12 B per (t, c): 201 MB, 0.060
// ms at 3.35 TB/s. The gated entry reads u and dt_raw in f32 and z in bf16
// and writes the output in bf16, 12 B per (t, c) too. Both also evaluate
// S * d * N = 268 M exponentials, one MUFU.EX2 each (16 per SM and clock:
// ~0.07 ms on 132 SMs), beside ~6 other f32 instructions per (t, c, n)
// and the segment combine. On the H100 the kernel is bound by issue and
// latency, not by bytes: with its device-memory traffic removed it still
// takes 0.13 ms, with its arithmetic removed 0.08 ms (tools/b6_ablation.py;
// PERF.md section 6).
//
// What the design does about it:
// * Tiles. A block owns kTC = 32 consecutive channels (one 128-byte row of
//   f32 per time step) of one batch row and walks S in chunks of P * SEG
//   steps. Each chunk's u and dt rows and its B and C rows go through a
//   2-stage cp.async ring in shared memory (16-byte copies, coalesced):
//   chunk k+1 loads while chunk k computes. B and C are then transposed in
//   shared memory to [segment][state][step] over the dt tile, whose values
//   are in registers by then (a region of their own at N > 16), so that a
//   thread reads 4 steps of one state in one 16-byte load. Grid
//   (ceil(d / 32), B); P warps a block; two blocks an SM at this plan.
// * Work per thread. Within a chunk a thread owns one channel and one
//   segment of SEG consecutive steps; a warp holds 32 / P channels times P
//   segments. It loops over the states (unrolled U at a time), keeping for
//   each its segment's exp(dt*A) and dt*u*B in registers: one exponential
//   per (t, c, n), never two. The segment's decay is one more exponential,
//   exp(A * sum dt).
// * Combine and carry. The P segments of a channel combine by a
//   Hillis-Steele warp scan (shuffles over segments, log2 P steps, not over
//   states); the exclusive prefix applied to the state carried in from the
//   previous chunk gives each segment its starting state; the segment is
//   walked again from registers, y_t summed over the states in registers
//   (no shuffle for y) and staged in shared memory over the u tile it
//   replaces, then written once with coalesced row stores. The last
//   segment's state is the next chunk's carry (shared memory); h_last is
//   written once at the end.
// * Fixed order. No atomics; the segment combine and the sum over states
//   run in a fixed order, so two calls give the same bits.
// * Exponential. exp(dt * A) is ex2.approx.ftz(dt * (A * log2 e)): a
//   relative error of about 2^-22 from ex2.approx plus the rounding of
//   A * log2 e and of the product, a few f32 ulp of each decay, far inside
//   the 5e-4 bar; values below 2^-126 flush to 0. The softplus and the
//   SiLU are short forms within 2e-6 relative (see softplus()), where
//   PyTorch's log1pf(expf(x)) and IEEE divide would cost ~60 instructions
//   per (t, c), a third of the scan's.
// * Rounding. The order of the products and sums differs from the plain
//   version's sequential loop (segment products, the combine, FMAs), so the
//   bits differ; the bars (5e-4 against the plain version) do not move.
// * z. The gated epilogue reads z from device memory in the write-out's
//   rows: a shared-memory tile of it would take the shared memory of the
//   second block on an SM.
// * Plan. (P, SEG, U) = (kSegments, kSegLen, kUnroll) = (8, 16, 4), the
//   fastest of a sweep on the card (tools/b6_ablation.py compiles copies
//   of this file at other plans; PERF.md section 6).
//
// The bf16 state (the reference's ssm_scan_dtype="bfloat16",
// src/repro/models/ssm.py:74-87, a flag of every entry): exp(dt * A) and
// dt * u * B are rounded to bf16 where they are formed (ea, eb), the state
// entering each segment (the cross-segment composition applied to the
// carry) and the state after every step of a segment's walk are rounded to
// bf16 (__float2bfloat16_rn), so the carry between chunks, the chunk
// states and h_last hold bf16 values in their f32 layout; y is summed in
// f32 from those states. A segment's decay is the product of its rounded
// exp(dt * A), as the reference multiplies its bf16 decays (where dt * A
// is near 0 they round to 1: no decay), not exp(A * sum dt). The
// segments' (decay, value) pairs and their scan stay f32: the reference's
// tree-ordered bf16 scan rounds at other points anyway, and no twin
// matches it bit for bit. A state rounded once per step of a sequential
// walk would drift by several % from these (bf16 drops the small values
// added to a large state); the walk restarts from the composition every
// segment. The plain version (ref.mamba_scan_torch's bf16_state) rounds at
// these points, at this plan. The flag is a template parameter: the f32
// kernels are compiled as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTC = 32;        // channels per block
constexpr int kMaxState = 32;
constexpr int kPad = 8;        // floats after each segment's rows, u/dt tile
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// the plan: segments per chunk P (a divisor of 32), steps per segment SEG
// (a multiple of 4), states unrolled U
constexpr int kSegments = 8, kSegLen = 16, kUnroll = 4;

enum { kBare = 0, kGatedF32 = 1, kGatedBF16 = 2 };

template <int EPI>
struct Out {
  using T = float;
};
template <>
struct Out<kGatedBF16> {
  using T = __nv_bfloat16;
};

struct Params {
  const float* u;
  const float* dt;  // dt (bare) or dt_raw (gated)
  const float* dt_bias;
  const float* Bm;
  const float* Cm;
  const float* A;
  const float* D;
  const void* z;
  long long z_row;  // elements between consecutive (b, t) rows of z
  void* y;
  float* h_last;
  float* states;  // (B, nchunks, d, N): the state entering each chunk, or null
  int S, d, N;
  int vec_ud, vec_bc, vec_z, vec_y;  // 16-byte paths allowed
};

template <int P, int SEG, int U, int NP, int EPI>
struct Layout {
  static constexpr int kThreads = kTC * P;
  static constexpr int kChunk = P * SEG;
  // B or C of one segment: [state][step], 4 floats of padding so that the
  // P segments of a warp read distinct 16-byte bank groups
  static constexpr int kSegBc = NP * SEG + 4;
  static constexpr int kBc = P * kSegBc;
  // B or C as staged from device memory, [step][state]: rows padded to an
  // odd number of 16-byte groups (NP >= 4), read as 16 bytes a step
  static constexpr int kNPR = NP < 4 ? NP : ((NP / 4) % 2 ? NP : NP + 4);
  static constexpr int kRaw = kChunk * kNPR;
  static constexpr int kSegUd = SEG * kTC + kPad;
  static constexpr int kUd = P * kSegUd;
  using Z = typename Out<EPI>::T;
  static constexpr int kStageBytes = 4 * (2 * kUd + 2 * kRaw);
  // B and C transposed go over the dt tile once its values are in
  // registers, where they fit (N <= 16), else to a region of their own
  static constexpr bool kBcInDt = 2 * kBc <= kUd;
  // A * log2(e) and the carried state (and B and C transposed)
  static constexpr int kFixedBytes = 4 * (2 * kTC * NP + (kBcInDt ? 0 : 2 * kBc));
  static constexpr int kSmemBytes = kFixedBytes + 2 * kStageBytes;
  // at least 16 warps an SM: 128 registers a thread (64 at 1024 threads)
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
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

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// F.softplus (beta 1, threshold 20): x above 20 stays x; else
// log1p(exp(x)) = max(x, 0) + log1p(e) with e = exp(-|x|) in (0, 1], and
// log1p(e) = 2 atanh(r), r = e / (2 + e) in (0, 1/3], summed as the odd
// series 2 r (1 + r^2/3 + ... + r^14/15) (the next term is below 2e-9 of
// the sum): within 2e-6 relative of softplus over [-30, 20] (CPU check of
// the same arithmetic), where log1pf(expf(x)) costs ~50 instructions.
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

// silu(z) = z / (1 + exp(-z)), exp and the divide approximate (2 ulp each)
__device__ __forceinline__ float silu(float z) {
  return __fdividef(z, 1.f + ex2(-z * kLog2e));
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

// Loads one chunk (rows t0 .. t0 + P*SEG - 1 of batch row row0 / S) into a
// stage: u and dt as [segment][step][channel] (+ kPad per segment), B and C
// as [step][state] (+ padding). Rows past S, channels past d and states
// past N are zeros.
template <int P, int SEG, int U, int NP, int EPI>
__device__ void stage(const Params& p, char* st, long row0, int t0, int c0,
                      int tid) {
  using L = Layout<P, SEG, U, NP, EPI>;
  float* us = reinterpret_cast<float*>(st);
  float* ds = us + L::kUd;
  float* br = ds + L::kUd;
  float* cr = br + L::kRaw;
  const int rows = min(L::kChunk, p.S - t0);
  for (int v = tid; v < L::kChunk * (kTC / 4); v += L::kThreads) {
    const int t = v / (kTC / 4), c = (v % (kTC / 4)) * 4;
    const int si = (t / SEG) * L::kSegUd + (t % SEG) * kTC + c;
    const long g = (row0 + t0 + t) * p.d + c0 + c;
    if (t < rows && p.vec_ud && c0 + c + 4 <= p.d) {
      cp16(us + si, p.u + g);
      cp16(ds + si, p.dt + g);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = t < rows && c0 + c + j < p.d;
        us[si + j] = ok ? p.u[g + j] : 0.f;
        ds[si + j] = ok ? p.dt[g + j] : 0.f;
      }
    }
  }
  const long brow = (row0 + t0) * p.N;
  bool vec = false;
  if constexpr (NP >= 4) vec = p.vec_bc;
  if (vec) {
    constexpr int kV = NP >= 4 ? NP / 4 : 1;  // 16-byte groups a row
    for (int v = tid; v < L::kChunk * kV; v += L::kThreads) {
      const int t = v / kV, n = (v % kV) * 4;
      const int si = t * L::kNPR + n;
      if (t < rows && n < p.N) {
        cp16(br + si, p.Bm + brow + (long)t * p.N + n);
        cp16(cr + si, p.Cm + brow + (long)t * p.N + n);
      } else {
        *reinterpret_cast<float4*>(br + si) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(cr + si) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int v = tid; v < L::kChunk * NP; v += L::kThreads) {
      const int t = v / NP, n = v % NP;
      const int si = t * L::kNPR + n;
      if (t < rows && n < p.N) {
        cp4(br + si, p.Bm + brow + (long)t * p.N + n);
        cp4(cr + si, p.Cm + brow + (long)t * p.N + n);
      } else {
        br[si] = 0.f;
        cr[si] = 0.f;
      }
    }
  }
}

// B and C of a stage, [step][state], to [segment][state][step] (bt, ct):
// threads take consecutive steps, so that reads (16 bytes, odd row stride
// in 16-byte groups) and writes fall in distinct banks.
template <int P, int SEG, int U, int NP, int EPI>
__device__ void transpose_bc(const char* st, float* bt, float* ct, int tid) {
  using L = Layout<P, SEG, U, NP, EPI>;
  const float* br = reinterpret_cast<const float*>(st) + 2 * L::kUd;
  const float* cr = br + L::kRaw;
  if constexpr (NP >= 4) {
    for (int v = tid; v < L::kChunk * (NP / 4); v += L::kThreads) {
      const int t = v % L::kChunk, n = (v / L::kChunk) * 4;
      const float4 b = *reinterpret_cast<const float4*>(br + t * L::kNPR + n);
      const float4 c = *reinterpret_cast<const float4*>(cr + t * L::kNPR + n);
      const int di = (t / SEG) * L::kSegBc + n * SEG + t % SEG;
      bt[di] = b.x;
      bt[di + SEG] = b.y;
      bt[di + 2 * SEG] = b.z;
      bt[di + 3 * SEG] = b.w;
      ct[di] = c.x;
      ct[di + SEG] = c.y;
      ct[di + 2 * SEG] = c.z;
      ct[di + 3 * SEG] = c.w;
    }
  } else {
    for (int v = tid; v < L::kChunk * NP; v += L::kThreads) {
      const int t = v % L::kChunk, n = v / L::kChunk;
      const int di = (t / SEG) * L::kSegBc + n * SEG + t % SEG;
      bt[di] = br[t * L::kNPR + n];
      ct[di] = cr[t * L::kNPR + n];
    }
  }
}

// Writes a chunk's y (staged over its u tile) as rows of 4-channel
// vectors; the gated epilogue multiplies by silu(z), z read here from
// device memory in the same rows (no shared-memory tile: it would cost a
// block per SM), and stores z's dtype.
template <int P, int SEG, int U, int NP, int EPI>
__device__ void write_out(const Params& p, const char* st, long row, int rows,
                          int c0, int tid) {
  using L = Layout<P, SEG, U, NP, EPI>;
  using Z = typename L::Z;
  const float* ys = reinterpret_cast<const float*>(st);
  const Z* zg = static_cast<const Z*>(p.z);
  Z* yg = static_cast<Z*>(p.y);
  for (int v = tid; v < L::kChunk * (kTC / 4); v += L::kThreads) {
    const int t = v / (kTC / 4), c = (v % (kTC / 4)) * 4;
    if (t >= rows) continue;
    const int si = (t / SEG) * L::kSegUd + (t % SEG) * kTC + c;
    const float4 q = *reinterpret_cast<const float4*>(ys + si);
    float o[4] = {q.x, q.y, q.z, q.w};
    if constexpr (EPI != kBare) {
      const long zi = (row + t) * p.z_row + c0 + c;
      alignas(16) Z zv[4];
      if (p.vec_z && c0 + c + 4 <= p.d) {
        using V = typename std::conditional<sizeof(Z) == 2, uint2, float4>::type;
        *reinterpret_cast<V*>(zv) = __ldg(reinterpret_cast<const V*>(zg + zi));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          zv[j] = c0 + c + j < p.d ? zg[zi + j] : from_f<Z>(0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] *= silu(to_f(zv[j]));
    }
    const long g = (row + t) * p.d + c0 + c;
    if (p.vec_y && c0 + c + 4 <= p.d) {
      if constexpr (EPI == kGatedBF16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
        uint2 w;
        w.x = *reinterpret_cast<const unsigned*>(&lo);
        w.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(yg + g) = w;
      } else {
        *reinterpret_cast<float4*>(yg + g) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + c + j < p.d) yg[g + j] = from_f<Z>(o[j]);
    }
  }
}

template <int P, int SEG, int U, int NP, int EPI, bool R>
__global__ void __launch_bounds__(kTC * P,
                                  (Layout<P, SEG, U, NP, EPI>::kMinBlocks))
    scan_chunked(Params p) {
  using L = Layout<P, SEG, U, NP, EPI>;
  extern __shared__ __align__(16) char smem[];
  float* a2s = reinterpret_cast<float*>(smem);  // [kTC][NP]: A * log2(e)
  float* hs = a2s + kTC * NP;  // [kTC][NP]: the state carried between chunks
  char* stages = smem + L::kFixedBytes;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTC;
  const long row0 = (long)blockIdx.y * p.S;
  for (int i = tid; i < kTC * NP; i += L::kThreads) {
    const int c = i / NP, n = i % NP;
    a2s[i] = (c0 + c < p.d && n < p.N) ? p.A[(long)(c0 + c) * p.N + n] * kLog2e
                                       : 0.f;
    hs[i] = 0.f;
  }
  // this thread: segment s of channel c (a warp: 32 / P channels x P)
  const int lane = tid & 31, s = lane % P;
  const int c = (tid >> 5) * (32 / P) + lane / P;
  const bool live_c = c0 + c < p.d;
  const float bias = (EPI != kBare && live_c) ? p.dt_bias[c0 + c] : 0.f;
  const float dskip = (EPI != kBare && live_c) ? p.D[c0 + c] : 0.f;
  const int nchunks = (p.S + L::kChunk - 1) / L::kChunk;

  stage<P, SEG, U, NP, EPI>(p, stages, row0, 0, c0, tid);
  cp_commit();
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * L::kChunk;
    if (k + 1 < nchunks) {
      stage<P, SEG, U, NP, EPI>(p, stages + ((k + 1) & 1) * L::kStageBytes, row0,
                             t0 + L::kChunk, c0, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (p.states != nullptr) {  // read before the state loop below writes hs
      for (int i = tid; i < kTC * p.N; i += L::kThreads) {
        const int cc = i / p.N, n = i % p.N;
        if (c0 + cc < p.d)
          p.states[(((long)blockIdx.y * nchunks + k) * p.d + c0 + cc) * p.N +
                   n] = hs[cc * NP + n];
      }
    }
    char* st = stages + (k & 1) * L::kStageBytes;
    float* us = reinterpret_cast<float*>(st);
    float* ds = us + L::kUd;

    float dv[SEG], duv[SEG], yv[SEG], sdv = 0.f;
    const int ui = s * L::kSegUd + c;
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      const float uu = us[ui + i * kTC];
      float x = ds[ui + i * kTC];
      if constexpr (EPI != kBare) {
        x = softplus(x + bias);
      }
      dv[i] = t0 + s * SEG + i < p.S ? x : 0.f;  // rows past S: identity
      duv[i] = dv[i] * uu;
      yv[i] = EPI != kBare ? dskip * uu : 0.f;
      sdv += dv[i];
    }
    // B and C of the chunk, [segment][state][step]
    float* bt = L::kBcInDt ? ds : hs + kTC * NP;
    float* ct = bt + L::kBc;
    if constexpr (L::kBcInDt) __syncthreads();  // every dt value is read
    transpose_bc<P, SEG, U, NP, EPI>(st, bt, ct, tid);
    __syncthreads();
    const float* bseg = bt + s * L::kSegBc;
    const float* cseg = ct + s * L::kSegBc;
#pragma unroll U
    for (int n = 0; n < NP; ++n) {
      const float a2 = a2s[c * NP + n];
      const float hc = hs[c * NP + n];
      float ea[SEG], eb[SEG];
      // the segment's decay, one exponential (or, R, the product of its
      // rounded decays)
      float ac = R ? 1.f : ex2(sdv * a2);
      float bc = 0.f;
      // this segment's (decay, value) pair
#pragma unroll
      for (int i = 0; i < SEG; i += 4) {
        const float4 bq = *reinterpret_cast<const float4*>(bseg + n * SEG + i);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ea[i + j] = rnd<R>(ex2(dv[i + j] * a2));
          eb[i + j] = rnd<R>(duv[i + j] * bv[j]);
          if (R) ac *= ea[i + j];
          bc = fmaf(ea[i + j], bc, eb[i + j]);
        }
      }
      // inclusive scan over the channel's P segments, lowest first
#pragma unroll
      for (int off = 1; off < P; off <<= 1) {
        const float al = __shfl_up_sync(kFull, ac, off, P);
        const float bl = __shfl_up_sync(kFull, bc, off, P);
        if (s >= off) {
          bc = fmaf(ac, bl, bc);
          ac *= al;
        }
      }
      // the state entering this segment: the exclusive prefix on the carry
      const float ae = __shfl_up_sync(kFull, ac, 1, P);
      const float be = __shfl_up_sync(kFull, bc, 1, P);
      float h = s == 0 ? hc : rnd<R>(fmaf(ae, hc, be));
#pragma unroll
      for (int i = 0; i < SEG; i += 4) {
        const float4 cq = *reinterpret_cast<const float4*>(cseg + n * SEG + i);
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h = rnd<R>(fmaf(ea[i + j], h, eb[i + j]));
          yv[i + j] = fmaf(h, cv[j], yv[i + j]);
        }
      }
      __syncwarp();  // every lane of the channel has read this state's carry
      if (s == P - 1) hs[c * NP + n] = h;
    }
    // y over the u values this thread alone read
#pragma unroll
    for (int i = 0; i < SEG; ++i) us[ui + i * kTC] = yv[i];
    __syncthreads();
    write_out<P, SEG, U, NP, EPI>(p, st, row0 + t0, min(L::kChunk, p.S - t0), c0,
                               tid);
    __syncthreads();  // the stage is free to be refilled
  }
  for (int i = tid; i < kTC * p.N; i += L::kThreads) {
    const int cc = i / p.N, n = i % p.N;
    if (c0 + cc < p.d)
      p.h_last[((long)blockIdx.y * p.d + c0 + cc) * p.N + n] =
          hs[cc * NP + n];
  }
}

template <int P, int SEG, int U, int NP, int EPI, bool R>
int launch(const Params& p, int B, cudaStream_t stream) {
  using L = Layout<P, SEG, U, NP, EPI>;
  auto kern = scan_chunked<P, SEG, U, NP, EPI, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.d + kTC - 1) / kTC, B);
  kern<<<grid, L::kThreads, L::kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// the plan at NP = the power of two >= N
template <int EPI, bool R>
int launch_states(const Params& p, int B, int log2_np, cudaStream_t st) {
  constexpr int P = kSegments, SEG = kSegLen, U = kUnroll;
  switch (log2_np) {
    case 0: return launch<P, SEG, U, 1, EPI, R>(p, B, st);
    case 1: return launch<P, SEG, U, 2, EPI, R>(p, B, st);
    case 2: return launch<P, SEG, U, 4, EPI, R>(p, B, st);
    case 3: return launch<P, SEG, U, 8, EPI, R>(p, B, st);
    case 4: return launch<P, SEG, U, 16, EPI, R>(p, B, st);
    case 5: return launch<P, SEG, U, 32, EPI, R>(p, B, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the f32 state, or (bf16_state) the bf16 one
template <int EPI>
int launch_plan(const Params& p, int B, int log2_np, int bf16_state,
                cudaStream_t st) {
  return bf16_state ? launch_states<EPI, true>(p, B, log2_np, st)
                    : launch_states<EPI, false>(p, B, log2_np, st);
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int log2_states(int N) {
  int k = 0;
  while ((1 << k) < N) ++k;
  return k;
}

Params make_params(const void* u, const void* dt, const void* Bm,
                   const void* Cm, const void* A, void* y, void* h_last,
                   int S, int d, int N) {
  Params p{};
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(dt);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.A = static_cast<const float*>(A);
  p.y = y;
  p.h_last = static_cast<float*>(h_last);
  p.S = S;
  p.d = d;
  p.N = N;
  p.vec_ud = aligned(u, 16) && aligned(dt, 16) && d % 4 == 0;
  p.vec_bc = aligned(Bm, 16) && aligned(Cm, 16) && N % 4 == 0;
  return p;
}

bool bad_shape(int B, int S, int d, int N) {
  return B < 1 || B > 65535 || S < 1 || d < 1 || N < 1 || N > kMaxState;
}

}  // namespace

extern "C" {

// The bare scan. u, dt, y: (B, S, d); Bm, Cm: (B, S, N); A: (d, N);
// h_last: (B, d, N); all f32, contiguous, on one card. bf16_state = 1
// carries the state in bf16 (the file's header note). Returns the first
// CUDA error of the launch (0 when accepted).
int corais_mamba_scan(const void* u, const void* dt, const void* Bm,
                      const void* Cm, const void* A, void* y, void* h_last,
                      int B, int S, int d, int N, int bf16_state,
                      void* stream) {
  if (bad_shape(B, S, d, N)) return (int)cudaErrorInvalidValue;
  Params p = make_params(u, dt, Bm, Cm, A, y, h_last, S, d, N);
  p.vec_y = aligned(y, 16) && d % 4 == 0;
  return launch_plan<kBare>(p, B, log2_states(N), bf16_state,
                            static_cast<cudaStream_t>(stream));
}

// The gated scan: out = (scan(u, softplus(dt_raw + dt_bias), B, C, A)
// + D * u) * silu(z) in z's dtype. u, dt_raw: (B, S, d) f32 contiguous;
// dt_bias, D: (d,) f32; Bm, Cm: (B, S, N) f32 contiguous; A: (d, N) f32;
// z: (B, S, d) bf16 (z_bf16 = 1) or f32, unit last stride, row (b, t) at
// z + (b * S + t) * z_row elements; out: (B, S, d) contiguous in z's
// dtype; h_last: (B, d, N) f32; states: null, or (B, ceil(S / chunk), d,
// N) f32 (chunk = corais_mamba_scan_chunk()) to receive the state entering
// each chunk, which the backward (mamba_scan_bwd.cu) starts from. out and
// h_last are the same bits with states or without. bf16_state = 1 carries
// the state in bf16 (the file's header note).
int corais_mamba_scan_gated(const void* u, const void* dt_raw,
                            const void* dt_bias, const void* Bm,
                            const void* Cm, const void* A, const void* D,
                            const void* z, long long z_row, int z_bf16,
                            void* out, void* h_last, void* states, int B,
                            int S, int d, int N, int bf16_state,
                            void* stream) {
  if (bad_shape(B, S, d, N) || z_row < d) return (int)cudaErrorInvalidValue;
  Params p = make_params(u, dt_raw, Bm, Cm, A, out, h_last, S, d, N);
  p.states = static_cast<float*>(states);
  p.dt_bias = static_cast<const float*>(dt_bias);
  p.D = static_cast<const float*>(D);
  p.z = z;
  p.z_row = z_row;
  const int esize = z_bf16 ? 2 : 4;
  p.vec_z = aligned(z, 4 * esize) && (z_row * esize) % (4 * esize) == 0;
  p.vec_y = aligned(out, 4 * esize) && d % 4 == 0;
  const int lg = log2_states(N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return z_bf16 ? launch_plan<kGatedBF16>(p, B, lg, bf16_state, st)
                : launch_plan<kGatedF32>(p, B, lg, bf16_state, st);
}

// Steps between the saved chunk states.
int corais_mamba_scan_chunk() { return kSegments * kSegLen; }

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
