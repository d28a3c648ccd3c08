// Causal / sliding-window GQA flash-attention forward ("B4") on Hopper
// (sm_90a). Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file
// (wrapper: repro_torch/kernels/flash_attention.py).
//
// What it replaces (JAX reference): the Pallas kernel `_kernel` of
// src/repro/kernels/flash_attention.py:26 (entry flash_attention_fwd, :74),
// which computes ref.flash_attention_ref (src/repro/kernels/ref.py:10):
//   o[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h // G] / sqrt(hd)) v[b, t, h // G]
// over the columns t < Sk allowed by the mask (t <= s if causal, t > s -
// window with a window, both aligned at the top left as the reference's
// model attention has them), with masked scores at -1e30, f32 running max
// and sum, f32 accumulators and the output in q's dtype. Layout (B, Sq, H,
// hd) for q and o, (B, Sk, KV, hd) for k and v, all contiguous; G = H /
// KV. The keys have a length of their own: whisper's decoder attends from
// its Sq tokens to Sk = 1500 encoder frames (the reference's
// models/attention.py pads both to its chunk grid and masks columns >= Sk).
// A row with no allowed column (only where a window ends before the keys
// start) writes 0 and an lse of about -1e30.
// Optionally it also writes each row's log-sum-exp of the scaled, masked
// scores, lse[b, h, s] = m + log(max(l, 1e-30)) from the running max m and
// sum l, (B, H, Sq) f32: the residual the training attention's backward
// (B4b, flash_attention_bwd.cu; the reference's pair-scan `_flash_bwd`,
// models/attention.py:166) takes.
// A null lse pointer writes nothing; `o` is the same either way.
// Logit soft-capping (the reference's `logit_softcap`,
// models/attention.py:32-35, :134): with a cap above 0 every scaled score s
// becomes cap * tanh(s / cap) before the mask and the running max, so the
// softmax and the lse are those of the capped scores. Both plans take the
// cap as a template flag: the uncapped kernels are compiled as before, with
// no test of the cap in their tile loops. Both use CUDA's accurate tanhf
// (2 ulp): tanh.approx.f32's relative error of ~2^-11 becomes an absolute
// error of up to ~cap * 2^-11 on a score (0.025 at Gemma 2's cap of 50),
// a 2.5 % error in a softmax weight, beyond the bf16 bar (ATTN_TOL, 2e-2),
// and the bf16 plan is bound by its tensor-core products, not by the
// score epilogue.
// Unlike the Pallas kernel, which needs S % 128 == 0 and one S for queries
// and keys, it takes any Sq and Sk: rows past Sq are not stored and columns
// past Sk are masked.
//
// What bounds it. At the prefill of the LM edge server (qwen3-4b heads:
// H=32, KV=8, hd=128) and a prompt of S=2048, the causal half is about
// 34 GFLOP on about 21 MB of q, k, v and o in bf16: some 1,600 operations
// per byte, so the card's tensor cores bound it (0.035 ms at the bf16
// peak).
//
// Two kernels, chosen by dtype.
//
// bf16 (the serving path), `flash_fwd_tc`: FlashAttention-2's structure on
// mma.sync tensor-core products. One block of 4 warps per (64-row q tile,
// head, batch row); each warp owns 16 query rows, and the q tiles launch
// heaviest first (the last tile of every head in the first wave), so under
// causality the long rows do not form the tail. K and V tiles of 64 slots
// of KV head h / G arrive by 16-byte cp.async copies in a 2-stage ring:
// tile j+1 is in flight while tile j computes; rows past S are zero-filled
// (src-size 0). Shared memory rows are hd/8 16-byte chunks, stored at
// chunk ^ (row % 8) in a row padded to a multiple of 8 chunks, so that
// ldmatrix reads 8 rows of one chunk from 8 distinct bank groups. Q is
// read once into registers with ldmatrix. S = Q K^T is
// mma.m16n8k16.row.col.f32.bf16 (K row-major (slot, hd) is the .col
// operand, plain ldmatrix): products of bf16 values are exact, the sums
// f32; the scale comes after the product. The online softmax stays in
// registers: a thread holds 2 rows of its warp's 16, row maxima over the
// 4 threads of a quad by xor shuffles; masks are evaluated only on tiles
// that cut the diagonal, the window edge or the end of S, dead tiles are
// not visited. O += P V with P carried to about 16 bits: the S accumulator
// fragments are repacked in registers into the A fragments of P_hi =
// bf16(P) and P_lo = bf16(P - P_hi), and two mma.sync run per step (V
// through ldmatrix.trans). The reference and the plain version keep P in
// f32; one bf16 rounding of P (as SDPA does) would move every output and
// compound over the layers, the split keeps P to ~2^-16 relative for 1.5x
// the tensor-core work of the two products. The epilogue divides by l,
// rounds to bf16, stages the warp's rows in the freed Q tile and stores
// 16-byte chunks of the rows below S. hd is a template parameter, a
// multiple of 16 up to 128; at 128 shared memory is 80 KB (Q, 2 x K,
// 2 x V), two blocks per SM.
//
// f32 (parity runs), `flash_fwd`: the first, simple design, kept as is.
// One block of 256 threads per (64-row q tile, head, batch row); the q
// tile and each K and V tile widened into shared memory; each thread owns
// a 4x4 block of the score tile and a 4x8 block of the output, f32 FMAs on
// the CUDA cores; the row max, sum and rescale factor in shared memory;
// dead tiles skipped; K and V in 16-byte loads (hd a multiple of 4).
//
// The bf16 plan's tiles, copies and products are those of mma_bf16.cuh,
// which B4b's bf16 plan shares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: a 16 x 16 thread grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key columns per tile
constexpr int kMaxHd = 128;
constexpr int kHdPerThread = kMaxHd / 16;  // output columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// 16-byte chunks: 4 f32 elements, loaded with one instruction
constexpr int kMaxChunks = kBK * kMaxHd / 4 / kThreads;  // per thread, f32
template <typename T>
constexpr int kVec = 16 / sizeof(T);
__device__ __forceinline__ void widen(uint4 u, float* dst, const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  dst[0] = f.x;
  dst[1] = f.y;
  dst[2] = f.z;
  dst[3] = f.w;
}

size_t smem_bytes(int hd) {
  // qs[kBQ][hd+1], ks[kBK][hd+1], vs[kBK][hd], ps[kBQ][kBK+1], m, l, alpha
  return sizeof(float) * (size_t)(kBQ * (hd + 1) + kBK * (hd + 1) + kBK * hd +
                                  kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int Sq, int Sk, int H, int KV, int hd,
          int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;  // odd row stride: row-parallel reads hit distinct banks
  float* qs = smem;
  float* ks = qs + kBQ * hdp;
  float* vs = ks + kBK * hdp;
  float* ps = vs + kBK * hd;
  float* m_s = ps + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const long q_stride = (long)H * hd;   // between consecutive s of q and o
  const long kv_stride = (long)KV * hd;  // between consecutive s of k and v
  const T* qb = q + (long)b * Sq * q_stride + (long)h * hd;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * hd;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = q0 + r;
    qs[r * hdp + d] = s < Sq ? to_f32(qb[s * q_stride + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kHdPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) acc[i][j] = 0.f;

  // live kv tiles: [lo, hi]
  const int last_row = min(q0 + kBQ - 1, Sq - 1);
  const int hi = (causal ? min(last_row, Sk - 1) : Sk - 1) / kBK;
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;

  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the previous tile's readers of ks, vs and ps are done
    {  // all of the tile's loads in flight at once, then widen into smem
      const int cpr = hd / kVec<T>, chunks = kBK * cpr;
      uint4 kr[kMaxChunks], vr[kMaxChunks];
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = tid + j * kThreads;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
        const int s = k0 + c / cpr;
        if (c < chunks && s < Sk) {
          const long off = s * kv_stride + (c % cpr) * kVec<T>;
          kr[j] = *reinterpret_cast<const uint4*>(kb + off);
          vr[j] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int c = tid + j * kThreads;
        if (c < chunks) {
          const int r = c / cpr, d0 = (c % cpr) * kVec<T>;
          float kf[kVec<T>], vf[kVec<T>];
          widen(kr[j], kf, kb);
          widen(vr[j], vf, vb);
#pragma unroll
          for (int e = 0; e < kVec<T>; ++e) {
            ks[r * hdp + d0 + e] = kf[e];
            vs[r * hd + d0 + e] = vf[e];
          }
        }
      }
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * hdp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * hdp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        float s = sc[i][j] * scale;
        if (kCap) s = cap * tanhf(s / cap);
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, two columns per lane
    for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
      const int r = warp * (kBQ / (kThreads / 32)) + rr;
      float* prow = ps + r * (kBK + 1);
      const float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kHdPerThread; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kHdPerThread; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float vv = vs[c * hd + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  if (lse != nullptr && tid < kBQ && q0 + tid < Sq)
    lse[((long)b * H + h) * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  T* ob = o + (long)b * Sq * q_stride + (long)h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(ob + s * q_stride + d, acc[i][j] / l);
    }
  }
}

template <bool kCap>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
               int causal, int window, float scale, float cap,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<float, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd<float, kCap><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, hd, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores (mma.sync m16n8k16), cp.async ring, ldmatrix ----

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;  // 16 query rows per warp
constexpr int kStages = 2;                 // K/V tiles in flight: j and j+1

using namespace tc;  // mma_bf16.cuh: the tiles, copies and products
static_assert(kBK == kRows, "B4's K/V tiles are mma_bf16.cuh's 64 rows");

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int KV,
             int causal, int window, float scale, float cap) {
  using L = Tile<HD>;
  constexpr int kKSteps = HD / 16;  // k16 steps of Q K^T
  constexpr int kDTiles = HD / 8;   // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + L::kElems;            // kStages tiles
  bf16* vs = ks + kStages * L::kElems;  // kStages tiles

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tile first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair
  const float inv_cap = kCap ? 1.f / cap : 0.f;

  const long q_stride = (long)H * HD;
  const long kv_stride = (long)KV * HD;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * HD;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * HD;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * HD;

  // live kv tiles: [lo, hi]
  const int last_row = min(q0 + kBQ - 1, Sq - 1);
  const int hi = (causal ? min(last_row, Sk - 1) : Sk - 1) / kBK;
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;

  load_tile<HD, kTcThreads>(qs, qb, q_stride, q0, Sq, tid);
  load_tile<HD, kTcThreads>(ks, kb, kv_stride, lo * kBK, Sk, tid);
  cp_async_commit();  // Q and K[lo]
  load_tile<HD, kTcThreads>(vs, vb, kv_stride, lo * kBK, Sk, tid);
  cp_async_commit();  // V[lo]

  unsigned qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // this thread's two rows: row0 (fragment elements 0, 1), row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + gq;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad at the end

  for (int j = lo; j <= hi; ++j) {
    const int stage = (j - lo) % kStages;
    const bf16* kt = ks + stage * L::kElems;
    const bf16* vt = vs + stage * L::kElems;
    cp_async_wait<1>();  // K[j] (pending: V[j])
    __syncthreads();     // K[j] visible; every warp is past tile j-1
    if (j < hi) {        // tile j+1 into the other stage
      const int nxt = (stage + 1) % kStages;
      load_tile<HD, kTcThreads>(ks + nxt * L::kElems, kb, kv_stride,
                                (j + 1) * kBK, Sk, tid);
      cp_async_commit();
      load_tile<HD, kTcThreads>(vs + nxt * L::kElems, vb, kv_stride,
                                (j + 1) * kBK, Sk, tid);
    } else {
      cp_async_commit();  // empty groups keep the count
    }
    cp_async_commit();

    if (j == lo) {  // Q fragments, once
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldsm_x4(qf[kk], qs + swz(warp * 16 + (lane & 15), 2 * kk + lane / 16,
                                 L::kRowElems));
    }

    // S = Q K^T: 8 n8 tiles of 64 key slots
    float sc[kBK / 8][4];
#pragma unroll
    for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        unsigned kf[4];
        ldsm_x4(kf, kt + swz(np * 16 + (lane & 7) + (lane / 16) * 8,
                             2 * kk + (lane / 8) % 2, L::kRowElems));
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale and cap every score; masks only on tiles that cut the
    // diagonal, window or end of Sk
    const int k0 = j * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[nt][e] * scale;
        if (kCap) s = cap * tanhf(s * inv_cap);
        if (edge) {
          const int col = k0 + nt * 8 + 2 * tq + (e & 1);
          const int row = row0 + (e / 2) * 8;
          bool ok = col < Sk;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          if (!ok) s = kNegInf;
        }
        sc[nt][e] = s;
      }

    // online softmax in registers, rows shared by the 4 threads of a quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = sc[0][2 * i];
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float p = expf(sc[nt][e] - m_new);
          sc[nt][e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
    }

    cp_async_wait<2>();  // V[j] (pending: K[j+1], V[j+1])
    __syncthreads();     // V[j] visible

    // O += P_hi V + P_lo V, k16 steps of 16 key slots
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned ph[4], pl[4];  // A fragments: rows g, g+8; columns 2t, 2t+8
      split_frags(sc[2 * kk], sc[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned vf[4];
        ldsm_x4_t(vf, vt + swz(kk * 16 + (lane & 7) + ((lane / 8) % 2) * 8,
                               2 * dp + lane / 16, L::kRowElems));
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }

  // epilogue: o = acc / l in bf16, staged in this warp's rows of the Q tile
  // (read only at tile lo, before two barriers), stored in 16-byte chunks.
  // With no live tile (a window that ends before the keys start) the loop
  // never waited for the first copies: wait for every thread's now.
  if (lo > hi) {
    cp_async_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    const int s = row0 + 8 * i;  // m[i] is the quad's; one thread stores
    if (lse != nullptr && tq == 0 && s < Sq)
      lse[((long)b * H + h) * Sq + s] = m[i] + logf(l[i]);
  }
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gq + 8 * i;
      *reinterpret_cast<__nv_bfloat162*>(qs + swz(r, dt, L::kRowElems) +
                                         2 * tq) =
          __floats2bfloat162_rn(acc[dt][2 * i] / l[i],
                                acc[dt][2 * i + 1] / l[i]);
    }
  __syncwarp();
  bf16* ob = o + (long)b * Sq * q_stride + (long)h * HD;
#pragma unroll
  for (int c = lane; c < 16 * L::kChunks; c += 32) {
    const int r = warp * 16 + c / L::kChunks, ch = c % L::kChunks;
    const int s = q0 + r;
    if (s < Sq)
      *reinterpret_cast<uint4*>(ob + s * q_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(qs + swz(r, ch, L::kRowElems));
  }
}

template <int HD, bool kCap>
int launch_tc_plan(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV,
                   int causal, int window, float scale, float cap,
                   cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (1 + 2 * kStages) * Tile<HD>::kElems;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_fwd_tc<HD, kCap><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Sk, H,
      KV, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
              int window, float scale, float cap, cudaStream_t stream) {
  return cap > 0.f
             ? launch_tc_plan<HD, true>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                        causal, window, scale, cap, stream)
             : launch_tc_plan<HD, false>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                         causal, window, scale, cap, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Sk, int H, int KV, int hd,
                int causal, int window, float scale, float cap,
                cudaStream_t st) {
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 32: return launch_tc<32>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 48: return launch_tc<48>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 64: return launch_tc<64>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 80: return launch_tc<80>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 96: return launch_tc<96>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 112: return launch_tc<112>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, S, Sk, H, KV, causal, window, scale, cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, Sk, KV, hd); contiguous, all f32 or all
// bf16 (is_bf16). f32: hd <= 128 a multiple of 4, k and v 16-byte aligned.
// bf16: hd <= 128 a multiple of 16, q, k, v and o 16-byte aligned.
// window <= 0 means no window. softcap > 0 caps the scaled scores at
// softcap * tanh(s / softcap); 0 means no cap. lse: (B, H, S) f32, or null
// for none. Returns the first CUDA error of the launch (0 when it was
// accepted).
int corais_flash_attention(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int S, int Sk, int H,
                           int KV, int hd, int causal, int window,
                           float scale, float softcap, int is_bf16,
                           void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > kMaxHd || !(softcap >= 0.f) ||
      !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd % 16 != 0 || !aligned16(q) || !aligned16(o))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(q, k, v, o, static_cast<float*>(lse), B, S, Sk, H,
                       KV, hd, causal, window, scale, softcap, st);
  }
  if (hd % 4 != 0) return (int)cudaErrorInvalidValue;
  float* ls = static_cast<float*>(lse);
  return softcap > 0.f
             ? launch_f32<true>(q, k, v, o, ls, B, S, Sk, H, KV, hd, causal,
                                window, scale, softcap, st)
             : launch_f32<false>(q, k, v, o, ls, B, S, Sk, H, KV, hd, causal,
                                 window, scale, softcap, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
