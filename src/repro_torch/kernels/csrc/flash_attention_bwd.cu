// The training attention's backward ("B4b") on Hopper (sm_90a). Built by
// repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file
// (wrapper: repro_torch/kernels/flash_attention_bwd.py).
//
// What it replaces: no Pallas kernel. The reference differentiates its
// flash attention with a custom VJP whose backward, `_flash_bwd`
// (src/repro/models/attention.py:166-233), is a pure-jnp scan over block
// pairs; the port's plain version of it is ref.flash_attention_bwd_torch.
// B4 (flash_attention.cu) computes that VJP's forward with the rows'
// log-sum-exp; this kernel computes its backward, so that no card path runs
// the plain pair-scan. It computes, for q, out, dout (B, Sq, H, hd), k, v
// (B, Sk, KV, hd) and lse (B, H, Sq) f32 as B4 writes it, G = H / KV:
//   delta[r]  = sum_d dout[r, d] out[r, d]
//   s[r, c]   = scale q[r] . k[c], capped to cap tanh(s / cap) when cap > 0,
//               -1e30 where the mask refuses (r, c)
//   p[r, c]   = exp(s[r, c] - lse[r])
//   ds[r, c]  = p (dout[r] . v[c] - delta[r]), times 1 - tanh^2(s_raw / cap)
//               under a cap, 0 where the mask refuses (r, c)
//   dq[r] = scale sum_c ds[r, c] k[c];  dk[c] = scale sum_{r, g} ds[r, c] q[r];
//   dv[c] = sum_{r, g} p[r, c] dout[r]
// over the columns c < Sk and the rows r < Sq, the masks (causal, window)
// aligned at the top left as B4's, dk and dv summed over the G query heads
// of a KV head; the gradients in the inputs' dtype. A row with no allowed
// column (a window that ends before the keys start) has lse = -1e30, so its
// p is exp(0) = 1 at every column: it adds its dout to dv[c] for every
// c < Sk, as the plain pair-scan does when one block holds all of Sq, and
// nothing to dq or dk. The result does not depend on the reference's
// `chunk`.
//
// What bounds it. At olmo-1b's training heads (B = 8, S = 1024, H = KV =
// 16, hd = 128, causal, bf16) the backward's five products over the kept
// pairs are about 86 GFLOP on about 0.2 GB read and written: some 400
// operations per byte, above the H100's ~295, so the bf16 tensor cores
// bound it (0.087 ms at 989 TFLOP/s).
//
// Two passes and no float atomics, so that every call gives the same bits
// (a resumed training run is bit-identical to an uninterrupted one):
//  1. the dq pass, one block per q tile, head and batch row: computes
//     delta for its rows in its prologue and writes it (B, H, Sq) f32, then
//     walks the live K/V tiles and sums ds k for its rows in registers;
//  2. the dk/dv pass, one block per key tile, KV head and batch row: keeps
//     dk and dv of its keys in registers and walks the G query heads and,
//     for each, the q tiles that hold an allowed pair (then the q tiles of
//     rows with no allowed column), in that fixed order, reading delta.
// S and dP are computed in both passes: seven products where an atomic
// plan has five, and P and dS enter dV = P^T dO, dQ = dS K and dK = dS^T Q
// as two bf16 terms, hi + lo (the reference keeps them in f32, and one
// bf16 rounding would move every gradient): ten products' worth of tensor
// work a kept pair, twice the bound's five. Dead tiles are not visited;
// the masks are evaluated only on tiles that cut the diagonal, the window
// edge or the end of Sq or Sk.
//
// bf16 at hd = 64 and 128 (every card path's), `flash_bwd_dq_wg` and
// `flash_bwd_dkdv_wg`: Hopper's own machinery (wgmma_bf16.cuh). A block is
// a producer warpgroup and two consumer warpgroups (384 threads, one block
// an SM; setmaxnreg leaves the producer 24 registers a thread and gives
// the consumers 240). One producer thread loads the block's stationary
// tiles (Q and dO of its 128 rows in pass 1; K and V of its 128 keys in
// pass 2) by TMA, then runs a ring of kRing stages through full and empty
// mbarriers (the K/V tiles in pass 1; the Q/dO tiles with their lse and
// delta, which the producer warp's lanes load, in pass 2). Tiles are 64
// rows of 64 bf16 per box in TMA's 128-byte swizzle, zero past Sq or Sk,
// the layout the wgmma descriptors read. Each consumer warpgroup owns 64
// of the block's rows (pass 1) or keys (pass 2): S = Q K^T and dP = dO V^T
// (S^T = K Q^T and dP^T = V dO^T in pass 2) are wgmma with both operands
// in shared memory, K-major; P is formed from the accumulators while dP is
// in flight, then dS; both split into hi + lo A fragments in registers
// (wgmma's m64nN accumulator layout is mma.sync's A fragment layout), and
// dQ += dS K (dV += P^T dO, dK += dS^T Q) are register-A wgmma with the B
// operand MN-major. A group waits for its own products at the end of each
// tile, and the other group's products run under its element-wise work
// (issuing the next tile's S behind the RS products made ptxas serialize
// every product, C7514-C7520 in its report, and was slower). The
// exponentials are one ex2 each, log2 e folded into the scale and lse, and
// the masks are evaluated in a loop of their own on the edge tiles only.
// What bounds it on an H100 (80GB HBM3, 700 W): 0.41 ms at olmo-1b's heads,
// 4.7x the bound. Per tile a group spends about a third of its cycles (two
// fifths at hd = 64) on P, dS and the split, which only the other group's
// products hide, and the split's lo products are a fifth of the time
// (`tools/b4b_timing.py --probes` and `--variants`).
//
// bf16 at the other multiples of 16 up to 128, `flash_bwd_dq_tc` and
// `flash_bwd_dkdv_tc`: B4's machinery (mma_bf16.cuh): 4 warps, each owning
// 16 rows of the block's 64-row tile (queries in pass 1, keys in pass 2);
// tiles in swizzled shared memory, filled by 16-byte cp.async copies in a
// 2-stage ring; the products mma.sync m16n8k16 with f32 sums, operands by
// ldmatrix (.trans for the (k, n)-stored ones), the B operands read again
// by every warp (about 16 operations a byte of shared memory). The warp's
// 16 x hd accumulators stay in registers; shared memory is 6 tiles (three
// blocks an SM at hd <= 64).
//
// f32 (parity runs), `flash_bwd_dq_f32` and `flash_bwd_dkdv_f32`: the same
// two passes on the CUDA cores, as B4's f32 plan: 256 threads, the tiles
// widened into shared memory, each thread a 4 x 4 block of S and dP and a
// 4 x 8 block of its accumulators, P and dS staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace tc;

constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 64;  // keys of a tile
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kRows && kBK == kRows, "tiles of mma_bf16.cuh's rows");

// Whether a (row, column) pair is allowed: inside Sq and Sk, causal
// (col <= row) and in the window (col > row - window), from the top left.
__device__ __forceinline__ bool allowed(int row, int col, int Sq, int Sk,
                                        int causal, int window) {
  bool ok = col < Sk && row < Sq;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

// Whether a (q tile at q0, key tile at k0) pair holds a refused pair.
__device__ __forceinline__ bool cuts(int q0, int k0, int Sq, int Sk,
                                     int causal, int window) {
  return k0 + kBK > Sk || q0 + kBQ > Sq || (causal && k0 + kBK - 1 > q0) ||
         (window > 0 && k0 <= q0 + kBQ - 1 - window);
}

// ---- f32: CUDA cores ----

constexpr int kThreads = 256;  // 8 warps: a 16 x 16 thread grid
constexpr int kHdPerThread = kMaxHd / 16;

// rows r0 .. r0+63 of a (row stride `stride`) f32 matrix into dst[64][hdp],
// zero past S
__device__ __forceinline__ void widen_rows(float* dst, const float* src,
                                           long stride, int r0, int S,
                                           int hd, int hdp, int tid) {
  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = r0 + r;
    dst[r * hdp + d] = s < S ? src[s * stride + d] : 0.f;
  }
}

size_t smem_dq_f32(int hd) {
  // qs, dos, ks, vs [64][hd+1]; ps [64][65]; lse, delta
  return sizeof(float) *
         (size_t)(4 * kRows * (hd + 1) + kBQ * (kBK + 1) + 2 * kBQ);
}

template <bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ lse,
                 const float* __restrict__ dout, float* __restrict__ dq,
                 float* __restrict__ delta, int Sq, int Sk, int H, int KV,
                 int hd, int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* qs = smem;
  float* dos = qs + kRows * hdp;
  float* ks = dos + kRows * hdp;
  float* vs = ks + kRows * hdp;
  float* ps = vs + kRows * hdp;
  float* lse_s = ps + kBQ * (kBK + 1);
  float* dl_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const long q_stride = (long)H * hd, kv_stride = (long)KV * hd;
  const long qoff = (long)b * Sq * q_stride + (long)h * hd;
  const long koff = (long)b * Sk * kv_stride + (long)kvh * hd;
  const long roff = ((long)b * H + h) * Sq;

  widen_rows(qs, q + qoff, q_stride, q0, Sq, hd, hdp, tid);
  widen_rows(dos, dout + qoff, q_stride, q0, Sq, hd, hdp, tid);
  __syncthreads();
  // delta: warp w the rows 8w .. 8w+7
  for (int rr = 0; rr < kBQ / (kThreads / 32); ++rr) {
    const int r = warp * (kBQ / (kThreads / 32)) + rr, s = q0 + r;
    float d = 0.f;
    if (s < Sq)
      for (int c = lane; c < hd; c += 32)
        d = fmaf(o[qoff + s * q_stride + c], dos[r * hdp + c], d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      dl_s[r] = d;
      lse_s[r] = s < Sq ? lse[roff + s] : 0.f;
      if (s < Sq) delta[roff + s] = d;
    }
  }

  float acc[4][kHdPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) acc[i][j] = 0.f;

  const int last_row = min(q0 + kBQ - 1, Sq - 1);
  const int hi = (causal ? min(last_row, Sk - 1) : Sk - 1) / kBK;
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;

  for (int jt = lo; jt <= hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
    widen_rows(ks, k + koff, kv_stride, k0, Sk, hd, hdp, tid);
    widen_rows(vs, v + koff, kv_stride, k0, Sk, hd, hdp, tid);
    __syncthreads();

    // S and dP: rows ty + 16 i, columns tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * hdp + d];
        dov[i] = dos[(ty + 16 * i) * hdp + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * hdp + d];
        vv[j] = vs[(tx + 16 * j) * hdp + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
    const bool edge = cuts(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok =
            !edge || allowed(q0 + r, k0 + c, Sq, Sk, causal, window);
        float s = sc[i][j] * scale, t = 0.f;
        if (kCap) {
          t = tanhf(s / cap);
          s = cap * t;
        }
        if (!ok) s = kNegInf;
        const float p = expf(s - lse_s[r]);
        float ds = p * (dp[i][j] - dl_s[r]);
        if (kCap) ds *= 1.f - t * t;
        ps[r * (kBK + 1) + c] = ok ? ds : 0.f;
      }
    }
    __syncthreads();

    // dq += dS K: rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kHdPerThread; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float kk = ks[c * hdp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], kk, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= Sq) continue;
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[qoff + s * q_stride + d] = acc[i][j] * scale;
    }
  }
}

// The q tiles the dk/dv pass of key tile k0 visits, for each query head:
// [qlo, qlo + n1) hold an allowed pair with the tile; [r2, r2 + n2) hold
// rows with no allowed column at all, whose p is 1 at every key.
struct QTiles {
  int qlo, n1, r2, n2;
  __device__ __forceinline__ int at(int idx) const {
    return idx < n1 ? qlo + idx : r2 + idx - n1;
  }
};

template <int kKeys = kBK>  // keys of the tile
__device__ __forceinline__ QTiles q_tiles(int k0, int Sq, int Sk, int causal,
                                          int window) {
  const int nq = (Sq + kBQ - 1) / kBQ;
  const long long cmax = min(k0 + kKeys - 1, Sk - 1);
  const int qlo = causal ? k0 / kBQ : 0;
  int qhi = nq - 1;  // the last q tile with a row before cmax + window
  if (window > 0 && (cmax + window - 1) / kBQ < qhi)
    qhi = (int)((cmax + window - 1) / kBQ);
  QTiles t;
  t.qlo = qlo;
  t.n1 = max(0, qhi - qlo + 1);
  int e_lo = nq;  // the first q tile holding a row with no allowed column
  if (window > 0 && (long long)Sk + window - 1 < Sq)
    e_lo = (Sk + window - 1) / kBQ;
  t.r2 = max(e_lo, t.n1 > 0 ? qhi + 1 : 0);
  t.n2 = max(0, nq - t.r2);
  return t;
}

size_t smem_dkdv_f32(int hd) {
  // ks, vs, qs, dos [64][hd+1]; pt, dst [64][65]; lse, delta
  return sizeof(float) *
         (size_t)(4 * kRows * (hd + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ);
}

template <bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ dout, float* __restrict__ dk,
                   float* __restrict__ dv, int Sq, int Sk, int H, int KV,
                   int hd, int causal, int window, float scale, float cap) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* ks = smem;
  float* vs = ks + kRows * hdp;
  float* qs = vs + kRows * hdp;
  float* dos = qs + kRows * hdp;
  float* pt = dos + kRows * hdp;
  float* dst = pt + kBK * (kBQ + 1);
  float* lse_s = dst + kBK * (kBQ + 1);
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long q_stride = (long)H * hd, kv_stride = (long)KV * hd;
  const long koff = (long)b * Sk * kv_stride + (long)kvh * hd;

  widen_rows(ks, k + koff, kv_stride, k0, Sk, hd, hdp, tid);
  widen_rows(vs, v + koff, kv_stride, k0, Sk, hd, hdp, tid);

  float dka[4][kHdPerThread], dva[4][kHdPerThread];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) dka[i][j] = dva[i][j] = 0.f;

  const QTiles tiles = q_tiles(k0, Sq, Sk, causal, window);
  const int per_head = tiles.n1 + tiles.n2;
  for (int it = 0; it < G * per_head; ++it) {
    const int h = kvh * G + it / per_head;
    const int q0 = tiles.at(it % per_head) * kBQ;
    const long qoff = (long)b * Sq * q_stride + (long)h * hd;
    const long roff = ((long)b * H + h) * Sq;
    __syncthreads();  // the previous pair's readers are done
    widen_rows(qs, q + qoff, q_stride, q0, Sq, hd, hdp, tid);
    widen_rows(dos, dout + qoff, q_stride, q0, Sq, hd, hdp, tid);
    if (tid < kBQ) {
      const int s = q0 + tid;
      lse_s[tid] = s < Sq ? lse[roff + s] : 0.f;
      dl_s[tid] = s < Sq ? delta[roff + s] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: keys ty + 16 i, queries tx + 16 j
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty + 16 * i) * hdp + d];
        vv[i] = vs[(ty + 16 * i) * hdp + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * hdp + d];
        dov[j] = dos[(tx + 16 * j) * hdp + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
          dpt[i][j] = fmaf(dov[j], vv[i], dpt[i][j]);
        }
    }
    const bool edge = cuts(q0, k0, Sq, Sk, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool ok =
            !edge || allowed(q0 + r, k0 + key, Sq, Sk, causal, window);
        float s = st[i][j] * scale, t = 0.f;
        if (kCap) {
          t = tanhf(s / cap);
          s = cap * t;
        }
        if (!ok) s = kNegInf;
        const float p = expf(s - lse_s[r]);
        float ds = p * (dpt[i][j] - dl_s[r]);
        if (kCap) ds *= 1.f - t * t;
        pt[key * (kBQ + 1) + r] = p;
        dst[key * (kBQ + 1) + r] = ok ? ds : 0.f;
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T Q: keys ty + 16 i, columns tx + 16 j
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pt[(ty + 16 * i) * (kBQ + 1) + r];
        sv[i] = dst[(ty + 16 * i) * (kBQ + 1) + r];
      }
#pragma unroll
      for (int j = 0; j < kHdPerThread; ++j) {
        const int d = tx + 16 * j;
        if (d < hd) {
          const float dov = dos[r * hdp + d], qv = qs[r * hdp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][j] = fmaf(pv[i], dov, dva[i][j]);
            dka[i][j] = fmaf(sv[i], qv, dka[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= Sk) continue;
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[koff + s * kv_stride + d] = dka[i][j] * scale;
        dv[koff + s * kv_stride + d] = dva[i][j];
      }
    }
  }
}

template <bool kCap>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
               int hd, int causal, int window, float scale, float cap,
               cudaStream_t st) {
  const float *qf = static_cast<const float*>(q),
              *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v),
              *dof = static_cast<const float*>(dout);
  size_t smem = smem_dq_f32(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32<kCap><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, smem,
                           st>>>(qf, kf, vf, static_cast<const float*>(o),
                                 lse, dof, static_cast<float*>(dq), delta, Sq,
                                 Sk, H, KV, hd, causal, window, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = smem_dkdv_f32(hd);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32<kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32<kCap><<<dim3((Sk + kBK - 1) / kBK, KV, B), kThreads,
                             smem, st>>>(
      qf, kf, vf, lse, delta, dof, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KV, hd, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores (mma.sync m16n8k16), cp.async ring, ldmatrix ----

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;  // 16 rows of the tile per warp
constexpr int kStages = 2;                 // tiles in flight: this and next
constexpr int kNT = kBK / 8;               // n8 tiles of a 64-wide product
// Blocks an SM asked of the compiler: three at hd <= 64 (168 registers a
// thread), one at larger hd, where three spill over 1 KB a thread in the
// dk/dv pass.
template <int HD>
constexpr int kMinBlocks = HD <= 64 ? 3 : 1;
static_assert(kTcThreads == 2 * kBQ, "pass 2 loads lse and delta by row");

// A fragments of rows row0 .. row0+15 of tile t at k16 step kk
template <int HD>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const bf16* t,
                                       int row0, int kk, int lane) {
  ldsm_x4(a, t + swz(row0 + (lane & 15), 2 * kk + lane / 16,
                     Tile<HD>::kRowElems));
}

// B fragments of n8 tiles 2 np and 2 np + 1 at k16 step kk, of a tile
// stored (n, k): its rows are the product's columns
template <int HD>
__device__ __forceinline__ void frag_b_nk(unsigned (&b)[4], const bf16* t,
                                          int np, int kk, int lane) {
  ldsm_x4(b, t + swz(np * 16 + (lane & 7) + (lane / 16) * 8,
                     2 * kk + (lane / 8) % 2, Tile<HD>::kRowElems));
}

// ... of a tile stored (k, n): its rows are the product's depth
template <int HD>
__device__ __forceinline__ void frag_b_kn(unsigned (&b)[4], const bf16* t,
                                          int kk, int np, int lane) {
  ldsm_x4_t(b, t + swz(kk * 16 + (lane & 7) + ((lane / 8) % 2) * 8,
                       2 * np + lane / 16, Tile<HD>::kRowElems));
}

// c (16 x 64) = rows row0 .. row0+15 of x times y^T (64 rows): x and y
// stored (row, hd)
template <int HD>
__device__ __forceinline__ void rows_by_rows(float (&c)[kNT][4],
                                             const bf16* x, int row0,
                                             const bf16* y, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned a[4];
    frag_a<HD>(a, x, row0, kk, lane);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      unsigned bb[4];
      frag_b_nk<HD>(bb, y, np, kk, lane);
      mma_bf16(c[2 * np], a, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc (16 x HD) += c (16 x 64, f32, as hi + lo bf16) times y (64 rows of
// HD, stored (row, hd))
template <int HD>
__device__ __forceinline__ void add_split_by(float (&acc)[HD / 8][4],
                                             const float (&c)[kNT][4],
                                             const bf16* y, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    unsigned hi[4], lo[4];
    split_frags(c[2 * kk], c[2 * kk + 1], hi, lo);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      unsigned bb[4];
      frag_b_kn<HD>(bb, y, kk, dp, lane);
      mma_bf16(acc[2 * dp], hi, bb[0], bb[1]);
      mma_bf16(acc[2 * dp], lo, bb[0], bb[1]);
      mma_bf16(acc[2 * dp + 1], hi, bb[2], bb[3]);
      mma_bf16(acc[2 * dp + 1], lo, bb[2], bb[3]);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one ex2, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lse log2 e, rounded on its own: never fused into the fma of x - lse
// log2 e, which would leave a row with no allowed column (lse -1e30) the
// product's rounding error, some 2^76, in place of 0 against the refused
// pair's -1e30 log2 e, so p inf or 0 where it is 1
__device__ __forceinline__ float lse_log2e(float lse) {
  return __fmul_rn(lse, kLog2e);
}

// p = exp(s - lse) over a warp's 16 x 64 block of scaled, capped, masked
// scores, in place, as 2^(s log2 e - lse log2 e): `lse2` gives lse log2 e,
// so that an uncapped score takes one fma and one ex2. The cap's tanh is
// kept in th and the allowed pairs in the bits of `live` (bit 4 nt + e).
// Fragment element (nt, e) sits at row `row(e)` (the warp's rows) and
// column `col(nt, e)`. The masks are evaluated on the tiles that cut an
// edge only (kMasked), in a loop of their own; a refused pair's score is
// -1e30 log2 e, so that a row with no allowed column (lse -1e30) has p = 1.
template <bool kCap, bool kMasked, typename RowOf, typename ColOf,
          typename Lse, typename Ok>
__device__ __forceinline__ unsigned probabilities_of(
    float (&c)[kNT][4], float (&th)[kCap ? kNT : 1][4], float scale,
    float cap, float inv_cap, RowOf row, ColOf col, Lse lse2, Ok ok) {
  const float scale2 = scale * kLog2e, cap2 = cap * kLog2e;
  unsigned live = 0xffffffffu;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if constexpr (kCap) {
        const float t = tanhf(c[nt][e] * scale * inv_cap);
        th[nt][e] = t;
        x = cap2 * t;
      } else {
        x = c[nt][e] * scale2;
      }
      if (kMasked && !ok(row(e), col(nt, e))) {
        x = kNegInf * kLog2e;
        live &= ~(1u << (4 * nt + e));
      }
      c[nt][e] = ex2(x - lse2(nt, e));
    }
  return live;
}

template <bool kCap, typename RowOf, typename ColOf, typename Lse,
          typename Ok>
__device__ __forceinline__ unsigned probabilities(
    float (&c)[kNT][4], float (&th)[kCap ? kNT : 1][4], bool edge,
    float scale, float cap, float inv_cap, RowOf row, ColOf col, Lse lse2,
    Ok ok) {
  return edge ? probabilities_of<kCap, true>(c, th, scale, cap, inv_cap, row,
                                             col, lse2, ok)
              : probabilities_of<kCap, false>(c, th, scale, cap, inv_cap,
                                              row, col, lse2, ok);
}

// ds = p (dp - delta) (1 - th^2 under a cap), 0 off the allowed pairs, in
// place of dp
template <bool kCap, typename Delta>
__device__ __forceinline__ void score_grads(
    float (&dp)[kNT][4], const float (&p)[kNT][4],
    const float (&th)[kCap ? kNT : 1][4], unsigned live, Delta delta) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ds = p[nt][e] * (dp[nt][e] - delta(nt, e));
      if constexpr (kCap) ds *= 1.f - th[nt][e] * th[nt][e];
      dp[nt][e] = (live >> (4 * nt + e)) & 1u ? ds : 0.f;
    }
}

// rows row0 .. row0+15 of the tile t: acc (16 x HD, f32) times `mul`,
// rounded to bf16 into the warp's own rows of t, then 16-byte chunks of
// the rows below S stored at dst (row stride `stride`) from r0
template <int HD>
__device__ __forceinline__ void store_rows(bf16* t, int row0,
                                           const float (&acc)[HD / 8][4],
                                           float mul, bf16* dst, long stride,
                                           int r0, int S, int lane) {
  using L = Tile<HD>;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(
          t + swz(row0 + gq + 8 * i, dt, L::kRowElems) + 2 * tq) =
          __floats2bfloat162_rn(acc[dt][2 * i] * mul,
                                acc[dt][2 * i + 1] * mul);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * L::kChunks; c += 32) {
    const int r = row0 + c / L::kChunks, ch = c % L::kChunks;
    const int s = r0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(dst + s * stride + ch * 8) =
          *reinterpret_cast<const uint4*>(t + swz(r, ch, L::kRowElems));
  }
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<HD>)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const float* __restrict__ lse,
                const bf16* __restrict__ dout, bf16* __restrict__ dq,
                float* __restrict__ delta, int Sq, int Sk, int H, int KV,
                int causal, int window, float scale, float cap) {
  using L = Tile<HD>;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dos = qs + L::kElems;
  bf16* ks = dos + L::kElems;           // kStages tiles
  bf16* vs = ks + kStages * L::kElems;  // kStages tiles

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tile first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const float inv_cap = kCap ? 1.f / cap : 0.f;

  const long q_stride = (long)H * HD, kv_stride = (long)KV * HD;
  const long qoff = (long)b * Sq * q_stride + (long)h * HD;
  const long koff = (long)b * Sk * kv_stride + (long)kvh * HD;
  const long roff = ((long)b * H + h) * Sq;

  // live kv tiles: [lo, hi], as B4's
  const int last_row = min(q0 + kBQ - 1, Sq - 1);
  const int hi = (causal ? min(last_row, Sk - 1) : Sk - 1) / kBK;
  int lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBK;

  load_tile<HD, kTcThreads>(qs, q + qoff, q_stride, q0, Sq, tid);
  load_tile<HD, kTcThreads>(dos, dout + qoff, q_stride, q0, Sq, tid);
  load_tile<HD, kTcThreads>(ks, k + koff, kv_stride, lo * kBK, Sk, tid);
  cp_async_commit();  // Q, dO and K[lo]
  load_tile<HD, kTcThreads>(vs, v + koff, kv_stride, lo * kBK, Sk, tid);
  cp_async_commit();  // V[lo]

  // this thread's two rows: row0 (fragment elements 0, 1), row0 + 8 (2, 3);
  // delta over the quad's columns 2 tq + 8 m, summed over the quad
  const int row0 = q0 + warp * 16 + gq;
  float lse_r[2], dl_r[2];  // lse log2 e, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = row0 + 8 * i;
    float d = 0.f;
    if (s < Sq) {
      const bf16* orow = o + qoff + s * q_stride;
      const bf16* drow = dout + qoff + s * q_stride;
#pragma unroll
      for (int c = 2 * tq; c < HD; c += 8) {
        const float2 of = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 df = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + c));
        d = fmaf(of.x, df.x, d);
        d = fmaf(of.y, df.y, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dl_r[i] = d;
    lse_r[i] = s < Sq ? lse_log2e(lse[roff + s]) : 0.f;
    if (tq == 0 && s < Sq) delta[roff + s] = d;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float th[kCap ? kNT : 1][4];

  for (int j = lo; j <= hi; ++j) {
    const int stage = (j - lo) % kStages;
    const bf16* kt = ks + stage * L::kElems;
    const bf16* vt = vs + stage * L::kElems;
    cp_async_wait<1>();  // K[j] (pending: V[j])
    __syncthreads();     // K[j] visible; every warp is past tile j-1
    if (j < hi) {        // tile j+1 into the other stage
      const int nxt = (stage + 1) % kStages;
      load_tile<HD, kTcThreads>(ks + nxt * L::kElems, k + koff, kv_stride,
                                (j + 1) * kBK, Sk, tid);
      cp_async_commit();
      load_tile<HD, kTcThreads>(vs + nxt * L::kElems, v + koff, kv_stride,
                                (j + 1) * kBK, Sk, tid);
    } else {
      cp_async_commit();  // empty groups keep the count
    }
    cp_async_commit();

    const int k0 = j * kBK;
    float p[kNT][4];
    rows_by_rows<HD>(p, qs, warp * 16, kt, lane);  // S = Q K^T
    const unsigned live = probabilities<kCap>(
        p, th, cuts(q0, k0, Sq, Sk, causal, window), scale, cap, inv_cap,
        [&](int e) { return row0 + (e / 2) * 8; },
        [&](int nt, int e) { return k0 + nt * 8 + 2 * tq + (e & 1); },
        [&](int, int e) { return lse_r[e / 2]; },
        [&](int r, int c) { return allowed(r, c, Sq, Sk, causal, window); });

    cp_async_wait<2>();  // V[j] (pending: K[j+1], V[j+1])
    __syncthreads();     // V[j] visible
    float ds[kNT][4];
    rows_by_rows<HD>(ds, dos, warp * 16, vt, lane);  // dP = dO V^T
    score_grads<kCap>(ds, p, th, live,
                      [&](int, int e) { return dl_r[e / 2]; });
    add_split_by<HD>(acc, ds, kt, lane);  // dQ += dS K
  }

  // With no live tile the loop never waited for the first copies.
  if (lo > hi) {
    cp_async_wait<0>();
    __syncthreads();
  }
  // this warp's rows of the Q tile are read by this warp only
  store_rows<HD>(qs, warp * 16, acc, scale, dq + qoff, q_stride, q0, Sq,
                 lane);
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<HD>)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const bf16* __restrict__ dout, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                  int causal, int window, float scale, float cap) {
  using L = Tile<HD>;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + L::kElems;
  bf16* qs = vs + L::kElems;             // kStages tiles
  bf16* dos = qs + kStages * L::kElems;  // kStages tiles
  float* lse_s = reinterpret_cast<float*>(dos + kStages * L::kElems);
  float* dl_s = lse_s + kStages * kBQ;

  const int kvh = blockIdx.x, k0 = blockIdx.y * kBK, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const float inv_cap = kCap ? 1.f / cap : 0.f;
  const long q_stride = (long)H * HD, kv_stride = (long)KV * HD;
  const long koff = (long)b * Sk * kv_stride + (long)kvh * HD;

  const QTiles tiles = q_tiles(k0, Sq, Sk, causal, window);
  const int per_head = tiles.n1 + tiles.n2;
  const int total = G * per_head;

  // pair `it` (head kvh G + it / per_head, its q tile it % per_head) into
  // stage st: Q and dO rows, lse and delta (0 past Sq)
  auto load_pair = [&](int it, int st) {
    const int h = kvh * G + it / per_head;
    const int q0 = tiles.at(it % per_head) * kBQ;
    const long qoff = (long)b * Sq * q_stride + (long)h * HD;
    const long roff = ((long)b * H + h) * Sq;
    load_tile<HD, kTcThreads>(qs + st * L::kElems, q + qoff, q_stride, q0,
                              Sq, tid);
    load_tile<HD, kTcThreads>(dos + st * L::kElems, dout + qoff, q_stride,
                              q0, Sq, tid);
    const int r = tid % kBQ, s = q0 + r;
    const float* src = tid < kBQ ? lse : delta;
    float* dst = (tid < kBQ ? lse_s : dl_s) + st * kBQ + r;
    cp_async4(dst, src + roff + (s < Sq ? s : 0), s < Sq);
  };

  load_tile<HD, kTcThreads>(ks, k + koff, kv_stride, k0, Sk, tid);
  load_tile<HD, kTcThreads>(vs, v + koff, kv_stride, k0, Sk, tid);
  if (total > 0) load_pair(0, 0);
  cp_async_commit();  // K, V and pair 0

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  float th[kCap ? kNT : 1][4];
  const int key0 = k0 + warp * 16 + gq;  // this thread's keys key0, key0 + 8

  for (int it = 0; it < total; ++it) {
    const int st = it % kStages;
    cp_async_wait<0>();  // pair it
    __syncthreads();     // pair it visible; every warp is past pair it-1
    if (it + 1 < total) load_pair(it + 1, (it + 1) % kStages);
    cp_async_commit();

    const int q0 = tiles.at(it % per_head) * kBQ;
    const bf16* qt = qs + st * L::kElems;
    const bf16* dot = dos + st * L::kElems;
    const float* ls = lse_s + st * kBQ;
    const float* dls = dl_s + st * kBQ;
    auto qcol = [&](int nt, int e) { return nt * 8 + 2 * tq + (e & 1); };

    float p[kNT][4];
    rows_by_rows<HD>(p, ks, warp * 16, qt, lane);  // S^T = K Q^T
    const unsigned live = probabilities<kCap>(
        p, th, cuts(q0, k0, Sq, Sk, causal, window), scale, cap, inv_cap,
        [&](int e) { return key0 + (e / 2) * 8; },
        [&](int nt, int e) { return q0 + qcol(nt, e); },
        [&](int nt, int e) { return lse_log2e(ls[qcol(nt, e)]); },
        [&](int key, int r) {
          return allowed(r, key, Sq, Sk, causal, window);
        });
    add_split_by<HD>(dva, p, dot, lane);  // dV += P^T dO

    float ds[kNT][4];
    rows_by_rows<HD>(ds, vs, warp * 16, dot, lane);  // dP^T = V dO^T
    score_grads<kCap>(ds, p, th, live,
                      [&](int nt, int e) { return dls[qcol(nt, e)]; });
    add_split_by<HD>(dka, ds, qt, lane);  // dK += dS^T Q
  }

  // With no pair the K and V copies were never waited for.
  if (total == 0) {
    cp_async_wait<0>();
    __syncthreads();
  }
  // this warp's rows of the K and V tiles are read by this warp only
  store_rows<HD>(ks, warp * 16, dka, scale, dk + koff, kv_stride, k0, Sk,
                 lane);
  store_rows<HD>(vs, warp * 16, dva, 1.f, dv + koff, kv_stride, k0, Sk,
                 lane);
}

template <int HD, bool kCap>
int launch_tc_plan(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, int B, int Sq, int Sk, int H,
                   int KV, int causal, int window, float scale, float cap,
                   cudaStream_t st) {
  const bf16 *qb = static_cast<const bf16*>(q),
             *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v),
             *dob = static_cast<const bf16*>(dout);
  const size_t tiles = sizeof(bf16) * (2 + 2 * kStages) * Tile<HD>::kElems;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<HD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tc<HD, kCap><<<dim3(H, (Sq + kBQ - 1) / kBQ, B), kTcThreads,
                              tiles, st>>>(
      qb, kb, vb, static_cast<const bf16*>(o), lse, dob,
      static_cast<bf16*>(dq), delta, Sq, Sk, H, KV, causal, window, scale,
      cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tiles + sizeof(float) * 2 * kStages * kBQ;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<HD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_tc<HD, kCap><<<dim3(KV, (Sk + kBK - 1) / kBK, B),
                                kTcThreads, smem, st>>>(
      qb, kb, vb, lse, delta, dob, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, KV, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
              int causal, int window, float scale, float cap,
              cudaStream_t st) {
  return cap > 0.f
             ? launch_tc_plan<HD, true>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, Sq, Sk, H, KV, causal,
                                        window, scale, cap, st)
             : launch_tc_plan<HD, false>(q, k, v, o, lse, dout, dq, dk, dv,
                                         delta, B, Sq, Sk, H, KV, causal,
                                         window, scale, cap, st);
}

// ---- bf16 at hd = 64 and 128: wgmma on TMA tiles (wgmma_bf16.cuh) ----

constexpr int kWgRows = 64;    // rows of a consumer warpgroup's share
constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kBlockRows = kConsumers * kWgRows;  // keys (dk/dv), queries (dq)
constexpr int kWgThreads = 128 * (1 + kConsumers);  // + the producer's group
constexpr int kRing = 2;  // stages of the producer's ring
// setmaxnreg: the producer's group gives up what the consumers take
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kWgRows == kBQ && kWgRows == kBK, "cuts and allowed");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "one block an SM");

// A warpgroup's 64 x 64 accumulators as the mma.sync plan's kNT n8 tiles
// (wgmma's m64nN layout is four warps of mma.sync's m16n8 one side by side)
__device__ __forceinline__ float (&as_tiles(float (&c)[32]))[kNT][4] {
  return *reinterpret_cast<float(*)[kNT][4]>(&c);
}

// A warpgroup's 64 x 64 f32 accumulators as the A fragments of the four
// k16 steps of a product over their 64 columns, hi + lo bf16 terms
__device__ __forceinline__ void split_steps(const float (&c)[32],
                                            unsigned (&hi)[4][4],
                                            unsigned (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(c[8 * kk + 2 * r], c[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// d (64 x HD) += (hi + lo) . b: the two bf16 terms of an f32 operand, one
// product each
template <int HD>
__device__ __forceinline__ void mma_rs_split(float (&d)[HD / 2],
                                             const unsigned (&hi)[4],
                                             const unsigned (&lo)[4],
                                             uint64_t db) {
  wg::mma_rs<HD>(d, hi, db);
  wg::mma_rs<HD>(d, lo, db);
}

// A warpgroup's 64 x HD accumulators times `mul` to bf16, rows below S of
// dst (row stride `stride`) from r0; this thread's rows r0 + 16 warp + gq
// and + 8, columns 8 j + 2 tq and + 1
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2],
                                          float mul, bf16* dst, long stride,
                                          int r0, int S, int t) {
  const int warp = t / 32, gq = (t % 32) / 4, tq = t % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = r0 + 16 * warp + gq + 8 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + s * stride + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                acc[4 * j + 2 * i + 1] * mul);
  }
}

// the first 1024-byte boundary of shared memory at or after p (a swizzle
// atom's 8 rows of 128 bytes start on one)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - wg::smem_u32(p) % 1024) % 1024);
}

template <int HD>
constexpr size_t smem_dq_wg() {  // Q and dO of the block; the K/V ring
  return 1024 + 2 * wg::Tile<HD, kBlockRows>::kBytes +
         2 * kRing * wg::Tile<HD, kWgRows>::kBytes;
}

// The dq pass: one block per (128-row q tile, head, batch row). The
// producer warp loads the block's Q and dO once, then runs the ring of
// (K, V) tiles over the live key tiles; consumer warpgroup w owns the rows
// q0 + 64 w .. + 63: S = Q K^T and dP = dO V^T (SS; P formed while dP is
// in flight), then dQ += dS K (RS, dS as hi + lo, K MN-major). Both groups
// work every tile of the block's walk; one whose pairs are all refused
// adds zeros. delta is computed in the consumers' prologue and written.
template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ dq,
                float* __restrict__ delta, int Sq, int Sk, int H, int KV,
                int causal, int window, float scale, float cap) {
  using QT = wg::Tile<HD, kBlockRows>;
  using KT = wg::Tile<HD, kWgRows>;
  extern __shared__ unsigned char smem_wg[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_wg));
  bf16* dos = qs + QT::kElems;
  bf16* ks = dos + QT::kElems;         // kRing tiles
  bf16* vs = ks + kRing * KT::kElems;  // kRing tiles
  __shared__ uint64_t q_bar, full[kRing], empty[kRing];

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest first
  const int b = blockIdx.z, kvh = h / (H / KV);
  // the block's live kv tiles [lo, hi], B4's range over its 128 rows
  const int last_row = min(q0 + kBlockRows - 1, Sq - 1);
  const int hi = (causal ? min(last_row, Sk - 1) : Sk - 1) / kBK;
  const int lo =
      window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / kBK : 0;

  if (threadIdx.x == 0) {
    wg::bar_init(&q_bar, 1);
    for (int s = 0; s < kRing; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], 4 * kConsumers);  // each consumer warp
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer's group: one thread loads
    wg::regs_down<kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::bar_arrive_tx(&q_bar, 2 * QT::kBytes);
      wg::tma_rows<HD, kBlockRows>(qs, &tm_q, &q_bar, h, q0, b);
      wg::tma_rows<HD, kBlockRows>(dos, &tm_do, &q_bar, h, q0, b);
      for (int j = lo; j <= hi; ++j) {
        const int it = j - lo, st = it % kRing;
        wg::bar_wait(&empty[st], ((it / kRing) & 1) ^ 1);
        wg::bar_arrive_tx(&full[st], 2 * KT::kBytes);
        wg::tma_rows<HD, kWgRows>(ks + st * KT::kElems, &tm_k, &full[st], kvh,
                                  j * kBK, b);
        wg::tma_rows<HD, kWgRows>(vs + st * KT::kElems, &tm_v, &full[st], kvh,
                                  j * kBK, b);
      }
    }
  } else {  // consumer warpgroup w: rows qw .. qw + 63
    wg::regs_up<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
    const int qw = q0 + w * kWgRows;
    const float inv_cap = kCap ? 1.f / cap : 0.f;
    const long q_stride = (long)H * HD;
    const long qoff = (long)b * Sq * q_stride + (long)h * HD;
    const long roff = ((long)b * H + h) * Sq;
    const bf16* qw_s = qs + w * kWgRows * wg::kBox;
    const bf16* dow_s = dos + w * kWgRows * wg::kBox;

    // this thread's rows row0 (elements 0, 1 of an n8 tile) and row0 + 8
    // (2, 3); delta over the quad's columns, summed over the quad
    const int row0 = qw + warp * 16 + gq;
    float lse_r[2], dl_r[2];  // lse log2 e, delta
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = row0 + 8 * i;
      float d = 0.f;
      if (s < Sq) {
        const bf16* orow = o + qoff + s * q_stride;
        const bf16* drow = dout + qoff + s * q_stride;
#pragma unroll
        for (int c = 2 * tq; c < HD; c += 8) {
          const float2 of = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(orow + c));
          const float2 df = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow + c));
          d = fmaf(of.x, df.x, d);
          d = fmaf(of.y, df.y, d);
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      dl_r[i] = d;
      lse_r[i] = s < Sq ? lse_log2e(lse[roff + s]) : 0.f;
      if (tq == 0 && s < Sq) delta[roff + s] = d;
    }

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float th[kCap ? kNT : 1][4];
    float sc[32], dp[32];
    unsigned dhi[4][4], dlo[4][4];
    wg::bar_wait(&q_bar, 0);

    for (int j = lo; j <= hi; ++j) {
      const int it = j - lo, st = it % kRing, k0 = j * kBK;
      const bf16* kt = ks + st * KT::kElems;
      const bf16* vt = vs + st * KT::kElems;
      wg::bar_wait(&full[st], (it / kRing) & 1);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // S = Q K^T
        wg::mma_ss_n64(sc, wg::k_major<HD, kBlockRows>(qw_s, 0, kk),
                       wg::k_major<HD, kWgRows>(kt, 0, kk), kk > 0);
      wg::mma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // dP = dO V^T
        wg::mma_ss_n64(dp, wg::k_major<HD, kBlockRows>(dow_s, 0, kk),
                       wg::k_major<HD, kWgRows>(vt, 0, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<1>();  // S; P formed while dP is in flight
      wg::hold(sc);
      const unsigned live = probabilities<kCap>(
          as_tiles(sc), th, cuts(qw, k0, Sq, Sk, causal, window), scale, cap,
          inv_cap, [&](int e) { return row0 + (e / 2) * 8; },
          [&](int nt, int e) { return k0 + nt * 8 + 2 * tq + (e & 1); },
          [&](int, int e) { return lse_r[e / 2]; },
          [&](int r, int c) { return allowed(r, c, Sq, Sk, causal, window); });
      wg::mma_wait<0>();
      wg::hold(dp);
      score_grads<kCap>(as_tiles(dp), as_tiles(sc), th, live,
                        [&](int, int e) { return dl_r[e / 2]; });
      split_steps(dp, dhi, dlo);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dQ += dS K
        mma_rs_split<HD>(acc, dhi[kk], dlo[kk],
                         wg::mn_major<HD, kWgRows>(kt, kk));
      wg::mma_commit();
      wg::mma_wait<0>();  // dQ's products: the stage is free
      wg::hold(acc);
      wg::hold(dhi);
      wg::hold(dlo);
      __syncwarp();
      if (lane == 0) wg::bar_arrive(&empty[st]);
    }
    store_acc<HD>(acc, scale, dq + qoff, q_stride, qw, Sq, t);
  }
}

template <int HD>
constexpr size_t smem_dkdv_wg() {  // K and V of the block; the Q/dO ring
  return 1024 + 2 * wg::Tile<HD, kBlockRows>::kBytes +
         2 * kRing * wg::Tile<HD, kWgRows>::kBytes +
         2 * kRing * kBQ * sizeof(float);
}

// The dk/dv pass: one block per (128-key tile, KV head, batch row). The
// producer warp loads the block's K and V once, then runs the ring of (Q
// tile, dO tile, lse, delta) over the G query heads and their q tiles, as
// `q_tiles` lists them for the 128 keys; consumer warpgroup w owns the keys
// k0 + 64 w .. + 63: S^T = K Q^T and dP^T = V dO^T (SS; P^T formed while
// dP^T is in flight), then dV += P^T dO and dK += dS^T Q (RS, P and dS as
// hi + lo, dO and Q MN-major), both groups every pair of the walk.
template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wg(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, int H, int KV,
                  int causal, int window, float scale, float cap) {
  using KT = wg::Tile<HD, kBlockRows>;
  using QT = wg::Tile<HD, kWgRows>;
  extern __shared__ unsigned char smem_wg[];
  bf16* ks = reinterpret_cast<bf16*>(align1024(smem_wg));
  bf16* vs = ks + KT::kElems;
  bf16* qs = vs + KT::kElems;           // kRing tiles
  bf16* dos = qs + kRing * QT::kElems;  // kRing tiles
  float* lse_s = reinterpret_cast<float*>(dos + kRing * QT::kElems);  // log2 e
  float* dl_s = lse_s + kRing * kBQ;
  __shared__ uint64_t kv_bar, full[kRing], empty[kRing];

  const int kvh = blockIdx.x, k0 = blockIdx.y * kBlockRows, b = blockIdx.z;
  const int G = H / KV;
  const QTiles tiles = q_tiles<kBlockRows>(k0, Sq, Sk, causal, window);
  const int per_head = tiles.n1 + tiles.n2;
  const int total = G * per_head;

  if (threadIdx.x == 0) {
    wg::bar_init(&kv_bar, 1);
    for (int s = 0; s < kRing; ++s) {
      wg::bar_init(&full[s], 32);               // the producer warp's lanes
      wg::bar_init(&empty[s], 4 * kConsumers);  // each consumer warp
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer's group: its first warp loads
    wg::regs_down<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        wg::bar_arrive_tx(&kv_bar, 2 * KT::kBytes);
        wg::tma_rows<HD, kBlockRows>(ks, &tm_k, &kv_bar, kvh, k0, b);
        wg::tma_rows<HD, kBlockRows>(vs, &tm_v, &kv_bar, kvh, k0, b);
      }
      for (int it = 0; it < total; ++it) {
        const int st = it % kRing;
        const int h = kvh * G + it / per_head;
        const int q0 = tiles.at(it % per_head) * kBQ;
        const long roff = ((long)b * H + h) * Sq;
        wg::bar_wait(&empty[st], ((it / kRing) & 1) ^ 1);
        if (lane == 0) {  // the tiles first, then lse and delta beside them
          wg::bar_expect_tx(&full[st], 2 * QT::kBytes);
          wg::tma_rows<HD, kWgRows>(qs + st * QT::kElems, &tm_q, &full[st], h,
                                    q0, b);
          wg::tma_rows<HD, kWgRows>(dos + st * QT::kElems, &tm_do, &full[st],
                                    h, q0, b);
        }
#pragma unroll
        for (int r = lane; r < kBQ; r += 32) {  // 0 past Sq
          const int s = q0 + r;
          lse_s[st * kBQ + r] = s < Sq ? lse_log2e(lse[roff + s]) : 0.f;
          dl_s[st * kBQ + r] = s < Sq ? delta[roff + s] : 0.f;
        }
        wg::bar_arrive(&full[st]);
      }
    }
  } else {  // consumer warpgroup w: keys kw .. kw + 63
    wg::regs_up<kConsumerRegs>();
    const int w = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32, gq = lane / 4, tq = lane % 4;
    const int kw = k0 + w * kWgRows;
    const float inv_cap = kCap ? 1.f / cap : 0.f;
    const long kv_stride = (long)KV * HD;
    const long koff = (long)b * Sk * kv_stride + (long)kvh * HD;
    const bf16* kw_s = ks + w * kWgRows * wg::kBox;
    const bf16* vw_s = vs + w * kWgRows * wg::kBox;
    const int key0 = kw + warp * 16 + gq;  // this thread's keys key0, + 8

    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    float th[kCap ? kNT : 1][4];
    float sc[32], dp[32];
    unsigned phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    wg::bar_wait(&kv_bar, 0);

    for (int it = 0; it < total; ++it) {
      const int st = it % kRing;
      const int q0 = tiles.at(it % per_head) * kBQ;
      const bf16* qt = qs + st * QT::kElems;
      const bf16* dot = dos + st * QT::kElems;
      const float* ls = lse_s + st * kBQ;
      const float* dls = dl_s + st * kBQ;
      auto qcol = [&](int nt, int e) { return nt * 8 + 2 * tq + (e & 1); };
      wg::bar_wait(&full[st], (it / kRing) & 1);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // S^T = K Q^T
        wg::mma_ss_n64(sc, wg::k_major<HD, kBlockRows>(kw_s, 0, kk),
                       wg::k_major<HD, kWgRows>(qt, 0, kk), kk > 0);
      wg::mma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // dP^T = V dO^T
        wg::mma_ss_n64(dp, wg::k_major<HD, kBlockRows>(vw_s, 0, kk),
                       wg::k_major<HD, kWgRows>(dot, 0, kk), kk > 0);
      wg::mma_commit();
      wg::mma_wait<1>();  // S^T; P^T formed while dP^T is in flight
      wg::hold(sc);
      const unsigned live = probabilities<kCap>(
          as_tiles(sc), th, cuts(q0, kw, Sq, Sk, causal, window), scale, cap,
          inv_cap, [&](int e) { return key0 + (e / 2) * 8; },
          [&](int nt, int e) { return q0 + qcol(nt, e); },
          [&](int nt, int e) { return ls[qcol(nt, e)]; },
          [&](int key, int r) {
            return allowed(r, key, Sq, Sk, causal, window);
          });
      wg::mma_wait<0>();
      wg::hold(dp);
      score_grads<kCap>(as_tiles(dp), as_tiles(sc), th, live,
                        [&](int nt, int e) { return dls[qcol(nt, e)]; });
      split_steps(sc, phi, plo);
      split_steps(dp, dhi, dlo);
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO
        mma_rs_split<HD>(dva, phi[kk], plo[kk],
                         wg::mn_major<HD, kWgRows>(dot, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
        mma_rs_split<HD>(dka, dhi[kk], dlo[kk],
                         wg::mn_major<HD, kWgRows>(qt, kk));
      wg::mma_commit();
      wg::mma_wait<0>();  // dV's and dK's products: the stage is free
      wg::hold(dka);
      wg::hold(dva);
      wg::hold(phi);
      wg::hold(plo);
      wg::hold(dhi);
      wg::hold(dlo);
      __syncwarp();
      if (lane == 0) wg::bar_arrive(&empty[st]);
    }
    store_acc<HD>(dka, scale, dk + koff, kv_stride, kw, Sk, t);
    store_acc<HD>(dva, 1.f, dv + koff, kv_stride, kw, Sk, t);
  }
}

template <int HD, bool kCap>
int launch_wg_plan(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Sk, int H, int KV, int causal, int window, float scale,
                   float cap, cudaStream_t st) {
  // The runtime calls first: they make the device's context current on
  // this thread (a thread PyTorch's autograd starts may have none yet),
  // which the driver's tensor-map encoder needs.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wg<HD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq_wg<HD>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wg<HD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv_wg<HD>());
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mdo;
  if ((err = wg::rows_map(&mq, q, B, Sq, H, HD)) != cudaSuccess ||
      (err = wg::rows_map(&mk, k, B, Sk, KV, HD)) != cudaSuccess ||
      (err = wg::rows_map(&mv, v, B, Sk, KV, HD)) != cudaSuccess ||
      (err = wg::rows_map(&mdo, dout, B, Sq, H, HD)) != cudaSuccess)
    return (int)err;
  const int nq = (Sq + kBlockRows - 1) / kBlockRows;
  const int nk = (Sk + kBlockRows - 1) / kBlockRows;
  flash_bwd_dq_wg<HD, kCap><<<dim3(H, nq, B), kWgThreads, smem_dq_wg<HD>(),
                              st>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta, Sq,
      Sk, H, KV, causal, window, scale, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_wg<HD, kCap><<<dim3(KV, nk, B), kWgThreads,
                                smem_dkdv_wg<HD>(), st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, KV, causal, window, scale, cap);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wg(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
              int causal, int window, float scale, float cap,
              cudaStream_t st) {
  return cap > 0.f
             ? launch_wg_plan<HD, true>(q, k, v, o, lse, dout, dq, dk, dv,
                                        delta, B, Sq, Sk, H, KV, causal,
                                        window, scale, cap, st)
             : launch_wg_plan<HD, false>(q, k, v, o, lse, dout, dq, dk, dv,
                                         delta, B, Sq, Sk, H, KV, causal,
                                         window, scale, cap, st);
}

int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* delta, int B, int Sq, int Sk, int H, int KV,
                int hd, int causal, int window, float scale, float cap,
                cudaStream_t st) {
// hd = 64 and 128 (every card path's) take the wgmma plan, the other
// multiples of 16 the mma.sync plan
#define B4B_WG(N)                                                          \
  case N:                                                                  \
    return launch_wg<N>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,   \
                        Sk, H, KV, causal, window, scale, cap, st);
#define B4B_TC(N)                                                          \
  case N:                                                                  \
    return launch_tc<N>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Sq,   \
                        Sk, H, KV, causal, window, scale, cap, st);
  switch (hd) {
    B4B_TC(16) B4B_TC(32) B4B_TC(48) B4B_WG(64)
    B4B_TC(80) B4B_TC(96) B4B_TC(112) B4B_WG(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef B4B_TC
#undef B4B_WG
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Sk, KV, hd); lse and
// delta (scratch, written by the first pass): (B, H, Sq) f32. All
// contiguous; q, k, v, o, dout, dq, dk, dv all f32 or all bf16 (is_bf16).
// bf16: hd <= 128 a multiple of 16, those eight 16-byte aligned. f32: hd <=
// 128. window <= 0 means no window; softcap > 0 caps the scaled scores at
// softcap * tanh(s / softcap), 0 means no cap. Two launches on `stream`:
// the dq pass, then the dk/dv pass. Returns the first CUDA error (0 when
// both were accepted).
int corais_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* lse,
                               const void* dout, void* dq, void* dk,
                               void* dv, void* delta, int B, int Sq, int Sk,
                               int H, int KV, int hd, int causal, int window,
                               float scale, float softcap, int is_bf16,
                               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || hd < 1 ||
      hd > kMaxHd || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16) {
    const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorInvalidValue;
    if (hd % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch_bf16(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Sq, Sk, H,
                       KV, hd, causal, window, scale, softcap, st);
  }
  return softcap > 0.f
             ? launch_f32<true>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Sq,
                                Sk, H, KV, hd, causal, window, scale,
                                softcap, st)
             : launch_f32<false>(q, k, v, o, ls, dout, dq, dk, dv, dl, B, Sq,
                                 Sk, H, KV, hd, causal, window, scale,
                                 softcap, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
