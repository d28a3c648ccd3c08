// CoRaiS policy head (paper eqs 16-17) on Hopper (sm_90a), f32 on the CUDA
// cores. Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file.
//
// What it replaces (JAX reference, src/repro/kernels/policy_score.py):
//   corais_policy_score         <- _fwd_kernel    (:51), the materialized
//                                  (Z, Q) log-prob head ("B1")
//   corais_policy_score_bwd     <- _bwd_kernel    (:65), B1's custom-VJP
//                                  backward ("B2")
//   corais_policy_score_decode  <- _decode_kernel (:180), the fused score +
//                                  greedy/top-k decode ("B3")
// Every product is an f32 FMA loop written here: no library GEMM, no tensor
// cores. Sums run in a fixed order and no float atomics are used, so two
// calls give the same bits.
//
// What bounds them. At the serving shape (B=1, Q=100, Z=1000, d=256) B3
// does 77 MFLOP on 1.7 MB, 1.2 us at the card's f32 peak, and B1 the same
// products plus a 400 KB (Z, Q) store; their three dependent launches take
// longer than that however they are laid out, so each is spread over the
// card and kept short. At the training shape (B=128, Q=5, Z=50, d=256) B1
// and B2 compute with the reference decode's fold (below): B1 0.18 GFLOP
// and B2 0.55, where the unfolded products take 0.94 and 2.8; their
// launches are bound by latency more than by operations. PERF.md section 6
// has their times on the card.
//
// One register-blocked tile routine (Tile) computes every weight product:
// a block owns a BM x BN output tile, each thread TM x TN of it, and walks
// the reduction in BK-deep chunks of A and B staged in shared memory by
// 16-byte cp.async, double-buffered; KSPLIT groups of threads split
// each chunk's k range and add their sums in group order. Operands are
// read in place: A as (m, k) or (k, m) rows, B as (k, n) or (n, k) rows,
// so W and W^T need no copy. Every kernel of a call after the first is a
// programmatic dependent launch (Hopper): it is scheduled while the one
// before runs and waits (griddepcontrol.wait) for its results, which
// hides most of the gap between two short launches.
//
// B3 and B1, three launches on one stream:
//   1. gemm<EdgeTile>:  px = c @ Wpx over all B*Q edge rows;
//   2. gemm<EdgeTileT>: pxy[b] = Wpy @ px[b]^T (d, Q), the reference's fold,
//      so that only the Z x d x Q product touches the request axis;
//   3. a row kernel of plan QP, Q padded to 32, 64 or 128 (rows_u): a block
//      owns 1024/QP request rows of one instance (8 at Q > 64: 125 blocks
//      at Z=1000); its 8 warps split the d axis, each staging its own slice
//      of the h rows and of pxy (256-deep chunks) in four pieces it waits
//      for one at a time, each lane holding 8 rows x 4 edges; the warps'
//      partial sums are added in warp order. Then one warp per row, edge q
//      = lane * QP/32 + i in the lane's register i (row_keys): normalized,
//      the keys are C*tanh(u), masked -1e9, and the row's log-sum-exp is
//      taken; else they are u, masked -inf.
//      B3 (decode_rows<QP>) selects: K=1 is one arg-max (lowest index on
//      ties); K>1 is a bitonic sort of the QP (value desc, index asc) keys
//      in the warp's registers; un-normalized, C*tanh is applied to the
//      winners. Only (Z, K) indices and values are stored, never the
//      (Z, Q) scores.
//      B1 (score_rows<QP>) stores every key minus the log-sum-exp, the
//      (Z, Q) log-probs, through the row's shared-memory slot so that the
//      stores are coalesced.
//   B1 and B3 share every launch up to the selection, so at a shape where
//   both take this plan B1's values equal B3's normalized values bit for
//   bit (the same u, the same sums in the same order; the products and
//   subtractions after u are __fmul_rn and __fsub_rn, never contracted).
// B1 at Q <= kFlatQ (8; the training shape's Q is 5) takes a small-Q plan,
// where QP = 32 would leave 27 of 32 edge slots padding and B3's edge-side
// tiles, batched over 128 instances of 5 edges, run 2,048 blocks for pxy.
// Three launches too: gemm<PxTile> px and gemm<PxyTile> pxy^T = px @
// Wpy^T (B2's first two), then score_flat over kFlatRows of the flattened
// B*Z request rows per block, across instance boundaries (B2's row
// tiling), each row reading its own instance's Q edges; its epilogue is
// row_keys, lane q holding edge q.
// B2, six launches (the first design took seven), folded as B3 is: with
// pxy^T = px @ Wpy^T, u = h pxy^T[b]^T, dh = gu @ pxy^T[b], and with ghx =
// gu^T h per instance, dpx = ghx @ Wpy and dWpy = ghx^T px, so no product
// has a (Z, d) x (d, d) shape:
//   1. gemm<PxTile>: px = c @ Wpx; it also zeroes the counters of 6;
//   2. gemm<PxyTile>: pxy^T = px @ Wpy^T;
//   3. bwd_rows, 16 of the flattened B*Z request rows per block, across
//      instance boundaries: per row and its instance's Q edges only, u, gu
//      = keep ? (g - exp(out) sum_q g) C scale (1 - tanh(u scale)^2) : 0
//      and dh = gu @ pxy^T[b]; gu goes to scratch the wrapper owns;
//   4. bwd_ghx, per instance and 64 columns: ghx = sum_z gu[z] h[z] in z
//      order;
//   5. gemm<PxTile>: dpx = ghx @ Wpy;
//   6. bwd_weights, one launch of three kinds of tiles: 64x64 ones of dWpy
//      = ghx^T px and dWpx = c^T dpx over the B*Q edge rows, each split
//      over rows into partials that the split's last block to finish (an
//      integer counter per tile) adds in order p = 0, 1, ...; and 32x64
//      ones of dc = dpx @ Wpx^T.
// Limits: Q <= 128, d <= 512, any Z.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <utility>

namespace {

constexpr int kThreads = 256;                    // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ------------------------------------------------- staging and the tile --

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: the kernels of a call after its first
// are launched so that they may start while their predecessor on the
// stream runs (launch() below). Each lets its own dependents start at
// once, and waits in griddep_wait() until its predecessor has finished
// and its writes are visible before it touches what that kernel wrote. A
// kernel launched the ordinary way returns from griddep_wait() at once.
__device__ __forceinline__ void griddep_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// wait until at most n (0..3, a constant after unrolling) groups pend
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// dst[o * pitch + i] = src[(o0 + o) * ld + i0 + i] for o < outer, i <
// inner, and 0 where o0 + o >= omax or i0 + i >= imax, as asynchronous
// copies the caller commits and waits for, shared by nthreads threads of
// which this is thread tid. With `vec` the copies are 16 bytes (inner,
// pitch, ld, i0 and imax multiples of 4, src 16-byte aligned), else 4.
__device__ __forceinline__ void stage(float* dst, int pitch, int outer,
                                      int inner,
                                      const float* __restrict__ src, int ld,
                                      int o0, int omax, int i0, int imax,
                                      bool vec, int tid, int nthreads) {
  if (vec) {
    const int groups = inner / 4;
    for (int t = tid; t < outer * groups; t += nthreads) {
      const int o = t / groups, i = 4 * (t - o * groups);
      const bool ok = o0 + o < omax && i0 + i < imax;
      cp_async16(dst + o * pitch + i,
                 ok ? src + (size_t)(o0 + o) * ld + i0 + i : src, ok ? 16 : 0);
    }
  } else {
    for (int t = tid; t < outer * inner; t += nthreads) {
      const int o = t / inner, i = t - o * inner;
      const bool ok = o0 + o < omax && i0 + i < imax;
      cp_async4(dst + o * pitch + i,
                ok ? src + (size_t)(o0 + o) * ld + i0 + i : src, ok ? 4 : 0);
    }
  }
}

// The tile routine: acc[i][j] = sum_k A(m0 + row(i), k) B(k, n0 + col(j))
// over k < K for a block of kThreads threads. A(m, k) sits at A[k * lda +
// m] when A_KMAJOR, else at A[m * lda + k]; B(k, n) at B[k * ldb + n] when
// B_KMAJOR, else at B[n * ldb + k]. Both are staged in BK-deep chunks,
// double-buffered, in their own layout (rows padded by 4 floats against
// bank conflicts); out-of-range rows, columns and k read as 0.
// KSPLIT groups of MT x NT threads split every chunk's k range; group g
// sums its quarter (or half) of each chunk in k order, and the groups'
// sums are added in order g = 0, 1, ... into group 0 (the leader), whose
// accumulators hold the result. More groups put more warps on an SM
// without shrinking the register tile.
template <int BM_, int BN_, int BK_, int TM_, int TN_, bool A_KMAJOR,
          bool B_KMAJOR, int KSPLIT = 1>
struct Tile {
  static constexpr int STAGES = 2;
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int MT = BM / TM, NT = BN / TN, kGroup = MT * NT;
  static constexpr int kThreads = kGroup * KSPLIT, KG = BK / KSPLIT;
  // a warp covers LY x LX threads of the MT x NT grid, so that its A reads
  // touch LY rows and its B reads LX columns (each one wavefront)
  static constexpr int LX = NT < 8 ? NT : 8, LY = 32 / LX, WX = NT / LX;
  static constexpr int kPA = (A_KMAJOR ? BM : BK) + 4;
  static constexpr int kPB = (B_KMAJOR ? BN : BK) + 4;
  static constexpr int kA = (A_KMAJOR ? BK : BM) * kPA;  // floats a stage
  static constexpr int kB = (B_KMAJOR ? BK : BN) * kPB;
  static constexpr int kSmemStaged = STAGES * (kA + kB);  // floats
  static constexpr bool kVecA = A_KMAJOR && TM % 4 == 0;
  static constexpr bool kVecB = B_KMAJOR && TN % 4 == 0;
  static_assert(KG % 4 == 0 && BM % TM == 0 && BN % TN == 0 &&
                    NT % LX == 0 && MT % LY == 0 && kGroup % 32 == 0 &&
                    (KSPLIT - 1) * kGroup * TM * TN <= kSmemStaged,
                "tile shape");

  // the thread's group, and its row and column in the MT x NT grid
  __device__ static int group() { return threadIdx.x / kGroup; }
  __device__ static bool leader() { return threadIdx.x < kGroup; }
  __device__ static int ty() {
    const int t = threadIdx.x % kGroup;
    return (t / 32 / WX) * LY + (t & 31) / LX;
  }
  __device__ static int tx() {
    const int t = threadIdx.x % kGroup;
    return (t / 32 % WX) * LX + (t & 31) % LX;
  }
  // the tile row of accumulator row i, and the tile column of column j
  __device__ static int row(int i) {
    return kVecA ? (i / 4) * 4 * MT + ty() * 4 + i % 4 : i * MT + ty();
  }
  __device__ static int col(int j) {
    return kVecB ? (j / 4) * 4 * NT + tx() * 4 + j % 4 : j * NT + tx();
  }

  // acc += the group's share of a chunk; a_s and b_s hold one stage
  __device__ static void chunk(float (&acc)[TM][TN], const float* a_s,
                               const float* b_s) {
    const int ty = Tile::ty(), tx = Tile::tx(), k0 = group() * KG;
#pragma unroll
    for (int kk = k0; kk < k0 + KG; kk += 4) {
      float a[TM][4];
      if constexpr (A_KMAJOR) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* src = a_s + (kk + c) * kPA;
          if constexpr (kVecA) {
#pragma unroll
            for (int g = 0; g < TM / 4; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(
                  src + g * 4 * MT + ty * 4);
              a[4 * g][c] = v.x; a[4 * g + 1][c] = v.y;
              a[4 * g + 2][c] = v.z; a[4 * g + 3][c] = v.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i][c] = src[i * MT + ty];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              a_s + (i * MT + ty) * kPA + kk);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
      }
      // every accumulator adds its four products in k order
      if constexpr (B_KMAJOR) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* src = b_s + (kk + c) * kPB;
          float b[TN];
          if constexpr (kVecB) {
#pragma unroll
            for (int g = 0; g < TN / 4; ++g) {
              const float4 v = *reinterpret_cast<const float4*>(
                  src + g * 4 * NT + tx * 4);
              b[4 * g] = v.x; b[4 * g + 1] = v.y;
              b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = src[j * NT + tx];
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i][c], b[j], acc[i][j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(
              b_s + (j * NT + tx) * kPB + kk);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j] = fmaf(a[i][0], v.x, acc[i][j]);
            acc[i][j] = fmaf(a[i][1], v.y, acc[i][j]);
            acc[i][j] = fmaf(a[i][2], v.z, acc[i][j]);
            acc[i][j] = fmaf(a[i][3], v.w, acc[i][j]);
          }
        }
      }
    }
  }

  __device__ static void stage_chunk(float* buf, const float* A, int lda,
                                     int m0, int M, const float* B, int ldb,
                                     int n0, int N, int k0, int K, bool vec) {
    if constexpr (A_KMAJOR)
      stage(buf, kPA, BK, BM, A, lda, k0, K, m0, M, vec, threadIdx.x,
            kThreads);
    else
      stage(buf, kPA, BM, BK, A, lda, m0, M, k0, K, vec, threadIdx.x,
            kThreads);
    if constexpr (B_KMAJOR)
      stage(buf + kA, kPB, BK, BN, B, ldb, k0, K, n0, N, vec, threadIdx.x,
            kThreads);
    else
      stage(buf + kA, kPB, BN, BK, B, ldb, n0, N, k0, K, vec, threadIdx.x,
            kThreads);
  }

  // acc = the product (in the leader group; smem: kSmemStaged floats).
  // One barrier a chunk: chunk c + STAGES - 1 overwrites the buffer of
  // chunk c - 1, which every thread has finished at that barrier.
  __device__ static void run(float (&acc)[TM][TN], const float* A, int lda,
                             int m0, int M, const float* B, int ldb, int n0,
                             int N, int K, bool vec, float* smem) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const int nk = (K + BK - 1) / BK;
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < nk)
        stage_chunk(smem + c * (kA + kB), A, lda, m0, M, B, ldb, n0, N,
                    c * BK, K, vec);
      cp_async_commit();
    }
    for (int c = 0; c < nk; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nx = c + STAGES - 1;
      if (nx < nk)
        stage_chunk(smem + nx % STAGES * (kA + kB), A, lda, m0, M, B, ldb,
                    n0, N, nx * BK, K, vec);
      cp_async_commit();
      const float* buf = smem + c % STAGES * (kA + kB);
      chunk(acc, buf, buf + kA);
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (KSPLIT > 1) {  // the groups' sums, added in group order
      const int t = threadIdx.x % kGroup;
      if (!leader())
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            smem[(((group() - 1) * TM + i) * TN + j) * kGroup + t] =
                acc[i][j];
      __syncthreads();
      if (leader())
        for (int g = 1; g < KSPLIT; ++g)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] += smem[(((g - 1) * TM + i) * TN + j) * kGroup + t];
      __syncthreads();  // the caller may reuse the buffers
    }
  }
};

// The products, all over the B*Q edge rows or the d rows of a weight:
// B3's two at 100 edges, so small tiles, to put more blocks on the card
using EdgeTile = Tile<16, 16, 128, 2, 1, false, true, 4>;    // c @ Wpx
using EdgeTileT = Tile<16, 16, 128, 2, 1, false, false, 4>;  // Wpy @ px^T
// B2's (640 edges at the training shape): 4x4 or 8x4 outputs a thread, as
// smaller register tiles are bound by their shared-memory loads
using PxTile = Tile<32, 64, 64, 4, 4, false, true, 4>;    // c @ Wpx, ghx @ Wpy
using PxyTile = Tile<32, 64, 64, 4, 4, false, false, 4>;  // px @ Wpy^T
using WTile = Tile<64, 64, 32, 8, 4, true, true, 2>;      // ghx^T px, c^T dpx
using CTile = Tile<32, 64, 32, 4, 4, false, false, 2>;    // dpx @ Wpx^T

// C[z] (M, N), row pitch ldc, = A[z] B[z] with the operands of T, batched
// over blockIdx.z by element strides; block (0, 0, 0) first zeroes
// `zero[0:n_zero]` (B2's counters, consumed by a later launch).
template <class T>
__global__ void __launch_bounds__(T::kThreads)
gemm(const float* __restrict__ A, int lda, size_t a_batch,
     const float* __restrict__ B, int ldb, size_t b_batch,
     float* __restrict__ C, int ldc, size_t c_batch, int M, int N, int K,
     int vec, int* __restrict__ zero, int n_zero) {
  extern __shared__ __align__(16) float smem_f[];
  griddep_start();
  griddep_wait();
  if (zero != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = threadIdx.x; i < n_zero; i += blockDim.x) zero[i] = 0;
  const size_t z = blockIdx.z;
  A += z * a_batch;
  B += z * b_batch;
  C += z * c_batch;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[T::TM][T::TN];
  T::run(acc, A, lda, m0, M, B, ldb, n0, N, K, vec, smem_f);
  if (!T::leader()) return;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int m = m0 + T::row(i), n = n0 + T::col(j);
      if (m < M && n < N) C[(size_t)m * ldc + n] = acc[i][j];
    }
}

// ---------------------------------------------------------------- B3 --

// (value desc, index asc): a strict total order, the reference's
// first-index tie rule
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Bitonic sort of the warp's 32 * KPL keys into (value desc, index asc)
// order; key e = lane * KPL + i sits in the lane's register i.
template <int KPL>
__device__ __forceinline__ void warp_sort(float (&v)[KPL], int (&id)[KPL]) {
  const int lane = threadIdx.x & 31;
  constexpr int kN = 32 * KPL;
#pragma unroll
  for (int size = 2; size <= kN; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride >= KPL) {  // partner in lane ^ (stride / KPL)
        const int ls = stride / KPL;
        const bool lower = (lane & ls) == 0;
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const float ov = __shfl_xor_sync(kFull, v[i], ls);
          const int oi = __shfl_xor_sync(kFull, id[i], ls);
          const bool desc = ((lane * KPL + i) & size) == 0;
          // a descending run keeps the earlier key at its lower position
          if ((lower == desc) != before(v[i], id[i], ov, oi)) {
            v[i] = ov;
            id[i] = oi;
          }
        }
      } else {  // partner in the same lane
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          if (i & stride) continue;
          const int j = i | stride;
          const bool desc = ((lane * KPL + i) & size) == 0;
          if (before(v[j], id[j], v[i], id[i]) == desc) {
            const float tv = v[i];
            v[i] = v[j];
            v[j] = tv;
            const int ti = id[i];
            id[i] = id[j];
            id[j] = ti;
          }
        }
      }
    }
  }
}

constexpr int kRowKC = 256;  // d staged per pass

// The row kernels' plan (B3's decode_rows and B1's score_rows) at QP, the
// edges padded to 32, 64 or 128.
template <int QP>
struct RowPlan {
  static constexpr int LQ = QP / 4;         // lanes along the edges
  static constexpr int LR = 32 / LQ;        // row groups in a warp
  static constexpr int TR = 8;              // rows per thread
  static constexpr int R = LR * TR;         // rows per block (1024 / QP)
  static constexpr int KW = kRowKC / kWarps;  // d per warp per pass
  static constexpr int PH = kRowKC + 4;     // pitch of the h rows
  static constexpr int KPL = QP / 32;       // keys per lane in a row's warp
  static constexpr int kSmem = R * PH + kRowKC * QP;  // floats
  static_assert(kWarps * R * QP <= kRowKC * QP, "partials fit");
};

// u = h[b, z0 + r] . pxy[b][:, q] for the block's R request rows of
// instance b, unscaled, left in shared memory at the returned pointer as
// u[r * QP + q] (padding edges and rows past Z read 0; smem: kSmem floats).
// Each warp stages and reads only its own slice of every 256-deep chunk of
// d (its h columns and pxy rows), in kParts pieces that it waits for one
// at a time, so it computes on the first while the others arrive; the
// warps' partial sums are then added in warp order.
template <int QP>
__device__ __forceinline__ float* rows_u(const float* __restrict__ h,
                                         const float* __restrict__ pxy,
                                         int b, int z0, int Z, int Q, int d,
                                         int vec_h, int vec_p, float* smem_f) {
  using P = RowPlan<QP>;
  float* h_s = smem_f;                 // R x PH
  float* p_s = smem_f + P::R * P::PH;  // kRowKC x QP; then the partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / P::LQ, e0 = (lane % P::LQ) * 4;
  const float* h_b = h + (size_t)b * Z * d;
  const float* p_b = pxy + (size_t)b * d * Q;
  float acc[P::TR][4];
#pragma unroll
  for (int r = 0; r < P::TR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  constexpr int kSub = 8, kParts = P::KW / kSub;
  static_assert(kParts <= 4, "cp_async_wait_upto");
  for (int k0 = 0; k0 < d; k0 += kRowKC) {
    const int kw = warp * P::KW;
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int kl = kw + part * kSub;
      stage(h_s + kl, P::PH, P::R, kSub, h_b, d, z0, Z, k0 + kl, d, vec_h,
            lane, 32);
      stage(p_s + kl * QP, QP, kSub, QP, p_b, Q, k0 + kl, d, 0, Q, vec_p,
            lane, 32);
      cp_async_commit();
    }
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      cp_async_wait_upto(kParts - 1 - part);
      __syncwarp();
      const int kb = kw + part * kSub;
#pragma unroll
      for (int kk = 0; kk < kSub; kk += 4) {
        float4 hv[P::TR];
#pragma unroll
        for (int r = 0; r < P::TR; ++r)
          hv[r] = *reinterpret_cast<const float4*>(
              h_s + (r * P::LR + rg) * P::PH + kb + kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 pv = *reinterpret_cast<const float4*>(
              p_s + (kb + kk + c) * QP + e0);
#pragma unroll
          for (int r = 0; r < P::TR; ++r) {
            const float a = c == 0 ? hv[r].x
                          : c == 1 ? hv[r].y
                          : c == 2 ? hv[r].z : hv[r].w;
            acc[r][0] = fmaf(a, pv.x, acc[r][0]);
            acc[r][1] = fmaf(a, pv.y, acc[r][1]);
            acc[r][2] = fmaf(a, pv.z, acc[r][2]);
            acc[r][3] = fmaf(a, pv.w, acc[r][3]);
          }
        }
      }
    }
    __syncwarp();  // the slice is read before the next chunk overwrites it
  }
  __syncthreads();  // the partials below overwrite other warps' slices
  float* red = p_s;  // kWarps x R x QP
#pragma unroll
  for (int r = 0; r < P::TR; ++r)
    *reinterpret_cast<float4*>(red + (warp * P::R + r * P::LR + rg) * QP + e0) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int o = threadIdx.x; o < P::R * QP; o += kThreads) {
    float s = red[o];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * P::R * QP + o];
    red[o] = s;
  }
  __syncthreads();
  return red;
}

// One row's keys, for the warp that owns it: v[i] of edge q = lane * KPL +
// i, padding edges -inf. normalize: C tanh(u scale), masked -1e9, and the
// row's log-sum-exp is returned; else u scale, masked -inf, and 0.
template <int KPL>
__device__ __forceinline__ float row_keys(const float* u_row,
                                          const float* __restrict__ mask_b,
                                          int Q, bool normalize, float scale,
                                          float clip, float (&v)[KPL]) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int q = lane * KPL + i;
    v[i] = -INFINITY;  // padding edges sort after every real one
    if (q < Q) {
      const float u = __fmul_rn(u_row[q], scale);
      const bool keep = mask_b[q] > 0.5f;
      v[i] = normalize ? (keep ? __fmul_rn(clip, tanhf(u)) : -1e9f)
                       : (keep ? u : -INFINITY);
      mx = fmaxf(mx, v[i]);
    }
  }
  if (!normalize) return 0.f;
  mx = warp_max(mx);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i)
    if (lane * KPL + i < Q) s = __fadd_rn(s, expf(__fsub_rn(v[i], mx)));
  return __fadd_rn(logf(warp_sum(s)), mx);
}

// B3 main kernel: R request rows of instance blockIdx.y per block.
template <int QP>
__global__ void __launch_bounds__(kThreads)
decode_rows(const float* __restrict__ h, const float* __restrict__ pxy,
            const float* __restrict__ mask, int* __restrict__ top_idx,
            float* __restrict__ top_val, int Z, int Q, int d, int K,
            int normalize, float scale, float clip, int vec_h, int vec_p) {
  using P = RowPlan<QP>;
  extern __shared__ __align__(16) float smem_f[];
  griddep_start();
  griddep_wait();
  const int b = blockIdx.y, z0 = blockIdx.x * P::R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* u = rows_u<QP>(h, pxy, b, z0, Z, Q, d, vec_h, vec_p, smem_f);
  const float* mask_b = mask + (size_t)b * Q;
  for (int r = warp; r < P::R; r += kWarps) {
    const int z = z0 + r;
    if (z >= Z) break;  // warp-uniform
    float v[P::KPL];
    int id[P::KPL];
    const float lse = row_keys<P::KPL>(u + r * QP, mask_b, Q, normalize,
                                       scale, clip, v);
#pragma unroll
    for (int i = 0; i < P::KPL; ++i) id[i] = lane * P::KPL + i;
    const size_t row = (size_t)b * Z + z;
    if (K == 1) {
      float bv = v[0];
      int bi = id[0];
#pragma unroll
      for (int i = 1; i < P::KPL; ++i)
        if (before(v[i], id[i], bv, bi)) {
          bv = v[i];
          bi = id[i];
        }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        top_idx[row] = bi;
        top_val[row] = normalize ? __fsub_rn(bv, lse) : clip * tanhf(bv);
      }
    } else {
      warp_sort<P::KPL>(v, id);
#pragma unroll
      for (int i = 0; i < P::KPL; ++i) {
        const int e = lane * P::KPL + i;
        if (e < K) {
          top_idx[row * K + e] = id[i];
          top_val[row * K + e] =
              normalize ? __fsub_rn(v[i], lse) : clip * tanhf(v[i]);
        }
      }
    }
  }
}

// B1 main kernel: R request rows of instance blockIdx.y per block; each
// row's Q log-probs go out through its own slot of u.
template <int QP>
__global__ void __launch_bounds__(kThreads)
score_rows(const float* __restrict__ h, const float* __restrict__ pxy,
           const float* __restrict__ mask, float* __restrict__ out, int Z,
           int Q, int d, float scale, float clip, int vec_h, int vec_p) {
  using P = RowPlan<QP>;
  extern __shared__ __align__(16) float smem_f[];
  griddep_start();
  griddep_wait();
  const int b = blockIdx.y, z0 = blockIdx.x * P::R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* u = rows_u<QP>(h, pxy, b, z0, Z, Q, d, vec_h, vec_p, smem_f);
  const float* mask_b = mask + (size_t)b * Q;
  for (int r = warp; r < P::R; r += kWarps) {
    const int z = z0 + r;
    if (z >= Z) break;  // warp-uniform
    float v[P::KPL];
    float* u_row = u + r * QP;  // read and written by this warp only
    const float lse = row_keys<P::KPL>(u_row, mask_b, Q, true, scale, clip,
                                       v);
#pragma unroll
    for (int i = 0; i < P::KPL; ++i) u_row[lane * P::KPL + i] =
        __fsub_rn(v[i], lse);
    __syncwarp();
    float* out_row = out + ((size_t)b * Z + z) * Q;
    for (int q = lane; q < Q; q += 32) out_row[q] = u_row[q];
  }
}

// ------------------------------ flattened request rows (B1 at small Q, B2) --

constexpr int kFlatRows = 16;     // request rows per score_flat block
constexpr int kFlatQ = 8;         // B1 takes the flat plan at Q <= kFlatQ
constexpr int kPxyBudget = 8192;  // floats of pxy^T a flat-row block stages

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// u = h[row] . pxy^T[b, q] for one (row, edge) pair, by the four lanes sub
// = 0..3 of an aligned group, each a quarter of d, summed as (sub 0 + 1) +
// (2 + 3) and returned to all four. hr: the row, staged; pr: the pxy^T
// row, staged (vec4: lane sub reads k = 4 sub + 16 j .. + 3) or in place
// (lane sub reads k = sub + 4 j). Every lane of the warp calls it; lanes
// of a pair that is not real (!act) add 0.
__device__ __forceinline__ float pair_u(const float* hr, const float* pr,
                                        int d, bool vec4, bool act, int sub) {
  float u = 0.f;
  if (act) {
    if (vec4) {
      for (int k = 4 * sub; k < d; k += 16) {
        const float4 a = *reinterpret_cast<const float4*>(hr + k);
        const float4 w = *reinterpret_cast<const float4*>(pr + k);
        u = fmaf(a.x, w.x, u);
        u = fmaf(a.y, w.y, u);
        u = fmaf(a.z, w.z, u);
        u = fmaf(a.w, w.w, u);
      }
    } else {
      for (int k = sub; k < d; k += 4) u = fmaf(hr[k], pr[k], u);
    }
  }
  u += __shfl_xor_sync(kFull, u, 1);
  u += __shfl_xor_sync(kFull, u, 2);
  return u;
}

// B1's small-Q plan, its third launch: kFlatRows of the flattened B*Z
// request rows per block, across instance boundaries. Per row, for its
// instance's Q edges only, u by pair_u (a pass takes kThreads / 4 pairs);
// then one warp per row, lane q holding edge q, takes the row's keys and
// log-sum-exp (row_keys) and stores the Q log-probs. The pxy^T rows of the
// block's instances are staged when they fit kPxyBudget, else read in
// place.
__global__ void __launch_bounds__(kThreads)
score_flat(const float* __restrict__ h, const float* __restrict__ pxyT,
           const float* __restrict__ mask, float* __restrict__ out, int rows,
           int Z, int Q, int d, float scale, float clip, int vec) {
  extern __shared__ __align__(16) float smem_f[];
  const int ph = round_up(d, 4);
  float* h_s = smem_f;                    // kFlatRows x ph
  float* u_s = h_s + kFlatRows * ph;      // kFlatRows x Q
  float* p_s = u_s + kFlatRows * kFlatQ;  // pxy^T rows, pitch ph
  const int r0 = blockIdx.x * kFlatRows, nrow = min(kFlatRows, rows - r0);
  const int b0 = r0 / Z, nb = (r0 + nrow - 1) / Z - b0 + 1;
  const bool fit = nb * Q * ph <= kPxyBudget;
  stage(h_s, ph, kFlatRows, ph, h, d, r0, rows, 0, d, vec, threadIdx.x,
        kThreads);
  griddep_start();
  griddep_wait();  // h is the call's own; pxy^T is not
  if (fit)
    stage(p_s, ph, nb * Q, ph, pxyT + (size_t)b0 * Q * d, d, 0, nb * Q, 0, d,
          vec, threadIdx.x, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int sub = threadIdx.x & 3;
  for (int p0 = 0; p0 < nrow * Q; p0 += kThreads / 4) {
    const int p = p0 + threadIdx.x / 4;
    const bool act = p < nrow * Q;
    const int r = act ? p / Q : 0, q = p - r * Q, b = (r0 + r) / Z;
    const float* pr = fit ? p_s + ((b - b0) * Q + q) * ph
                          : pxyT + ((size_t)b * Q + q) * d;
    const float u = pair_u(h_s + r * ph, pr, d, fit && vec, act, sub);
    if (act && sub == 0) u_s[p] = u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrow; r += kWarps) {
    float v[1];
    const float lse = row_keys<1>(u_s + r * Q, mask + (size_t)(r0 + r) / Z * Q,
                                  Q, true, scale, clip, v);
    if (lane < Q) out[(size_t)(r0 + r) * Q + lane] = __fsub_rn(v[0], lse);
  }
}

// ---------------------------------------------------------------- B2 --

constexpr int kBwdRows = 16;      // request rows per bwd_rows block
constexpr int kGhxCols = 64;      // columns of d per bwd_ghx block
constexpr int kGhxAcc = 8;        // edges per bwd_ghx thread and pass
constexpr int kGuChunk = 4096;    // floats of gu bwd_ghx stages at a time
constexpr int kGhxZ = 64;         // rows of h bwd_ghx stages at a time
constexpr int kWT = WTile::BM;    // weight-gradient and dc tile side

// bwd_rows's shared floats: the h tile, g (then gu), out, the mask rows of
// the block's instances (at most kBwdRows), sum_q g, and pxy^T rows
inline int rows_smem(int d, int Q) {
  return kBwdRows * round_up(d, 4) + 3 * kBwdRows * Q + kBwdRows +
         kPxyBudget;
}

// B2's request rows: kBwdRows of the flattened B*Z rows per block, across
// instance boundaries. Per row, for its instance's Q edges only: u = h .
// pxy^T[b, q] (pair_u), gu = keep ? (g -
// exp(out) sum_q g) C scale (1 - tanh(u scale)^2) : 0, and dh = gu @
// pxy^T[b]. The pxy^T rows of the block's instances are staged when they
// fit kPxyBudget, else read in place.
__global__ void __launch_bounds__(kThreads, 4)
bwd_rows(const float* __restrict__ g, const float* __restrict__ out,
         const float* __restrict__ h, const float* __restrict__ pxyT,
         const float* __restrict__ mask, float* __restrict__ gu,
         float* __restrict__ dh, int rows, int Z, int Q, int d, float scale,
         float clip, int vec) {
  extern __shared__ __align__(16) float smem_f[];
  const int ph = round_up(d, 4);
  float* h_s = smem_f;                  // kBwdRows x ph
  float* g_s = h_s + kBwdRows * ph;     // kBwdRows x Q: g, then gu
  float* o_s = g_s + kBwdRows * Q;      // kBwdRows x Q: out
  float* m_s = o_s + kBwdRows * Q;      // nb x Q: the instances' masks
  float* gsum_s = m_s + kBwdRows * Q;   // kBwdRows
  float* p_s = gsum_s + kBwdRows;       // pxy^T rows, pitch ph
  const int r0 = blockIdx.x * kBwdRows, nrow = min(kBwdRows, rows - r0);
  const int b0 = r0 / Z, nb = (r0 + nrow - 1) / Z - b0 + 1;
  const bool fit = nb * Q * ph <= kPxyBudget;
  stage(h_s, ph, kBwdRows, ph, h, d, r0, rows, 0, d, vec, threadIdx.x,
        kThreads);
  stage(g_s, 0, 1, kBwdRows * Q, g + (size_t)r0 * Q, 0, 0, 1, 0, nrow * Q,
        false, threadIdx.x, kThreads);
  stage(o_s, 0, 1, kBwdRows * Q, out + (size_t)r0 * Q, 0, 0, 1, 0, nrow * Q,
        false, threadIdx.x, kThreads);
  stage(m_s, 0, 1, nb * Q, mask + (size_t)b0 * Q, 0, 0, 1, 0, nb * Q, false,
        threadIdx.x, kThreads);
  griddep_start();
  griddep_wait();  // the inputs above are the call's own; pxy^T is not
  if (fit)
    stage(p_s, ph, nb * Q, ph, pxyT + (size_t)b0 * Q * d, d, 0, nb * Q, 0, d,
          vec, threadIdx.x, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < nrow) {
    float s = 0.f;
    for (int q = 0; q < Q; ++q) s += g_s[threadIdx.x * Q + q];
    gsum_s[threadIdx.x] = s;
  }
  __syncthreads();
  // u and gu; a pass takes kThreads / 4 (row, edge) pairs, warp-uniformly
  const int sub = threadIdx.x & 3;
  for (int p0 = 0; p0 < nrow * Q; p0 += kThreads / 4) {
    const int p = p0 + threadIdx.x / 4;
    const bool act = p < nrow * Q;
    const int r = act ? p / Q : 0, q = p - r * Q, b = (r0 + r) / Z;
    const float* pr = fit ? p_s + ((b - b0) * Q + q) * ph
                          : pxyT + ((size_t)b * Q + q) * d;
    const float u = pair_u(h_s + r * ph, pr, d, fit && vec, act, sub);
    if (act && sub == 0) {
      float v = 0.f;  // masked edges saw a constant: no gradient
      if (m_s[(b - b0) * Q + q] > 0.5f) {
        const float th = tanhf(u * scale);
        const float gi = g_s[p] - expf(o_s[p]) * gsum_s[r];
        v = gi * (clip * scale) * (1.f - th * th);
      }
      g_s[p] = v;  // only this thread reads g_s[p]
      gu[(size_t)r0 * Q + p] = v;
    }
  }
  __syncthreads();
  if (fit && vec) {  // dh = gu @ pxy^T[b], four columns a thread
    const int d4 = d / 4;
    for (int t = threadIdx.x; t < nrow * d4; t += kThreads) {
      const int r = t / d4, k = 4 * (t - r * d4);
      const float* pb = p_s + ((r0 + r) / Z - b0) * Q * ph + k;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < Q; ++q) {
        const float gq = g_s[r * Q + q];
        const float4 w = *reinterpret_cast<const float4*>(pb + q * ph);
        acc.x = fmaf(gq, w.x, acc.x);
        acc.y = fmaf(gq, w.y, acc.y);
        acc.z = fmaf(gq, w.z, acc.z);
        acc.w = fmaf(gq, w.w, acc.w);
      }
      *reinterpret_cast<float4*>(dh + (size_t)(r0 + r) * d + k) = acc;
    }
  } else {
    const float* pt = fit ? p_s : pxyT + (size_t)b0 * Q * d;
    const int pp = fit ? ph : d;
    for (int t = threadIdx.x; t < nrow * d; t += kThreads) {
      const int r = t / d, k = t - r * d;
      const float* pb = pt + (size_t)((r0 + r) / Z - b0) * Q * pp + k;
      float acc = 0.f;
      for (int q = 0; q < Q; ++q)
        acc = fmaf(g_s[r * Q + q], pb[(size_t)q * pp], acc);
      dh[(size_t)(r0 + r) * d + k] = acc;
    }
  }
}

// B2: ghx[b, q] = sum_z gu[b, z, q] h[b, z] in z order, for instance
// blockIdx.x and the kGhxCols columns of blockIdx.y. The block stages its
// slab of h and the instance's gu, kGhxZ rows at a time, in one copy each;
// four groups of threads take edges q = group, group + 4, ... (kGhxAcc a
// pass).
__global__ void __launch_bounds__(kThreads)
bwd_ghx(const float* __restrict__ gu, const float* __restrict__ h,
        float* __restrict__ ghx, int Z, int Q, int d, int vec) {
  __shared__ __align__(16) float h_s[kGhxZ * kGhxCols];
  __shared__ float g_s[kGuChunk];
  griddep_start();
  griddep_wait();
  constexpr int kGroups = kThreads / kGhxCols;
  const int b = blockIdx.x, grp = threadIdx.x / kGhxCols;
  const int col = threadIdx.x % kGhxCols, c0 = blockIdx.y * kGhxCols;
  const int zc = max(1, min(kGhxZ, kGuChunk / Q));
  const float* gub = gu + (size_t)b * Z * Q;
  const float* hb = h + (size_t)b * Z * d;
  for (int qb = 0; qb < Q; qb += kGroups * kGhxAcc) {
    float acc[kGhxAcc];
#pragma unroll
    for (int i = 0; i < kGhxAcc; ++i) acc[i] = 0.f;
    for (int z0 = 0; z0 < Z; z0 += zc) {
      const int zn = min(zc, Z - z0);
      stage(h_s, kGhxCols, zn, kGhxCols, hb, d, z0, Z, c0, d, vec,
            threadIdx.x, kThreads);
      stage(g_s, 0, 1, zn * Q, gub + (size_t)z0 * Q, 0, 0, 1, 0, zn * Q,
            false, threadIdx.x, kThreads);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int z = 0; z < zn; ++z) {
        const float hv = h_s[z * kGhxCols + col];
#pragma unroll
        for (int i = 0; i < kGhxAcc; ++i) {
          const int q = qb + grp + kGroups * i;
          if (q < Q) acc[i] = fmaf(g_s[z * Q + q], hv, acc[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kGhxAcc; ++i) {
      const int q = qb + grp + kGroups * i;
      if (c0 + col < d && q < Q)
        ghx[((size_t)b * Q + q) * d + c0 + col] = acc[i];
    }
  }
}

// B2's last launch, three kinds of tiles by blockIdx.x: kWT x kWT tiles of
// dWpy = ghx^T px partials (tiles x split blocks) and of dWpx = c^T dpx
// partials (tiles x split), then CTile's of dc = dpx @ Wpx^T (half the
// rows, as each sums over all d). Partial p of a weight covers edge rows
// [p * per, (p + 1) * per); the last of a tile's blocks to finish adds the
// partials in order p = 0, 1, ... (counters zeroed by the first launch).
static_assert(WTile::kThreads == CTile::kThreads, "one block size");

__global__ void __launch_bounds__(WTile::kThreads)
bwd_weights(const float* __restrict__ ghx, const float* __restrict__ px,
            const float* __restrict__ c, const float* __restrict__ dpx,
            const float* __restrict__ wpx, float* __restrict__ partial,
            int* __restrict__ counters, float* __restrict__ dwpy,
            float* __restrict__ dwpx, float* __restrict__ dc, int edges,
            int d, int split, int vec) {
  extern __shared__ __align__(16) float smem_f[];
  __shared__ int last;
  griddep_start();
  griddep_wait();
  const int td = (d + kWT - 1) / kWT, tiles = td * td;
  int blk = blockIdx.x;
  if (blk < 2 * tiles * split) {
    const int w = blk / (tiles * split);  // 0: dWpy, 1: dWpx
    blk -= w * tiles * split;
    const float* a = w == 0 ? ghx : c;
    const float* bm = w == 0 ? px : dpx;
    float* dw = w == 0 ? dwpy : dwpx;
    float* part = partial + (size_t)w * split * d * d;
    const int tile = blk % tiles, p = blk / tiles;
    const int m0 = tile / td * kWT, n0 = tile % td * kWT;
    const int per = (edges + split - 1) / split;
    const int k0 = p * per, k1 = min(edges, k0 + per);
    float acc[WTile::TM][WTile::TN];
    WTile::run(acc, a + (size_t)k0 * d, d, m0, d, bm + (size_t)k0 * d, d, n0,
               d, k1 - k0, vec, smem_f);
    float* dst = split == 1 ? dw : part + (size_t)p * d * d;
    if (WTile::leader())
#pragma unroll
      for (int i = 0; i < WTile::TM; ++i)
#pragma unroll
        for (int j = 0; j < WTile::TN; ++j) {
          const int m = m0 + WTile::row(i), n = n0 + WTile::col(j);
          if (m < d && n < d) dst[(size_t)m * d + n] = acc[i][j];
        }
    if (split == 1) return;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(counters + w * tiles + tile, 1) == split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (vec) {  // kPer float4 a thread; a partial's loads in flight together
      constexpr int kPer = kWT * kWT / 4 / WTile::kThreads;
      float4 acc4[kPer];
      int at[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int t = threadIdx.x + u * WTile::kThreads;
        const int m = m0 + t / (kWT / 4), n = n0 + 4 * (t % (kWT / 4));
        at[u] = m < d && n < d ? m * d + n : -1;
        acc4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int q = 0; q < split; ++q) {
        const float* pq = part + (size_t)q * d * d;
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          if (at[u] >= 0) {
            const float4 v =
                __ldcg(reinterpret_cast<const float4*>(pq + at[u]));
            acc4[u].x += v.x;
            acc4[u].y += v.y;
            acc4[u].z += v.z;
            acc4[u].w += v.w;
          }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (at[u] >= 0) *reinterpret_cast<float4*>(dw + at[u]) = acc4[u];
    } else {
      for (int t = threadIdx.x; t < kWT * kWT; t += WTile::kThreads) {
        const int m = m0 + t / kWT, n = n0 + t % kWT;
        if (m < d && n < d) {
          float s = 0.f;
          for (int q = 0; q < split; ++q)
            s += __ldcg(part + ((size_t)q * d + m) * d + n);
          dw[(size_t)m * d + n] = s;
        }
      }
    }
    return;
  }
  blk -= 2 * tiles * split;
  const int tn = (d + CTile::BN - 1) / CTile::BN;
  const int m0 = blk / tn * CTile::BM, n0 = blk % tn * CTile::BN;
  float acc[CTile::TM][CTile::TN];
  CTile::run(acc, dpx, d, m0, edges, wpx, d, n0, d, d, vec, smem_f);
  if (!CTile::leader()) return;
#pragma unroll
  for (int i = 0; i < CTile::TM; ++i)
#pragma unroll
    for (int j = 0; j < CTile::TN; ++j) {
      const int m = m0 + CTile::row(i), n = n0 + CTile::col(j);
      if (m < edges && n < d) dc[(size_t)m * d + n] = acc[i][j];
    }
}

// ------------------------------------------------------------ launches --

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)bytes)
             : cudaSuccess;
}

// kernel<<<grid, block, smem, s>>>(args...), as a programmatic dependent
// of the stream's previous kernel when `dependent`
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block,
                   size_t smem, cudaStream_t s, bool dependent,
                   Args&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

template <class T>
cudaError_t launch_gemm(const float* A, int lda, size_t a_batch,
                        const float* B, int ldb, size_t b_batch, float* C,
                        int ldc, size_t c_batch, int M, int N, int K,
                        int batch, int vec, int* zero, int n_zero,
                        cudaStream_t s, bool dependent) {
  const size_t smem = T::kSmemStaged * sizeof(float);
  cudaError_t err = set_smem((const void*)gemm<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, batch);
  return launch(gemm<T>, grid, T::kThreads, smem, s, dependent, A, lda,
                a_batch, B, ldb, b_batch, C, ldc, c_batch, M, N, K, vec, zero,
                n_zero);
}

// B1's and B3's edge side, launches 1 and 2: px = c @ Wpx over the B*Q
// edge rows, then pxy[b] = Wpy @ px[b]^T, (d, Q) per instance
cudaError_t edge_products(const float* c, const float* wpx, const float* wpy,
                          float* px, float* pxy, int B, int Q, int d,
                          cudaStream_t s) {
  const int vec = d % 4 == 0;
  cudaError_t err = launch_gemm<EdgeTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,
                                          d, d, 1, vec, nullptr, 0, s, false);
  if (err != cudaSuccess) return err;
  return launch_gemm<EdgeTileT>(wpy, d, 0, px, d, (size_t)Q * d, pxy, Q,
                                (size_t)d * Q, d, Q, d, B, vec, nullptr, 0, s,
                                true);
}

// launch 3: row kernel `kernel` (plan QP) over the B instances' Z rows, a
// programmatic dependent of the edge side
template <int QP, typename... Params, typename... Args>
cudaError_t launch_rows(void (*kernel)(Params...), int B, int Z,
                        cudaStream_t s, Args&&... args) {
  using P = RowPlan<QP>;
  const size_t smem = P::kSmem * sizeof(float);
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  return launch(kernel, dim3((Z + P::R - 1) / P::R, B), kThreads, smem, s,
                true, std::forward<Args>(args)...);
}

}  // namespace

extern "C" {

// Every entry point returns the first CUDA error of its launches (0 when
// all were accepted). A refused launch never runs and a later synchronize
// does not report it, so each launch is checked here.

// B1 and B3. Scratch the wrapper owns: px (B, Q, d) and pxy (B, d, Q); B1's
// small-Q plan writes pxy^T (B, Q, d) there.
int corais_policy_score(const float* c, const float* h, const float* wpx,
                        const float* wpy, const float* mask, float* px,
                        float* pxy, float* out, int B, int Q, int Z, int d,
                        float scale, float clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vh = d % 4 == 0, vp = Q % 4 == 0;
  if (Q <= kFlatQ) {  // the small-Q plan: B2's edge side, flat rows
    cudaError_t err = launch_gemm<PxTile>(c, d, 0, wpx, d, 0, px, d, 0, B * Q,
                                          d, d, 1, vh, nullptr, 0, s, false);
    if (err != cudaSuccess) return err;
    err = launch_gemm<PxyTile>(px, d, 0, wpy, d, 0, pxy, d, 0, B * Q, d, d, 1,
                               vh, nullptr, 0, s, true);
    if (err != cudaSuccess) return err;
    const size_t smem = (kFlatRows * round_up(d, 4) + kFlatRows * kFlatQ +
                         kPxyBudget) * sizeof(float);
    err = set_smem((const void*)score_flat, smem);
    if (err != cudaSuccess) return err;
    return launch(score_flat, (B * Z + kFlatRows - 1) / kFlatRows, kThreads,
                  smem, s, true, h, pxy, mask, out, B * Z, Z, Q, d, scale,
                  clip, vh);
  }
  const cudaError_t err = edge_products(c, wpx, wpy, px, pxy, B, Q, d, s);
  if (err != cudaSuccess) return err;
  if (Q <= 32)  // Q > kFlatQ
    return launch_rows<32>(score_rows<32>, B, Z, s, h, pxy, mask, out, Z, Q,
                           d, scale, clip, vh, vp);
  if (Q <= 64)
    return launch_rows<64>(score_rows<64>, B, Z, s, h, pxy, mask, out, Z, Q,
                           d, scale, clip, vh, vp);
  return launch_rows<128>(score_rows<128>, B, Z, s, h, pxy, mask, out, Z, Q,
                          d, scale, clip, vh, vp);
}

int corais_policy_score_decode(const float* c, const float* h,
                               const float* wpx, const float* wpy,
                               const float* mask, float* px, float* pxy,
                               int* top_idx, float* top_val, int B, int Q,
                               int Z, int d, int K, int normalize,
                               float scale, float clip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = edge_products(c, wpx, wpy, px, pxy, B, Q, d, s);
  if (err != cudaSuccess) return err;
  const int vh = d % 4 == 0, vp = Q % 4 == 0;
  if (Q <= 32)
    return launch_rows<32>(decode_rows<32>, B, Z, s, h, pxy, mask, top_idx,
                           top_val, Z, Q, d, K, normalize, scale, clip, vh,
                           vp);
  if (Q <= 64)
    return launch_rows<64>(decode_rows<64>, B, Z, s, h, pxy, mask, top_idx,
                           top_val, Z, Q, d, K, normalize, scale, clip, vh,
                           vp);
  return launch_rows<128>(decode_rows<128>, B, Z, s, h, pxy, mask, top_idx,
                          top_val, Z, Q, d, K, normalize, scale, clip, vh,
                          vp);
}

// B2. Scratch the wrapper owns: px, pxy^T, ghx and dpx (B, Q, d), gu
// (B, Z, Q), partial (2 * split, d, d) and counters (2 * ceil(d / 32)^2
// int32). split: partials of each weight gradient over the B*Q edge rows,
// at most that many rows.
int corais_policy_score_bwd(const float* g, const float* out, const float* c,
                            const float* h, const float* wpx,
                            const float* wpy, const float* mask, float* px,
                            float* pxyT, float* gu, float* ghx, float* dpx,
                            float* partial, int* counters, float* dc,
                            float* dh, float* dwpx, float* dwpy, int B, int Q,
                            int Z, int d, int split, float scale, float clip,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = d % 4 == 0, rows = B * Z, edges = B * Q;
  const int td = (d + kWT - 1) / kWT, tiles = td * td;
  cudaError_t err = launch_gemm<PxTile>(c, d, 0, wpx, d, 0, px, d, 0, edges,
                                        d, d, 1, vec, counters, 2 * tiles, s,
                                        false);
  if (err != cudaSuccess) return err;
  err = launch_gemm<PxyTile>(px, d, 0, wpy, d, 0, pxyT, d, 0, edges, d, d, 1,
                             vec, nullptr, 0, s, true);
  if (err != cudaSuccess) return err;
  size_t smem = rows_smem(d, Q) * sizeof(float);
  err = set_smem((const void*)bwd_rows, smem);
  if (err != cudaSuccess) return err;
  err = launch(bwd_rows, (rows + kBwdRows - 1) / kBwdRows, kThreads, smem, s,
               true, g, out, h, pxyT, mask, gu, dh, rows, Z, Q, d, scale,
               clip, vec);
  if (err != cudaSuccess) return err;
  err = launch(bwd_ghx, dim3(B, (d + kGhxCols - 1) / kGhxCols), kThreads, 0,
               s, true, gu, h, ghx, Z, Q, d, vec);
  if (err != cudaSuccess) return err;
  err = launch_gemm<PxTile>(ghx, d, 0, wpy, d, 0, dpx, d, 0, edges, d, d, 1,
                            vec, nullptr, 0, s, true);
  if (err != cudaSuccess) return err;
  smem = (WTile::kSmemStaged > CTile::kSmemStaged ? WTile::kSmemStaged
                                                  : CTile::kSmemStaged) *
         sizeof(float);
  err = set_smem((const void*)bwd_weights, smem);
  if (err != cudaSuccess) return err;
  const int blocks = 2 * tiles * split + (edges + CTile::BM - 1) /
                     CTile::BM * ((d + CTile::BN - 1) / CTile::BN);
  return launch(bwd_weights, blocks, WTile::kThreads, smem, s, true, ghx, px,
                c, dpx, wpx, partial, counters, dwpy, dwpx, dc, edges, d,
                split, vec);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
