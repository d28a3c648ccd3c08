// GQA decode attention over a rolling KV cache ("B5") on Hopper (sm_90a).
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C interface at the end of this file
// (wrapper: repro_torch/kernels/decode_attention.py).
//
// What it replaces (JAX reference): the Pallas kernel `_kernel` of
// src/repro/kernels/decode_attention.py:25 (entry decode_attention_fwd,
// :59), which computes ref.decode_attention_ref (src/repro/kernels/ref.py:30):
// one query token per sequence against a (B, W, KV, hd) cache whose slot w
// holds absolute position slot_pos[b, w] (-1 = empty). A slot is valid if
// 0 <= slot_pos <= pos[b] and, with a window, slot_pos > pos[b] - window;
// invalid scores are -1e30, the softmax runs in f32 and the output
// (B, H, hd) is in q's dtype. The G = H / KV query heads of one KV head
// share each read of the cache: the Pallas kernel's point.
//
// What bounds it. Decoding reads every valid K and V row once and does
// 4 * G * hd operations per row of 2 * hd elements: G operations per byte
// in bf16 (4 for qwen3-4b), far below the ~295 at which the H100's tensor
// cores would be the limit. Device memory bounds it: at B=4 lanes,
// W=4096, KV=8, hd=128 in bf16, a full cache is 67 MB, 0.020 ms at
// 3.35 TB/s, and a partly filled one proportionally less.
//
// What the design does about it: split-W flash-decode in one launch, so
// that enough blocks keep enough bytes in flight (one block per (KV head,
// lane) gave 32 blocks for 132 SMs at qwen3's shape). The grid is
// (splits, KV head, lane); each split owns `tps` whole 64-slot tiles (the
// wrapper's split_plan picks them so that the grid has at least 2 x 132
// blocks where W allows, and no split is empty). A split block reads its
// slots' positions first, then walks only the tiles that hold a valid
// slot: each arrives by 16-byte cp.async copies (hd a multiple of 8 in
// bf16, 4 in f32; 16-byte aligned caches) into a 2-stage ring in the
// cache's dtype, the next valid tile in flight while the current one
// computes; rows of invalid slots are zero-filled, not read. One thread
// per (head, slot) score reads its K row in 16-byte chunks (rows padded by
// 16 bytes: no bank conflicts); one warp per head runs the online softmax;
// P.V spreads over all threads as (head, 16-byte column chunk) units times
// row groups, whose partial sums are added in order once per split. The
// CUDA cores suffice at G operations per byte. Invalid slots inside a
// split are skipped (their weight exp(-1e30 - m) is 0). The split's
// partial softmax (m, l, acc[G, hd]) goes to an f32 scratch; the last
// split block to finish for a (lane, KV head) -- __threadfence, then an
// atomicAdd on the pair's int counter -- combines the pair's splits in
// split order (no float atomics: two calls give the same bits), writes
// the output and resets the counter to 0. A split with no valid slot
// writes l = 0; when every split of a lane is empty the combining block
// returns the reference's answer, the mean of all W V rows (every score
// -1e30: a uniform softmax).
//
// Optionally the combining block also writes each (lane, head)'s
// log-sum-exp of the masked scores, lse = m + log(l) in f32, (B, H): the
// flash-decode over a sequence-sharded cache combines the ranks' outputs
// with it (repro_torch/models/attention.py::sharded_decode_attention). A
// lane with no valid slot writes -1e30 + log(W), the log-sum-exp of W
// scores of -1e30 (which rounds to -1e30 in f32), never -inf or NaN, so
// that such a block weighs exactly 0 beside a block with a valid slot and
// the blocks of an all-empty lane weigh alike. A null lse writes nothing;
// the output is the same either way.
//
// Logit soft-capping (the reference's `logit_softcap`,
// models/attention.py:32-35, :331): with a cap above 0 each valid slot's
// scaled score s becomes cap * tanh(s / cap) (CUDA's accurate tanhf, 2 ulp;
// the kernel is bound by its cache reads, not by the scores) before its
// split's max, so every split's partial softmax, the combine and the lse
// are those of the capped scores. The cap is a template flag: the uncapped
// kernel is compiled as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBW = 64;  // cache slots per tile
constexpr int kMaxHd = 128;
constexpr int kMaxGHd = 2048;  // G * hd
constexpr int kMaxTilesPerSplit = 64;  // decode_attention.py MAX_TILES_PER_SPLIT
constexpr int kStages = 2;             // tiles in flight: the current and the next
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte chunks: 8 bf16 or 4 f32 elements, moved with one instruction
template <typename T>
constexpr int kVec = 16 / sizeof(T);
template <typename T>  // (head, chunk) units per thread at G * hd = 2048
constexpr int kUnits = kMaxGHd / kVec<T> / kThreads;
__device__ __forceinline__ void widen(uint4 u, float* dst, const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  dst[0] = f.x;
  dst[1] = f.y;
  dst[2] = f.z;
  dst[3] = f.w;
}
__device__ __forceinline__ void widen(uint4 u, float* dst,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bytes: the ring of K and V tiles (rows of hd + one chunk), then f32
// qs[G][hd], ps[G][kBW], m, l, alpha [G]; ints any[tps]; bytes
// valid[tps * kBW]. After the last tile the ring holds the row groups'
// partial sums (at most kThreads * kVec floats).
size_t smem_bytes(int G, int hd, int tps, int elem) {
  const int vec = 16 / elem;
  return (size_t)2 * kStages * kBW * (hd + vec) * elem +
         sizeof(float) * (size_t)(G * hd + G * kBW + 3 * G) +
         sizeof(int) * (size_t)tps + (size_t)tps * kBW;
}

template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ kc,
             const T* __restrict__ vc, const int* __restrict__ slot_pos,
             const int* __restrict__ pos, T* __restrict__ o,
             float* __restrict__ lse, float* __restrict__ part,
             int* __restrict__ counters, int W,
             int H, int KV, int hd, int window, float scale, float cap,
             int tps) {
  constexpr int V = kVec<T>;
  extern __shared__ float4 smem4[];
  __shared__ int last;  // this block combines its pair's splits
  const int G = H / KV, ghd = G * hd;
  const int rs = hd + V;     // ring row stride: 16 bytes of padding
  const int tile = kBW * rs;  // elements of one K or V tile
  T* ring = reinterpret_cast<T*>(smem4);  // stage s: K at 2s, V at 2s + 1
  float* qs = reinterpret_cast<float*>(ring + 2 * kStages * tile);
  float* ps = qs + ghd;
  float* m_s = ps + G * kBW;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  int* any = reinterpret_cast<int*>(a_s + G);
  unsigned char* valid = reinterpret_cast<unsigned char*>(any + tps);
  float* red = reinterpret_cast<float*>(smem4);  // after the last tile

  const int split = blockIdx.x, splits = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos[b];
  const int w0 = split * tps * kBW;
  const int n_slots = min(tps * kBW, W - w0);  // >= 1: no split is empty
  const int n_tiles = (n_slots + kBW - 1) / kBW;

  const T* qb = q + ((long)b * H + (long)kvh * G) * hd;  // G x hd, contiguous
  for (int i = tid; i < ghd; i += kThreads) qs[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int t = tid; t < n_tiles; t += kThreads) any[t] = 0;
  __syncthreads();
  // the split's slot positions first: which rows, and which tiles, to read
  const int* spb = slot_pos + (long)b * W + w0;
#pragma unroll 4
  for (int i = tid; i < n_tiles * kBW; i += kThreads) {
    bool ok = false;
    if (i < n_slots) {
      const int sp = spb[i];
      ok = sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
    }
    valid[i] = ok;
    if (ok) any[i / kBW] = 1;
  }
  __syncthreads();

  // P.V work: U (head, chunk) units; with fewer units than threads, R row
  // groups each take rows rg, rg + R, ... and are summed once per split
  const int U = ghd / V;
  const int R = U >= kThreads ? 1 : kThreads / U;
  const int rg = U >= kThreads ? 0 : tid / U;
  const int u0 = U >= kThreads ? tid : tid % U;
  float acc[kUnits<T>][V];
#pragma unroll
  for (int k = 0; k < kUnits<T>; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[k][e] = 0.f;

  const long row = (long)KV * hd;  // between consecutive slots
  const T* kb = kc + ((long)b * W + w0) * row + (long)kvh * hd;
  const T* vb = vc + ((long)b * W + w0) * row + (long)kvh * hd;
  const int cpr = hd / V;  // chunks per row

  // tile t's K and V rows into `stage`, invalid rows zero-filled
  auto issue = [&](int t, int stage) {
    T* kt = ring + 2 * stage * tile;
    T* vt = kt + tile;
    const unsigned char* vf = valid + t * kBW;
    for (int c = tid; c < kBW * cpr; c += kThreads) {
      const int r = c / cpr, ch = c % cpr;
      const bool ok = vf[r];
      const long off = (long)(t * kBW + (ok ? r : 0)) * row + ch * V;
      cp_async16(kt + r * rs + ch * V, kb + off, ok);
      cp_async16(vt + r * rs + ch * V, vb + off, ok);
    }
    cp_async_commit();
  };
  auto next_live = [&](int t) {  // block-uniform: `any` is in shared memory
    for (++t; t < n_tiles && !any[t]; ++t) {
    }
    return t;
  };

  int t = next_live(-1);
  if (t < n_tiles) issue(t, 0);
  for (int stage = 0; t < n_tiles; stage ^= 1) {
    cp_async_wait_all();  // tile t
    __syncthreads();      // tile t visible; every thread past the last tile
    const int nt = next_live(t);
    if (nt < n_tiles) issue(nt, stage ^ 1);
    const T* kt = ring + 2 * stage * tile;
    const T* vt = kt + tile;
    const unsigned char* vf = valid + t * kBW;

    for (int i = tid; i < G * kBW; i += kThreads) {
      const int g = i / kBW, r = i % kBW;
      float s = -INFINITY;  // an invalid slot: weight 0
      if (vf[r]) {
        const float* qg = qs + g * hd;
        const T* kr = kt + r * rs;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < hd; c += V) {
          float kf[V];
          widen(*reinterpret_cast<const uint4*>(kr + c), kf, kr);
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            const float4 a = *reinterpret_cast<const float4*>(qg + c + e);
            d[0] = fmaf(a.x, kf[e], d[0]);
            d[1] = fmaf(a.y, kf[e + 1], d[1]);
            d[2] = fmaf(a.z, kf[e + 2], d[2]);
            d[3] = fmaf(a.w, kf[e + 3], d[3]);
          }
        }
        s = ((d[0] + d[1]) + (d[2] + d[3])) * scale;
        if (kCap) s = cap * tanhf(s / cap);
      }
      ps[g * kBW + r] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {  // the tile holds a valid slot
      float* prow = ps + g * kBW;
      const float s0 = prow[lane], s1 = prow[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
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
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    if (rg < R) {
#pragma unroll
      for (int k = 0; k < kUnits<T>; ++k) {
        const int u = u0 + k * kThreads;
        if (u < U) {
          const int g = u * V / hd, d = u * V % hd;
          const float* prow = ps + g * kBW;
          const float al = a_s[g];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[k][e] *= al;
          for (int r = rg; r < kBW; r += R) {
            const float pr = prow[r];
            float vv[V];
            widen(*reinterpret_cast<const uint4*>(vt + r * rs + d), vv, vt);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[k][e] = fmaf(pr, vv[e], acc[k][e]);
          }
        }
      }
    }
    t = nt;
  }
  __syncthreads();  // the ring is free: the row groups' sums go there

  if (R > 1) {
    if (rg < R)
#pragma unroll
      for (int e = 0; e < V; ++e) red[(rg * U + u0) * V + e] = acc[0][e];
    __syncthreads();
    if (rg == 0)
      for (int g2 = 1; g2 < R; ++g2)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[0][e] += red[(g2 * U + u0) * V + e];
  }

  // the split's partial softmax: acc (splits of G x hd per pair), then m, l
  const long pair = (long)b * KV + kvh;
  const long n_parts = (long)gridDim.z * KV * splits;
  float* pacc = part + (pair * splits + split) * ghd;
  float* pml = part + n_parts * ghd + (pair * splits + split) * 2 * G;
  if (rg == 0)
#pragma unroll
    for (int k = 0; k < kUnits<T>; ++k) {
      const int u = u0 + k * kThreads;
      if (u < U)
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(pacc + u * V + e) = make_float4(
              acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
    }
  if (tid < G) {
    pml[tid] = m_s[tid];
    pml[G + tid] = l_s[tid];
  }
  __threadfence();  // the partial is visible to the combining block
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + pair, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // combine the pair's splits in split order, one thread per 4 outputs
  const float* acc_all = part + pair * splits * ghd;
  const float* ml_all = part + n_parts * ghd + pair * splits * 2 * G;
  T* ob = o + ((long)b * H + (long)kvh * G) * hd;
  for (int idx = 4 * tid; idx < ghd; idx += 4 * kThreads) {
    const int g = idx / hd, d = idx % hd;
    float mx = kNegInf;
    bool seen = false;
    for (int s = 0; s < splits; ++s)
      if (__ldcg(ml_all + s * 2 * G + G + g) > 0.f) {
        seen = true;
        mx = fmaxf(mx, __ldcg(ml_all + s * 2 * G + g));
      }
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    float l = 0.f;
    if (seen) {
      for (int s = 0; s < splits; ++s) {
        const float ls = __ldcg(ml_all + s * 2 * G + G + g);
        if (ls > 0.f) {
          const float wgt = expf(__ldcg(ml_all + s * 2 * G + g) - mx);
          const float4 x = __ldcg(
              reinterpret_cast<const float4*>(acc_all + (long)s * ghd + idx));
          l = fmaf(wgt, ls, l);
          a[0] = fmaf(wgt, x.x, a[0]);
          a[1] = fmaf(wgt, x.y, a[1]);
          a[2] = fmaf(wgt, x.z, a[2]);
          a[3] = fmaf(wgt, x.w, a[3]);
        }
      }
    } else {  // no valid slot in the lane: the mean of all W V rows
      const T* vcol = vc + (long)b * W * row + (long)kvh * hd + d;
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] += to_f32(vcol[w * row + e]);
      l = (float)W;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) store(ob + idx + e, a[e] / l);
    if (lse != nullptr && d == 0)  // once per head: l is the same for all d
      lse[(long)b * H + (long)kvh * G + g] =
          seen ? mx + logf(l) : kNegInf + logf((float)W);
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next launch
}

template <typename T, bool kCap>
int launch_plan(const void* q, const void* kc, const void* vc,
                const int* slot_pos, const int* pos, void* o, float* lse,
                float* part, int* counters, int B, int W, int H, int KV,
                int hd, int window, float scale, float cap, int splits,
                int tps, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, hd, tps, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(splits, KV, B);
  decode_split<T, kCap><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), slot_pos, pos, static_cast<T*>(o), lse,
      part, counters, W, H, KV, hd, window, scale, cap, tps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* slot_pos,
           const int* pos, void* o, float* lse, float* part, int* counters,
           int B, int W, int H, int KV, int hd, int window, float scale,
           float cap, int splits, int tps, cudaStream_t stream) {
  return cap > 0.f
             ? launch_plan<T, true>(q, kc, vc, slot_pos, pos, o, lse, part,
                                    counters, B, W, H, KV, hd, window, scale,
                                    cap, splits, tps, stream)
             : launch_plan<T, false>(q, kc, vc, slot_pos, pos, o, lse, part,
                                     counters, B, W, H, KV, hd, window,
                                     scale, cap, splits, tps, stream);
}

}  // namespace

extern "C" {

// q, o: (B, H, hd); k_cache, v_cache: (B, W, KV, hd), 16-byte aligned;
// slot_pos: (B, W) int32; pos: (B,) int32; contiguous; q and the caches
// all f32 or all bf16 (is_bf16), hd a multiple of 8 (bf16) or 4 (f32).
// window <= 0 means no window. The split plan: `splits` splits of `tps`
// 64-slot tiles (tps <= 64) covering W, none empty. part: f32 scratch of
// B * KV * splits * (G * hd + 2 * G) elements, 16-byte aligned; counters:
// B * KV int32, all 0 (each launch leaves them 0). lse: (B, H) f32, each
// row's log-sum-exp of its masked scores, or null for none. softcap > 0
// caps the scaled scores at softcap * tanh(s / softcap); 0 means no cap.
// Returns the first CUDA error of the launch (0 when it was accepted).
int corais_decode_attention(const void* q, const void* k_cache,
                            const void* v_cache, const void* slot_pos,
                            const void* pos, void* o, void* part,
                            void* counters, void* lse, int B, int W, int H,
                            int KV,
                            int hd, int window, float scale, float softcap,
                            int splits, int tps, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;  // elements per 16-byte load
  if (B < 1 || W < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > kMaxHd ||
      hd % vec != 0 || H / KV * hd > kMaxGHd || !(softcap >= 0.f) ||
      splits < 1 || tps < 1 ||
      tps > kMaxTilesPerSplit || (long)(splits - 1) * tps * kBW >= W ||
      (long)splits * tps * kBW < W ||
      reinterpret_cast<size_t>(k_cache) % 16 != 0 ||
      reinterpret_cast<size_t>(v_cache) % 16 != 0 ||
      reinterpret_cast<size_t>(part) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slot_pos);
  const int* ps = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  int* cn = static_cast<int*>(counters);
  float* ls = static_cast<float*>(lse);
  return is_bf16
             ? launch<__nv_bfloat16>(q, k_cache, v_cache, sp, ps, o, ls, pt,
                                     cn, B, W, H, KV, hd, window, scale,
                                     softcap, splits, tps, st)
             : launch<float>(q, k_cache, v_cache, sp, ps, o, ls, pt, cn, B, W,
                             H, KV, hd, window, scale, softcap, splits, tps,
                             st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
