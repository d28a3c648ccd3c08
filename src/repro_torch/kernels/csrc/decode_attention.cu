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
// What the design does about it. It reads only what the inputs need: the
// slot_pos of each 64-slot tile is tested first, K and V rows of invalid
// slots are not loaded, and a tile with no valid slot is skipped once any
// valid slot has been seen (before that, masked slots carry weight
// exp(-1e30 - (-1e30)) = 1 as in the reference, so their V rows are read;
// this only matters for a cache with no valid slot at all). One block of
// 256 threads per (KV head, batch row) walks W in 64-slot tiles: K and V
// arrive in 16-byte loads, all of a thread's loads for a tile issued
// before any is widened (one memory round trip per tile; hd a multiple of
// 8 in bf16, 4 in f32, 16-byte aligned caches), and are widened to f32 in
// shared memory (77 KB at G*hd = 2048, opted in),
// one thread per (head, slot) score, one warp per head for the online
// softmax, and each thread keeps up to 8 of the G x hd accumulators in
// registers. At B=4 and KV=8 that is 32 blocks for 132 SMs, one tile in
// flight per block: the kernel is latency-bound, far from the memory rate.
// Split-W flash-decode (many blocks per (b, KV head), each a partial
// softmax, plus a combine pass) is the later, fast design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBW = 64;  // cache slots per tile
constexpr int kMaxHd = 128;
constexpr int kMaxGHd = 2048;  // G * hd: at most 8 accumulators per thread
constexpr int kAccPerThread = kMaxGHd / kThreads;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16-byte chunks: 8 bf16 or 4 f32 elements, loaded with one instruction
constexpr int kMaxChunks = kBW * kMaxHd / 4 / kThreads;  // per thread, f32
template <typename T>
constexpr int kVec = 16 / sizeof(T);
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

size_t smem_bytes(int G, int hd) {
  // qs[G][hd], ks[kBW][hd+1], vs[kBW][hd], ps[G][kBW], m, l, alpha [G],
  // slot status [kBW] (ints)
  return sizeof(float) * (size_t)(G * hd + kBW * (hd + 1) + kBW * hd +
                                  G * kBW + 3 * G + kBW);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, const T* __restrict__ kc,
           const T* __restrict__ vc, const int* __restrict__ slot_pos,
           const int* __restrict__ pos, T* __restrict__ o, int W, int H,
           int KV, int hd, int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int hdp = hd + 1;
  float* qs = smem;
  float* ks = qs + G * hd;
  float* vs = ks + kBW * hdp;
  float* ps = vs + kBW * hd;
  float* m_s = ps + G * kBW;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  int* status = reinterpret_cast<int*>(a_s + G);  // 0 absent, 1 masked, 2 valid

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = pos[b];

  const T* qb = q + ((long)b * H + (long)kvh * G) * hd;  // G x hd, contiguous
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const long row = (long)KV * hd;  // between consecutive slots
  const T* kb = kc + (long)b * W * row + (long)kvh * hd;
  const T* vb = vc + (long)b * W * row + (long)kvh * hd;
  const int* spb = slot_pos + (long)b * W;
  bool seen = false;  // a valid slot was seen in an earlier tile (block-uniform)

  for (int w0 = 0; w0 < W; w0 += kBW) {
    __syncthreads();  // the previous tile's readers are done
    bool ok = false;
    if (tid < kBW) {
      const int w = w0 + tid;
      int st = 0;
      if (w < W) {
        const int sp = spb[w];
        ok = sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
        st = ok ? 2 : 1;
      }
      status[tid] = st;
    }
    const bool any = __syncthreads_or(ok) != 0;
    if (!any && seen) continue;  // every slot masked: weight exactly 0
    const bool masked_weigh_one = !any;  // no valid slot yet: masked weigh 1
    seen = seen || any;

    // all of the tile's loads in flight at once, then widen into smem
    const int cpr = hd / kVec<T>, chunks = kBW * cpr;
    uint4 kr[kMaxChunks], vr[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int c = tid + j * kThreads;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (c < chunks) {
        const int r = c / cpr, st = status[r];
        const long off = (long)(w0 + r) * row + (c % cpr) * kVec<T>;
        if (st == 2) kr[j] = *reinterpret_cast<const uint4*>(kb + off);
        if (st == 2 || (st == 1 && masked_weigh_one))
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
    __syncthreads();

    for (int i = tid; i < G * kBW; i += kThreads) {
      const int g = i / kBW, r = i % kBW, st = status[r];
      float s = -INFINITY;  // an absent slot past W: weight 0 always
      if (st == 2) {
        const float* qg = qs + g * hd;
        const float* kr = ks + r * hdp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qg[d], kr[d], dot);
        s = dot * scale;
      } else if (st == 1) {
        s = kNegInf;
      }
      ps[g * kBW + r] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
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

#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * hd) {
        const int g = idx / hd, d = idx % hd;
        const float* prow = ps + g * kBW;
        float a = acc[i] * a_s[g];
        for (int r = 0; r < kBW; ++r) a = fmaf(prow[r], vs[r * hd + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  T* ob = o + ((long)b * H + (long)kvh * G) * hd;
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * hd) store(ob + idx, acc[i] / fmaxf(l_s[idx / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* slot_pos,
           const int* pos, void* o, int B, int W, int H, int KV, int hd,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  decode_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), slot_pos, pos, static_cast<T*>(o), W, H, KV,
      hd, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, H, hd); k_cache, v_cache: (B, W, KV, hd), 16-byte aligned;
// slot_pos: (B, W) int32; pos: (B,) int32; contiguous; q and the caches
// all f32 or all bf16 (is_bf16), hd a multiple of 8 (bf16) or 4 (f32).
// window <= 0 means no window. Returns the first CUDA error of
// the launch (0 when it was accepted).
int corais_decode_attention(const void* q, const void* k_cache,
                            const void* v_cache, const void* slot_pos,
                            const void* pos, void* o, int B, int W, int H,
                            int KV, int hd, int window, float scale,
                            int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;  // elements per 16-byte load
  if (B < 1 || W < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > kMaxHd ||
      hd % vec != 0 || H / KV * hd > kMaxGHd ||
      reinterpret_cast<size_t>(k_cache) % 16 != 0 ||
      reinterpret_cast<size_t>(v_cache) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slot_pos);
  const int* ps = static_cast<const int*>(pos);
  return is_bf16
             ? launch<__nv_bfloat16>(q, k_cache, v_cache, sp, ps, o, B, W, H,
                                     KV, hd, window, scale, st)
             : launch<float>(q, k_cache, v_cache, sp, ps, o, B, W, H, KV, hd,
                             window, scale, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
