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
// over the columns t allowed by the mask (t <= s if causal, t > s - window
// with a window), with masked scores at -1e30, f32 running max and sum,
// f32 accumulators and the output in q's dtype. Layout (B, S, H, hd) for q
// and o, (B, S, KV, hd) for k and v, all contiguous; G = H / KV.
// Unlike the Pallas kernel, which needs S % 128 == 0, it takes any S:
// rows past S are not stored and columns past S are masked.
//
// What bounds it. At the prefill of the LM edge server (qwen3-4b heads:
// H=32, KV=8, hd=128) and a prompt of S=2048, the causal half is about
// 34 GFLOP on about 21 MB of q, k, v and o in bf16: some 1,600 operations
// per byte, so the card's arithmetic bounds it (0.035 ms at the bf16
// tensor-core peak).
//
// What the design does about it, for now: nothing beyond being right and
// simple. One block of 256 threads per (64-row q tile, head, batch row).
// The q tile and each 64-row K and V tile of KV head h / G are widened to
// f32 in shared memory (116 KB at hd=128, opted in as dynamic shared
// memory); each thread owns a 4x4 block of the 64x64 score tile and a
// 4x8 block of the 64x128 output accumulator, all products as f32 FMAs on
// the CUDA cores (no tensor cores). Per row the running max, sum and
// rescale factor live in shared memory; one warp updates eight rows. Tiles
// that are dead under causality or the window are skipped, as the Pallas
// kernel's pl.when(live) does. K and V tiles arrive in 16-byte loads, all
// of a thread's loads for a tile issued before any is widened, so a tile
// costs one memory round trip, not one per element (hence hd a multiple of
// 8 in bf16, 4 in f32, and 16-byte aligned k, v). P is kept in f32 for
// P.V (the reference
// model's pure-jnp path does so; the Pallas kernel casts P to v's dtype).
// The tensor-core form (mma.sync / wgmma on bf16 tiles fed by TMA, with
// warp specialisation) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: a 16 x 16 thread grid
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key columns per tile
constexpr int kMaxHd = 128;
constexpr int kHdPerThread = kMaxHd / 16;  // output columns per thread
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

size_t smem_bytes(int hd) {
  // qs[kBQ][hd+1], ks[kBK][hd+1], vs[kBK][hd], ps[kBQ][kBK+1], m, l, alpha
  return sizeof(float) * (size_t)(kBQ * (hd + 1) + kBK * (hd + 1) + kBK * hd +
                                  kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
          int hd, int causal, int window, float scale) {
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
  const T* qb = q + (long)b * S * q_stride + (long)h * hd;
  const T* kb = k + (long)b * S * kv_stride + (long)kvh * hd;
  const T* vb = v + (long)b * S * kv_stride + (long)kvh * hd;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, s = q0 + r;
    qs[r * hdp + d] = s < S ? to_f32(qb[s * q_stride + d]) : 0.f;
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
  const int last_row = min(q0 + kBQ - 1, S - 1);
  const int hi = causal ? last_row / kBK : (S - 1) / kBK;
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
        if (c < chunks && s < S) {
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
        bool ok = col < S;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] =
            ok ? sc[i][j] * scale : kNegInf;
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

  T* ob = o + (long)b * S * q_stride + (long)h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kHdPerThread; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(ob + s * q_stride + d, acc[i][j] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (B, S, H, hd); k, v: (B, S, KV, hd), 16-byte aligned; contiguous,
// all f32 or all bf16 (is_bf16), hd a multiple of 8 (bf16) or 4 (f32).
// window <= 0 means no window. Returns the first CUDA error
// of the launch (0 when it was accepted).
int corais_flash_attention(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int H, int KV, int hd,
                           int causal, int window, float scale, int is_bf16,
                           void* stream) {
  const int vec = is_bf16 ? 8 : 4;  // elements per 16-byte load
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > kMaxHd ||
      hd % vec != 0 || reinterpret_cast<size_t>(k) % 16 != 0 ||
      reinterpret_cast<size_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal,
                                         window, scale, st)
                 : launch<float>(q, k, v, o, B, S, H, KV, hd, causal, window,
                                 scale, st);
}

const char* corais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
