// The pieces of the bf16 tensor-core plans of B4 (flash_attention.cu) and
// B4b (flash_attention_bwd.cu), included by both sources: 64-row
// shared-memory tiles of swizzled 16-byte chunks filled by cp.async copies,
// ldmatrix (plain and .trans), mma.sync m16n8k16 with f32 accumulation, and
// the hi + lo bf16 split that carries an f32 operand into those products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows of a shared-memory tile

// Shared-memory tile of 64 rows of HD bf16: HD/8 16-byte chunks per row,
// the row padded to a multiple of 8 chunks, chunk c of row r stored at
// c ^ (r % 8), so that ldmatrix reads 8 rows of one chunk from 8 distinct
// bank groups.
template <int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;
  static constexpr int kRowElems = (kChunks + 7) / 8 * 64;
  static constexpr int kElems = kRows * kRowElems;
};

__device__ __forceinline__ int swz(int row, int chunk, int row_elems) {
  return row * row_elems + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) -> bf16x2 of the rounded pair (hi) and of what it left (lo)
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// The A fragments (rows g, g+8; columns 2t, 2t+8 of a k16 step) of the
// hi and lo halves of two m16n8 f32 accumulators side by side (columns
// 0-7 in c0, 8-15 in c1): an f32 product's result fed on as an operand.
__device__ __forceinline__ void split_frags(const float (&c0)[4],
                                            const float (&c1)[4],
                                            unsigned (&hi)[4],
                                            unsigned (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Copy rows r0 .. r0+63 of a (row stride `stride`) matrix into a swizzled
// tile with kThreads threads, zero-filling rows at or past S.
template <int HD, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int r0, int S,
                                          int tid) {
  using L = Tile<HD>;
#pragma unroll
  for (int c = tid; c < kRows * L::kChunks; c += kThreads) {
    const int r = c / L::kChunks, ch = c % L::kChunks, s = r0 + r;
    const bool ok = s < S;
    cp_async16(dst + swz(r, ch, L::kRowElems),
               src + (long)(ok ? s : 0) * stride + ch * 8, ok);
  }
}

}  // namespace tc
