// Split-TF32 tile products on Hopper (sm_90a), shared by the Mamba2 SSD
// scan, kernel 6 (ssd_scan.cu), and its backward, 6-bwd (ssd_scan_bwd.cu).
//
// One block of two warpgroups computes 64 x 64 output tiles per
// warpgroup, C = A B^T over K, with wgmma.m64n64k8 tf32.  wgmma takes tf32
// A and B only K-major from shared memory, so the K dimension is staged
// raw in slices of KS = 32 by cp.async (load_tile: 16-byte copies where
// the rows allow, else 4-byte; zero past the ragged edges) into a ring of
// RING slots, and the block splits each slice once into hi = tf32(a) and
// lo = tf32(a - hi) tiles (split_rows for K-major operands, split_cols
// transposing MN-major ones), K-major in the 128-byte swizzle that wgmma
// reads.  slice_mma runs one slice: per k-step lo.hi + hi.lo, then +
// hi.hi, into a fresh accumulator added to the running sum with f32 adds
// (the tensor cores truncate as they accumulate: one accumulator over a
// long K crossed the plain versions' 1e-4).  store_tile writes an output
// tile back through shared memory as whole rows.  The split tiles and the
// ring take TILES_BYTES of dynamic shared memory (Tiles, carve_tiles);
// each kernel places its own vectors after them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ssd_tf32 {

constexpr int KS = 32;             // K slice: one 128-byte row of tf32
constexpr int ROW = KS * 4;        // bytes of one split-tile row
constexpr int NTHREADS = 256;      // two warpgroups
constexpr int RING = 2;            // raw slices in the ring
constexpr int TILE_ROWS = 192;     // A rows + B rows of every product
constexpr int RAW_FLOATS = TILE_ROWS * KS;            // one raw slice
constexpr int SPLIT_BYTES = TILE_ROWS * ROW;          // hi (or lo) tiles
constexpr size_t TILES_BYTES = 1024 + 2 * SPLIT_BYTES +
                               RING * RAW_FLOATS * 4;

// The hi and lo split tiles (1024-byte aligned for the swizzle) and the
// raw ring.
struct Tiles {
  char* hi;
  char* lo;
  float* raw0;                     // slot k of the ring at raw0 + k * RAW
  __device__ __forceinline__ float* raw(int k) const {
    return raw0 + (k % RING) * RAW_FLOATS;
  }
  __device__ __forceinline__ float* end() const {   // past the ring
    return raw0 + RING * RAW_FLOATS;
  }
};

__device__ __forceinline__ Tiles carve_tiles(char* base) {
  char* p = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(base) + 1023) & ~uintptr_t(1023));
  return Tiles{p, p + SPLIT_BYTES,
               reinterpret_cast<float*>(p + 2 * SPLIT_BYTES)};
}

// ---- cp.async and the raw loader -------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a rows x cols tile (cols a multiple of 4) of a row-major global
// array with row stride ldg into shared memory, densely (pitch cols);
// elements at or past (vr, vc) are zero.  vec: rows and base 16-byte
// aligned.
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          size_t ldg, int rows, int cols,
                                          int vr, int vc, bool vec) {
  const int cq = cols / 4;
  for (int i = threadIdx.x; i < rows * cq; i += NTHREADS) {
    const int r = i / cq, c = (i % cq) * 4;
    float* d = s + r * cols + c;
    const float* src = g + r * ldg + c;
    if (r >= vr || c >= vc) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec && c + 4 <= vc) {
      cp_async16(d, src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < vc) cp_async4(d + j, src + j);
        else d[j] = 0.f;
      }
    }
  }
}

// ---- the split into hi and lo tf32 tiles -----------------------------------

// v rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding for finite v, in two integer
// operations (the cvt instruction checks for NaN and infinity besides;
// these operands are finite).
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Stores v[0..3] (K = 4c..4c+3 of row r) split into the hi and lo tiles:
// 128-byte rows, the 16-byte chunk c of row r at chunk c ^ (r % 8).
__device__ __forceinline__ void put4(const Tiles& sm, int r, int c,
                                     const float (&v)[4]) {
  float4 h, l;
  h.x = tf32_rna(v[0]); l.x = tf32_rna(v[0] - h.x);
  h.y = tf32_rna(v[1]); l.y = tf32_rna(v[1] - h.y);
  h.z = tf32_rna(v[2]); l.z = tf32_rna(v[2] - h.z);
  h.w = tf32_rna(v[3]); l.w = tf32_rna(v[3] - h.w);
  const int off = r * ROW + ((c ^ (r & 7)) << 4);
  *reinterpret_cast<float4*>(sm.hi + off) = h;
  *reinterpret_cast<float4*>(sm.lo + off) = l;
}

// Split-tile rows [r0, r0 + rows) from a K-major raw slice (rows x KS);
// with SCALE, row r is first multiplied by scale[r] (zero from row vr on).
template <bool SCALE>
__device__ __forceinline__ void split_rows(const Tiles& sm, const float* raw,
                                           int r0, int rows,
                                           const float* scale, int vr) {
  for (int i = threadIdx.x; i < rows * (KS / 4); i += NTHREADS) {
    const int r = i / (KS / 4), c = i % (KS / 4);
    const float4 q = *reinterpret_cast<const float4*>(raw + r * KS + c * 4);
    float v[4] = {q.x, q.y, q.z, q.w};
    if (SCALE) {
      const float s = r < vr ? scale[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= s;
    }
    put4(sm, r0 + r, c, v);
  }
}

__device__ __forceinline__ void split_rows(const Tiles& sm, const float* raw,
                                           int r0, int rows) {
  split_rows<false>(sm, raw, r0, rows, nullptr, 0);
}

// Split-tile rows [r0, r0 + W) from an MN-major raw slice (KS x W): row m
// of the tile is column m of the slice; with `scale`, element (k, m) is
// first multiplied by scale[k].
template <bool SCALE>
__device__ __forceinline__ void split_cols(const Tiles& sm, const float* raw,
                                           int W, int r0,
                                           const float* scale) {
  for (int i = threadIdx.x; i < W * (KS / 4); i += NTHREADS) {
    const int m = i % W, c = i / W;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = raw[(4 * c + j) * W + m];
      if (SCALE) v[j] *= scale[4 * c + j];
    }
    put4(sm, r0 + m, c, v);
  }
}

// Makes the split tiles, written by the threads, visible to wgmma (the
// async proxy), then a barrier.
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle:
// start address >> 4, 1024 bytes from one group of 8 rows to the next.
__device__ __forceinline__ unsigned long long desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((addr >> 4) & 0x3FFF) |
         (static_cast<unsigned long long>(1024 >> 4) << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_ACC(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64) = A (64 x 8) B^T + (accumulate ? d : 0), tf32, A and B (64 x
// 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           unsigned long long a,
                                           unsigned long long b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// tot += A[a_row0 : +64] . B[b_row0 : +64]^T over one K slice of the split
// tiles: per k-step lo.hi + hi.lo, then + hi.hi, into a fresh accumulator,
// added to tot with f32 adds.  Called by a whole warpgroup.
__device__ __forceinline__ void slice_mma(float (&tot)[32], const Tiles& sm,
                                          int a_row0, int b_row0) {
  float acc[32];
  const unsigned long long ah = desc(sm.hi + a_row0 * ROW);
  const unsigned long long al = desc(sm.lo + a_row0 * ROW);
  const unsigned long long bh = desc(sm.hi + b_row0 * ROW);
  const unsigned long long bl = desc(sm.lo + b_row0 * ROW);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    const unsigned long long step = (kk * 32) >> 4;   // 8 tf32 = 32 bytes
    wgmma_tf32(acc, al + step, bh + step, kk > 0);
    wgmma_tf32(acc, ah + step, bl + step, 1);
    wgmma_tf32(acc, ah + step, bh + step, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] += acc[i];
}

// Element i of a warpgroup's 64 x 64 accumulator: row, column in the tile.
// Elements with bit 1 of i clear sit in row acc_row(0), the others 8 rows
// below; a row's 64 columns lie in one quad of lanes.
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  return 16 * warp + (lane >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i) {
  const int lane = threadIdx.x & 31;
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Writes the block's TM x TN output tile, element (m, n) to out[m*ldo + n]
// for m < vm and n < vn, through shared memory so that the stores to
// device memory are whole rows (16-byte stores where vec).  Each
// warpgroup's accumulator sits at rows wm0.., columns wn0.. of the tile.
// The staging reuses the split tiles: the first barrier waits for every
// warpgroup's last wgmma.
template <int TM, int TN>
__device__ __forceinline__ void store_tile(const float (&tot)[32],
                                           const Tiles& sm, int wm0, int wn0,
                                           float* out, size_t ldo, int vm,
                                           int vn, bool vec) {
  constexpr int LD = TN + 8;             // a warp's float2 writes hit 32 banks
  static_assert(TM * LD * 4 <= 2 * SPLIT_BYTES, "staging");
  float* stage = reinterpret_cast<float*>(sm.hi);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(stage + (wm0 + acc_row(i)) * LD + wn0 +
                               acc_col(i)) = make_float2(tot[i], tot[i + 1]);
  __syncthreads();
  vm = min(vm, TM);
  vn = min(vn, TN);
  for (int i = threadIdx.x; i < vm * (TN / 4); i += NTHREADS) {
    const int m = i / (TN / 4), n = (i % (TN / 4)) * 4;
    if (n >= vn) continue;
    const float* src = stage + m * LD + n;
    float* dst = out + m * ldo + n;
    if (vec && n + 4 <= vn) {
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    } else {
      for (int j = 0; j < 4 && n + j < vn; ++j) dst[j] = src[j];
    }
  }
}

}  // namespace ssd_tf32
