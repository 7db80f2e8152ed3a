// Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point bound through ctypes (repro_torch/kernels/ssd_scan.py).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan_fwd ->
// _ssd_kernel.  Same function, in f32: for each (batch, head) the sequence
// is cut into chunks of L tokens, and per chunk
//   intra-chunk  y[l]  = sum_{s<=l} (C[l].B[s]) exp(acum[l]-acum[s]) dt[s] x[s]
//   inter-chunk  y[l] += exp(acum[l]) (C[l] . S_prev)
//   state        S     = exp(acum[L-1]) S + sum_s exp(acum[L-1]-acum[s]) dt[s]
//                                                  x[s] B[s]^T       (P, N)
// with acum the inclusive prefix sum of dt*A over the chunk, tokens past
// the sequence given dt = 0 (and zero x, B, C), head h reading B/C group
// h / (H/G).  Returns y (B,S,H,P) and the final state (B,H,P,N).
//
// What bounds it on the H100: per (batch, head, chunk) the least work is
// ~L*L*N/2 (C.B^T, once per group) + 2*L*N*P (C.S_prev, state) + L*L*P/2
// (the weights times x) multiply-adds against ~L*(2P+2N) floats moved, so
// it is bound by operations.  One TF32 tensor-core pass does not hold the
// plain version's 1e-4 (tests/test_torch_ssd.py pins that); split TF32
// does: each f32 operand is split into hi = tf32(a) and lo = tf32(a - hi),
// rounded as cvt.rna.tf32 rounds, and every product is lo.hi + hi.lo, then
// + hi.hi, on the tensor cores: three TF32 products, against a bound of 3x
// the f32 work at 495 TFLOP/s.  The tensor cores truncate as they
// accumulate, so every K slice of 32 starts from zero and is added to the
// running sum with f32 adds: with one accumulator over the whole chunk the
// truncation error grew with the sum and crossed the tolerance at
// mamba2's shape for some seeds.  The state carry between chunks is bound
// by bytes.
//
// Design: the TPU grid's sequential chunk axis carried the (P, N) state in
// VMEM.  Only that carry is sequential, so the scan is four passes on one
// stream, three of them parallel over (batch, head, chunk):
//   A  per (chunk, 64-row tile, group, batch): CB = C.B^T (L x L, the
//      causal half) into scratch `cb`: once per group, not per head.
//   B  per (chunk, N tile, P tile, head, batch): the chunk's own state
//      dS_c = x^T (B * f), f[s] = exp(acum[L-1]-acum[s]) dt[s], into
//      scratch `st`, and acum[L-1] into scratch `at`.
//   C  per (P*N tile, head, batch), serial over chunks, elementwise:
//      S_c = exp(at_c) S_{c-1} + dS_c (multiply, then add, as the plain
//      version), writing each chunk's incoming state over dS_c in place
//      and the last into `fin`.
//   D  per (chunk, P tile, head, batch): y = exp(acum) * (C.S_prev^T)
//      + W.x, W = CB * exp(acum[l]-acum[s]) * dt[s] masked to s <= l.
// Passes B and D each compute their chunk's acum from dt, in token order,
// product and sum rounded separately (no FMA contraction), as the plain
// version takes it: acum reaches ~-100 within a chunk at mamba2's init,
// where one ulp of acum is ~1e-5 of the decay.  No exp of a positive
// difference is ever formed (s <= l only; acum never rises).
// Products (passes A, B, D): wgmma.m64n64k8 tf32, two warpgroups a block,
// each owning a 64 x 64 output tile.  wgmma takes tf32 A and B only
// K-major from shared memory, so every operand goes through a split pass:
// the K dimension (N for C.B^T and C.S_prev^T, tokens for W.x and the
// state) is staged raw in slices of 32 by cp.async (16-byte copies where
// the rows allow, else 4-byte; zero past the ragged edges) into a ring of
// 2; the block splits each slice once into hi and lo tiles, K-major in the
// 128-byte swizzle that wgmma reads, transposing the MN-major operands (x
// in W.x; x and B in the state) on the way, scaling B by f (pass B) and
// forming W from CB (pass D, one exp per element at or below the
// diagonal).  The next slice's copy is in flight meanwhile.  Per slice a
// warpgroup runs 12 wgmma (4 k-steps x 3 products).  Warpgroups whose rows
// or columns lie past the sequence, or above the diagonal, skip theirs.
// Output tiles leave through shared memory as whole rows.  ~98 KB of
// shared memory a block: two blocks an SM.
// Deterministic: no atomics; every sum runs in a fixed order.
// The wrapper allocates the scratch (`cb` B*nc*G*L*Lr floats with Lr = L
// rounded up to 4, `st` B*H*nc*P*N, `at` B*H*nc); the kernel allocates
// nothing.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int LMAX = 128;          // largest chunk
constexpr int NMAX = 256;          // largest d_state
constexpr int KS = 32;             // K slice: one 128-byte row of tf32
constexpr int ROW = KS * 4;        // bytes of one split-tile row
constexpr int NTHREADS = 256;      // two warpgroups
constexpr int PT = 64;             // P tile (passes B, D)
constexpr int NT = 128;            // N tile (pass B)
constexpr int LT = 64;             // row tile of C.B^T (pass A)
constexpr int RING = 2;            // raw slices in the ring
constexpr int TILE_ROWS = 192;     // A rows + B rows of every product
constexpr int RAW_FLOATS = TILE_ROWS * KS;            // one raw slice
constexpr int SPLIT_BYTES = TILE_ROWS * ROW;          // hi (or lo) tiles
constexpr size_t SMEM_BYTES = 1024 + 2 * SPLIT_BYTES +
                              RING * RAW_FLOATS * 4 + 2 * LMAX * 4;
constexpr int CARRY_PER_BLOCK = NTHREADS * 4;         // pass C elements

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* fin;
  float* cb;                       // (B, nc, G, L, Lr)
  float* st;                       // (B, H, nc, P, N)
  float* at;                       // (B, H, nc)
  int S, H, P, G, N, L, Lr, nc;
  bool vx, vbc, vst, vcb, vy;      // 16-byte copies allowed
};

// Shared memory of the three product passes: the hi and lo split tiles
// (1024-byte aligned for the swizzle), the raw ring, dt and acum.
struct Smem {
  char* hi;
  char* lo;
  float* raw0;                     // slot k of the ring at raw0 + k * RAW
  float* dt;
  float* ac;
  __device__ __forceinline__ float* raw(int k) const {
    return raw0 + (k % RING) * RAW_FLOATS;
  }
};

__device__ __forceinline__ Smem carve(char* base) {
  char* p = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(base) + 1023) & ~uintptr_t(1023));
  Smem s;
  s.hi = p;
  s.lo = p + SPLIT_BYTES;
  s.raw0 = reinterpret_cast<float*>(p + 2 * SPLIT_BYTES);
  s.dt = s.raw0 + RING * RAW_FLOATS;
  s.ac = s.dt + LMAX;
  return s;
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

// Waits until at most RING - 2 copy groups are pending: slice k is in.
__device__ __forceinline__ void cp_async_wait_slice() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 2) : "memory");
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
__device__ __forceinline__ void put4(const Smem& sm, int r, int c,
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

// Split-tile rows [r0, r0 + rows) from a K-major raw slice (rows x KS).
__device__ __forceinline__ void split_rows(const Smem& sm, const float* raw,
                                           int r0, int rows) {
  for (int i = threadIdx.x; i < rows * (KS / 4); i += NTHREADS) {
    const int r = i / (KS / 4), c = i % (KS / 4);
    const float4 q = *reinterpret_cast<const float4*>(raw + r * KS + c * 4);
    const float v[4] = {q.x, q.y, q.z, q.w};
    put4(sm, r0 + r, c, v);
  }
}

// Split-tile rows [r0, r0 + W) from an MN-major raw slice (KS x W): row m
// of the tile is column m of the slice; with `scale`, element (k, m) is
// first multiplied by scale[k].
template <bool SCALE>
__device__ __forceinline__ void split_cols(const Smem& sm, const float* raw,
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
__device__ __forceinline__ void slice_mma(float (&tot)[32], const Smem& sm,
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
                                           const Smem& sm, int wm0, int wn0,
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

// The chunk's dt (zero past the sequence) into sm.dt and its inclusive
// prefix sum of dt*A into sm.ac, over all LMAX entries (dt = 0 past L keeps
// the sum).  Ends with a barrier.
__device__ __forceinline__ void chunk_acum(const Params& p, const Smem& sm,
                                           int b, int h, int t0, int Lv) {
  for (int s = threadIdx.x; s < LMAX; s += NTHREADS)
    sm.dt[s] = s < Lv ? p.dt[(size_t(b) * p.S + t0 + s) * p.H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    // one warp, every lane running the sum over all tokens in order from
    // broadcast reads; lane j keeps acum[s] for s = j (mod 32)
    const int lane = threadIdx.x;
    const float A = p.A[h];
    float acc = 0.f, mine[LMAX / 32];
#pragma unroll
    for (int s = 0; s < LMAX; ++s) {
      acc = __fadd_rn(acc, __fmul_rn(sm.dt[s], A));
      if (lane == s % 32) mine[s / 32] = acc;
    }
#pragma unroll
    for (int i = 0; i < LMAX / 32; ++i) sm.ac[lane + 32 * i] = mine[i];
  }
  __syncthreads();
}

// ---- pass A: CB = C.B^T per (chunk, row tile, group, batch) ---------------

__global__ void __launch_bounds__(NTHREADS, 2) ssd_cb_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int nlt = (p.L + LT - 1) / LT;
  const int c = blockIdx.x / nlt, l0 = (blockIdx.x % nlt) * LT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  if (l0 >= Lv) return;                  // rows past the sequence: unread
  const int wg = threadIdx.x / 128;      // output columns s of 64 wg ..
  const bool active = 64 * wg <= l0 + LT - 1 && 64 * wg < Lv;
  const size_t ldg = size_t(p.G) * p.N;
  const float* gC = p.Cm + ((size_t(b) * p.S + t0 + l0) * p.G + g) * p.N;
  const float* gB = p.Bm + ((size_t(b) * p.S + t0) * p.G + g) * p.N;
  const int brows = min(Lv, l0 + LT);    // B rows s <= the tile's last row
  const int nk = (p.N + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    const int k0 = k * KS;
    if (k < nk) {
      load_tile(raw, gC + k0, ldg, LT, KS, Lv - l0, p.N - k0, p.vbc);
      load_tile(raw + LT * KS, gB + k0, ldg, LMAX, KS, brows, p.N - k0,
                p.vbc);
    }
    cp_async_commit();
  };

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < RING - 1; ++k) issue(k);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    split_rows(sm, sm.raw(k), 0, LT + LMAX);
    publish();
    if (active) slice_mma(tot, sm, 0, LT + 64 * wg);
  }
  float* out = p.cb + ((size_t(b) * p.nc + c) * p.G + g) * p.L * p.Lr +
               size_t(l0) * p.Lr;
  store_tile<LT, LMAX>(tot, sm, 0, 64 * wg, out, p.Lr, Lv - l0, p.L, p.vcb);
}

// ---- pass B: dS_c = x^T (B * f) per (chunk, N tile, P tile, head, batch) --

__global__ void __launch_bounds__(NTHREADS, 2)
ssd_state_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ntl = (p.N + NT - 1) / NT, ptl = (p.P + PT - 1) / PT;
  const int nt = blockIdx.x % ntl, pt = (blockIdx.x / ntl) % ptl;
  const int c = blockIdx.x / (ntl * ptl);
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  const int p0 = pt * PT, n0 = nt * NT;
  const int wg = threadIdx.x / 128;      // output columns n of 64 wg ..
  const bool active = n0 + 64 * wg < p.N;
  const float* gX = p.x + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  const float* gB = p.Bm + ((size_t(b) * p.S + t0) * p.G + g) * p.N + n0;
  const int nk = (Lv + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    const int k0 = k * KS;
    if (k < nk) {
      load_tile(raw, gX + size_t(k0) * p.H * p.P, size_t(p.H) * p.P, KS, PT,
                Lv - k0, p.P - p0, p.vx);
      load_tile(raw + KS * PT, gB + size_t(k0) * p.G * p.N,
                size_t(p.G) * p.N, KS, NT, Lv - k0, p.N - n0, p.vbc);
    }
    cp_async_commit();
  };

  for (int k = 0; k < RING - 1; ++k) issue(k);
  chunk_acum(p, sm, b, h, t0, Lv);
  const float atot = sm.ac[LMAX - 1];
  // f[s] = exp(acum[L-1] - acum[s]) dt[s], in place of dt (read only here)
  for (int s = threadIdx.x; s < LMAX; s += NTHREADS)
    sm.dt[s] = expf(atot - sm.ac[s]) * sm.dt[s];
  if (threadIdx.x == 0 && nt == 0 && pt == 0)
    p.at[(size_t(b) * p.H + h) * p.nc + c] = atot;

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    const float* raw = sm.raw(k);
    split_cols<false>(sm, raw, PT, 0, nullptr);                 // x^T
    split_cols<true>(sm, raw + KS * PT, NT, PT, sm.dt + k * KS);  // (B f)^T
    publish();
    if (active) slice_mma(tot, sm, 0, PT + 64 * wg);
  }
  float* out =
      p.st + (((size_t(b) * p.H + h) * p.nc + c) * p.P + p0) * p.N + n0;
  store_tile<PT, NT>(tot, sm, 0, 64 * wg, out, p.N, p.P - p0, p.N - n0,
                     p.vst);
}

// ---- pass C: the state carry across chunks, elementwise --------------------

__global__ void __launch_bounds__(NTHREADS)
ssd_carry_kernel(const Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t PN = size_t(p.P) * p.N;
  const size_t e0 = (size_t(blockIdx.x) * NTHREADS + threadIdx.x) * 4;
  if (e0 >= PN) return;
  const float* at = p.at + (size_t(b) * p.H + h) * p.nc;
  float* st = p.st + (size_t(b) * p.H + h) * p.nc * PN + e0;
  float* fin = p.fin + (size_t(b) * p.H + h) * PN + e0;
  const int ne = PN - e0 < 4 ? int(PN - e0) : 4;
  const bool vec = p.vst && ne == 4;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr int CU = 8;                  // chunks loaded ahead of the sums
  for (int c0 = 0; c0 < p.nc; c0 += CU) {
    float d[CU][4], decay[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (c0 + u >= p.nc) break;
      const float* sc = st + size_t(c0 + u) * PN;
      decay[u] = expf(at[c0 + u]);
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(sc);
        d[u][0] = v.x; d[u][1] = v.y; d[u][2] = v.z; d[u][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[u][j] = j < ne ? sc[j] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (c0 + u >= p.nc) break;
      float* sc = st + size_t(c0 + u) * PN;
      if (vec) {
        *reinterpret_cast<float4*>(sc) =
            make_float4(carry[0], carry[1], carry[2], carry[3]);
      } else {
        for (int j = 0; j < ne; ++j) sc[j] = carry[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        carry[j] = __fadd_rn(__fmul_rn(carry[j], decay[u]), d[u][j]);
    }
  }
  for (int j = 0; j < ne; ++j) fin[j] = carry[j];
}

// ---- pass D: y = exp(acum) (C.S_prev^T) + W.x per (chunk, P tile, head) ---

__global__ void __launch_bounds__(NTHREADS, 2) ssd_y_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ptl = (p.P + PT - 1) / PT;
  const int pt = blockIdx.x % ptl, c = blockIdx.x / ptl;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  const int p0 = pt * PT;
  const int wg = threadIdx.x / 128;      // output rows l of 64 wg ..
  const bool live = 64 * wg < Lv;
  const size_t ldbc = size_t(p.G) * p.N;
  const float* gC = p.Cm + ((size_t(b) * p.S + t0) * p.G + g) * p.N;
  const float* gS =
      p.st + (((size_t(b) * p.H + h) * p.nc + c) * p.P + p0) * p.N;
  const float* gW = p.cb + ((size_t(b) * p.nc + c) * p.G + g) * p.L * p.Lr;
  const float* gX = p.x + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  // K slices: first C.S_prev^T over N (none for the first chunk, whose
  // incoming state is zero), then W.x over the chunk's tokens
  const int n1 = c > 0 ? (p.N + KS - 1) / KS : 0;
  const int nk = n1 + (Lv + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    if (k >= nk) {
    } else if (k < n1) {
      const int k0 = k * KS;
      load_tile(raw, gC + k0, ldbc, LMAX, KS, Lv, p.N - k0, p.vbc);
      load_tile(raw + LMAX * KS, gS + k0, p.N, PT, KS, p.P - p0, p.N - k0,
                p.vst);
    } else {
      // CB rows from the first warpgroup that reads this slice
      const int k0 = (k - n1) * KS, r0 = k0 / 64 * 64;
      load_tile(raw + r0 * KS, gW + size_t(r0) * p.Lr + k0, p.Lr, LMAX - r0,
                KS, Lv - r0, Lv - k0, p.vcb);
      load_tile(raw + LMAX * KS, gX + size_t(k0) * p.H * p.P,
                size_t(p.H) * p.P, KS, PT, Lv - k0, p.P - p0, p.vx);
    }
    cp_async_commit();
  };

  for (int k = 0; k < RING - 1; ++k) issue(k);
  chunk_acum(p, sm, b, h, t0, Lv);

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    const float* raw = sm.raw(k);
    if (k < n1) {
      split_rows(sm, raw, 0, LMAX + PT);                 // C, S_prev
      publish();
      if (live) slice_mma(tot, sm, 64 * wg, LMAX);
      continue;
    }
    const int k0 = (k - n1) * KS;
    if (k == n1 && n1 > 0) {             // the inter-chunk term's decay
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] *= expf(sm.ac[64 * wg + acc_row(i)]);
    }
    // the weights: W[l][s] = CB[l][s] exp(acum[l]-acum[s]) dt[s] for s <= l,
    // else 0, from the first row of the first warpgroup that reads this
    // slice
    const int r0 = k0 / 64 * 64;
    for (int i = threadIdx.x; i < (LMAX - r0) * (KS / 4); i += NTHREADS) {
      const int l = r0 + i / (KS / 4), cq = i % (KS / 4);
      const float4 q =
          *reinterpret_cast<const float4*>(raw + l * KS + cq * 4);
      float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + cq * 4 + j;
        v[j] = s <= l ? v[j] * expf(sm.ac[l] - sm.ac[s]) * sm.dt[s] : 0.f;
      }
      put4(sm, l, cq, v);
    }
    split_cols<false>(sm, raw + LMAX * KS, PT, LMAX, nullptr);  // x^T
    publish();
    if (live && k0 <= 64 * wg + 63) slice_mma(tot, sm, 64 * wg, LMAX);
  }
  float* out = p.y + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  store_tile<LMAX, PT>(tot, sm, 64 * wg, 0, out, size_t(p.H) * p.P, Lv,
                       p.P - p0, p.vy);
}

// Raises a kernel's dynamic shared-memory limit once per device.
template <auto Kernel>
cudaError_t set_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err == cudaSuccess) done[dev].store(true);
  return err;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// All tensors float32 and contiguous: x, y (B,S,H,P); dt (B,S,H); A (H,);
// Bm, Cm (B,S,G,N); fin (B,H,P,N); scratch cb (B,nc,G,L,Lr), st
// (B,H,nc,P,N), at (B,H,nc) with nc = ceil(S/L) and Lr = L rounded up to a
// multiple of 4.  L is the chunk length (min(chunk, S)).  Launches the four
// passes on `stream` and returns the first cudaError_t.
extern "C" int repro_ssd_scan_fwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, float* y, float* fin,
                                  float* cb, float* st, float* at, int B,
                                  int S, int H, int P, int G, int N, int L,
                                  void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || L < 1 || L > LMAX || B > 65535 || H > 65535 || G > 65535)
    return int(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fin, cb, st, at, S, H, P, G, N, L,
           (L + 3) / 4 * 4, (S + L - 1) / L, false, false, false, false,
           false};
  p.vx = P % 4 == 0 && aligned16(x);
  p.vbc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  p.vst = N % 4 == 0 && aligned16(st);
  p.vcb = aligned16(cb);
  p.vy = P % 4 == 0 && aligned16(y);
  cudaError_t err;
  if ((err = set_smem<ssd_cb_kernel>()) != cudaSuccess ||
      (err = set_smem<ssd_state_kernel>()) != cudaSuccess ||
      (err = set_smem<ssd_y_kernel>()) != cudaSuccess)
    return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ptl = (P + PT - 1) / PT, ntl = (N + NT - 1) / NT;
  ssd_cb_kernel<<<dim3(p.nc * ((L + LT - 1) / LT), G, B), NTHREADS,
                  SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_state_kernel<<<dim3(p.nc * ntl * ptl, H, B), NTHREADS, SMEM_BYTES,
                     s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t PN = size_t(P) * N;
  ssd_carry_kernel<<<dim3(unsigned((PN + CARRY_PER_BLOCK - 1) /
                                   CARRY_PER_BLOCK), H, B),
                     NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_y_kernel<<<dim3(p.nc * ptl, H, B), NTHREADS, SMEM_BYTES, s>>>(p);
  return int(cudaGetLastError());
}
