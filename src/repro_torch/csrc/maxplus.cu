// Max-plus (tropical) convolutions on Hopper: the Unicron planner's DP step.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/maxplus.py:
//   maxplus_conv          (_maxplus_kernel)          out[j] = max_{k<=min(j,band)} prev[j-k] + g[k]
//   maxplus_conv_batched  (_maxplus_batched_kernel)  B rows, each with its own band
//   maxplus_scan_chunk    (_maxplus_scan_kernel)     out[r,j] = max_{k<K} wins[r,j+K-1-k] + gs[r,k]
//
// All three are one computation: out[j] = max_{k<kc} src[j + base - k] + g[k],
// with src read as -inf outside [0, src_len).  conv: base 0, kc = band+1;
// scan chunk: base K-1, kc = K.  Kernels 4 and 5 give one thread one output
// cell of one row; the grid is (ceil(n1 / BLOCK), rows).  The block stages
// the src span its cells read and the g values of a tile of k in shared
// memory, then folds acc = fmax(acc, w + g[k]) over the tile (fold_row).  A
// row's band is a loop bound: no -inf-masked copy of g is built.
//
// The fused engine's scan step (maxplus_scan_step_kernel, kernel 5 on the
// planner's path) is the same fold reading the float64 slot buffer itself:
// row r of step s folds its window of slot src[s][r] against the reward
// chunk of slot gsl[s][r] in the program's type T and max-reduces the
// widened result into slot out[s][r].  That puts the gather, the band mask,
// both casts and the scatter-max of the step in the one launch.
//
// Bitwise contract: each candidate is one IEEE add (no multiply, so nothing
// is contracted into an FMA) and max is exact, so every output equals the
// plain PyTorch version (repro_torch/kernels/ref.py) on the card bit for
// bit in float32 and float64.  The plain version's torch.maximum is fmax on
// the card, as here; fmax returns the non-NaN operand where torch.maximum
// propagates NaN, and the planner's inputs are never NaN (-inf at most, and
// -inf + finite = -inf).  A double read as float rounds to nearest, as
// torch's .to(torch.float32) does.
//
// Bound: at the planner's sizes (n1 ~ 1e3, B <= 64, band ~ 16) a launch does
// a few microseconds of work, so launch latency and the host around each
// launch bound it.  Hence the designs of kernels 4 and 5 are about their
// launches: kernel 4 takes its bands by value in the launch's parameters
// (no device array, no upload), and the scan step reads and reduces the
// slot buffer itself, so the fused program is one kernel per step and the
// whole program fits one CUDA graph.  Otherwise a call is 2*B*n1*(band+1)
// add+max operations against 33.5 TFLOP/s (fp64; 67 f32) and
// (2*n1+band+1)*B*8 bytes against 3.35 TB/s, i.e. operation-bound once
// band+1 exceeds ~20 in fp64.  Every candidate stays out of device memory
// (one load per staged element, then shared-memory reads) and the k tile is
// sized to the band, so a narrow band stages only BLOCK+band elements.
//
// Kernel 3 (one row) is bound by its launch too: a dense n = 1024 call is
// 2 * (1025 * 1025 - 1024 * 1025 / 2) = 1.05e6 operations, 31 ns at the
// fp64 peak, against a few microseconds to launch.  Folded as kernels 4
// and 5 fold, it ran 5 blocks on 132 SMs and each thread folded all 1025
// candidates of its cell in one dependent max chain, half of them the -inf
// triangle k > j: the card's critical path was one 1025-long serial chain
// (0.024 ms, 760x the bound).  So it has two variants, chosen by the
// widest cell's candidate count, min(band, n1-1) + 1
// (kernels/maxplus.py: variant() and WIDE_MIN):
//   wide    one warp per cell and WARPS cells per block, so a dense
//           n = 1024 call runs 129 blocks, one wave over the SMs.  Lanes
//           stride over k up to the cell's own min(j, band) (the triangle
//           is never folded), each folding at most 33 candidates at
//           n = 1024, and five shuffle steps combine the lanes.  The block
//           stages its prev window and g[0 .. its k range) in shared
//           memory with cp.async (16 KB in f64 at n = 1024).
//   narrow  the one-thread-per-cell fold of kernels 4 and 5, with each
//           block's k range cut to min(band, its last cell) + 1, for the
//           shortest bands: below WIDE_MIN candidates a warp per cell
//           leaves most lanes idle and its 16x more blocks stage more.
// The wide variant combines candidates in another order than the plain
// version's ascending k.  On the card fmax, and torch.maximum with it,
// orders -0.0 below +0.0 whichever operand comes first (measured on an
// H100; chip_smoke.py's phase kernel:maxplus holds rows of +-0 ties on
// both variants), so the order does not change a bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BLOCK = 256;   // output cells per block (one per thread)
constexpr int TK = 256;      // k values per staged tile
// Kernel 4's bands travel in the launch's parameter space, which holds
// 32764 bytes on Hopper (CUDA 12.1+): three pointers, n1 and this many ints.
// kernels/maxplus.py's _MAX_BANDS is the same number.
constexpr int MAX_BANDS = 8000;

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -CUDART_INF_F; }
template <> __device__ __forceinline__ double neg_inf<double>() { return -CUDART_INF; }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// max_{0 <= k < kc} T(src[j + base - k]) + T(g[k]) for this thread's cell
// j = blockIdx.x * BLOCK + threadIdx.x of one row (every thread of the block
// calls it; the caller writes the cells j < n1).  S is the stored type, T
// the arithmetic type: a double read as float rounds to nearest, as
// torch's .to(torch.float32) does.
template <typename T, typename S>
__device__ T fold_row(const S* src, long long src_len, const S* g, int base,
                      int kc) {
  __shared__ T w[BLOCK + TK - 1];
  __shared__ T gt[TK];
  const int tid = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * BLOCK;
  T acc = neg_inf<T>();
  for (int k0 = 0; k0 < kc; k0 += TK) {
    const int tk = min(TK, kc - k0);
    // w[t] = src[j0 + base - k0 - (tk-1) + t]; cell tid at k = k0 + kk
    // reads src[j0 + tid + base - k0 - kk] = w[tid + tk-1 - kk]
    const long long s0 = j0 + base - k0 - (tk - 1);
    for (int t = tid; t < BLOCK + tk - 1; t += BLOCK) {
      const long long idx = s0 + t;
      w[t] = (idx >= 0 && idx < src_len) ? (T)src[idx] : neg_inf<T>();
    }
    for (int t = tid; t < tk; t += BLOCK) gt[t] = (T)g[k0 + t];
    __syncthreads();
    const T* wp = w + tid + tk - 1;
#pragma unroll 8
    for (int kk = 0; kk < tk; ++kk) acc = vmax(acc, wp[-kk] + gt[kk]);
    __syncthreads();
  }
  return acc;
}

__device__ __forceinline__ long long cell() {
  return (long long)blockIdx.x * BLOCK + threadIdx.x;
}

// Kernel 3, narrow: fold_row, each block's k range cut to the candidates
// of its last cell.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_conv_narrow_kernel(const T* __restrict__ prev,
                           const T* __restrict__ g, T* __restrict__ out,
                           int n1, int band) {
  const int last = min((int)(blockIdx.x + 1) * BLOCK, n1) - 1;
  const T acc = fold_row<T>(prev, n1, g, 0, min(band, last) + 1);
  if (cell() < n1) out[cell()] = acc;
}

constexpr int WARPS = 8;     // kernel 3, wide: cells per block, a warp each
constexpr int TKW = 1024;    // kernel 3, wide: k values per staged tile

// One element global -> shared without a register round trip; every copy
// of the thread lands by cp_async_wait_all().
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Kernel 3, wide: warp w of block b owns cell j = b*WARPS + w.  Its lanes
// stride over k < min(j, band) + 1; the block stages, per tile of k, the
// prev window its cells read and that tile of g.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
maxplus_conv_wide_kernel(const T* __restrict__ prev, const T* __restrict__ g,
                         T* __restrict__ out, int n1, int band) {
  __shared__ T w[WARPS + TKW - 1];
  __shared__ T gt[TKW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * WARPS, j = j0 + warp;
  const int kb = min(band, min(j0 + WARPS, n1) - 1) + 1;  // the block's k
  const int kj = min(j, band) + 1;                         // cell j's k
  T acc = neg_inf<T>();
  for (int k0 = 0; k0 < kb; k0 += TKW) {
    const int tk = min(TKW, kb - k0);
    // w[t] = prev[j0 - k0 - (tk-1) + t]; cell j at k = k0 + kk reads
    // prev[j - k] = w[warp + tk-1 - kk]
    const int s0 = j0 - k0 - (tk - 1);
    for (int t = threadIdx.x; t < WARPS + tk - 1; t += WARPS * 32) {
      const int idx = s0 + t;
      if (idx >= 0 && idx < n1) cp_async(w + t, prev + idx);
      else w[t] = neg_inf<T>();
    }
    for (int t = threadIdx.x; t < tk; t += WARPS * 32)
      cp_async(gt + t, g + k0 + t);
    cp_async_wait_all();
    __syncthreads();
    const T* wp = w + warp + tk - 1;
    const int kend = min(tk, kj - k0);
#pragma unroll 4
    for (int kk = lane; kk < kend; kk += 32) acc = vmax(acc, wp[-kk] + gt[kk]);
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1)
    acc = vmax(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (lane == 0 && j < n1) out[j] = acc;
}

template <int CAP> struct Bands { int b[CAP]; };

template <typename T, int CAP>
__global__ void __launch_bounds__(BLOCK)
maxplus_conv_batched_kernel(const T* __restrict__ prev,
                            const T* __restrict__ g, T* __restrict__ out,
                            int n1, __grid_constant__ const Bands<CAP> bands) {
  const long long r = blockIdx.y;
  const T acc = fold_row<T>(prev + r * n1, n1, g + r * n1, 0,
                            bands.b[r] + 1);
  if (cell() < n1) out[r * n1 + cell()] = acc;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_scan_chunk_kernel(const T* __restrict__ wins,
                          const T* __restrict__ gs, T* __restrict__ out,
                          int n1, int K) {
  const long long r = blockIdx.y;
  const long long wlen = (long long)n1 + K - 1;
  const T acc = fold_row<T>(wins + r * wlen, wlen, gs + r * K, K - 1, K);
  if (cell() < n1) out[r * n1 + cell()] = acc;
}

// The image of a double's bits under which signed 64-bit order is the
// order of the doubles (-0.0 just below +0.0): negative values get their 63
// low bits flipped.
__device__ __forceinline__ long long ordered(long long bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffffffffffffLL;
}

// *slot = max(*slot, v) against concurrent writers of the same slot.  A
// stale first read is at most the slot's value (a slot only grows within a
// step), so leaving when v does not exceed it is right.
__device__ __forceinline__ void atomic_max(double* slot, double v) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(slot);
  const long long want = __double_as_longlong(v);
  unsigned long long seen = *p;
  while (ordered(want) > ordered((long long)seen)) {
    const unsigned long long was =
        atomicCAS(p, seen, (unsigned long long)want);
    if (was == seen) return;
    seen = was;
  }
}

// One step of the fused program over the slot buffer (n_slots rows of
// `width` doubles, a slot's values at columns padl .. padl+n1-1, -inf
// margins around them).  tables is (5, n_steps, G) int32: src, gsl, off,
// band, out.  Block (x, r) folds row r of step `step`:
//   acc[j] = max_{k < min(K, band-off+1)} T(buf[src, padl-off+j-k])
//                                        + T(buf[gsl, padl+off+k])
//   buf[out, padl+j] = max(buf[out, padl+j], double(acc[j]))
// A dummy row (band = -1) does nothing.  Several rows of a step may share
// an output slot (the offset chunks of one op), hence the atomic max; max
// is exact and order-free, so the result does not depend on which block
// writes first.  The schedule pads its steps per dependency level
// (core/planner.py, _FusedSchedule), so no row of a step reads a slot that
// a row of the same step writes: the reads need no ordering against the
// writes, and buf is not __restrict__.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_scan_step_kernel(double* buf, const int* __restrict__ tables,
                         int n_steps, int step, int G, int K, int n1,
                         int padl, int width) {
  const long long plane = (long long)n_steps * G;
  const int* row = tables + (long long)step * G + blockIdx.y;
  const int src = row[0], gsl = row[plane], off = row[2 * plane],
            band = row[3 * plane], out = row[4 * plane];
  if (band < 0) return;                          // the whole block leaves
  const int kc = min(K, band - off + 1);
  const double* wins = buf + (long long)src * width + padl - off - (K - 1);
  const double* gs = buf + (long long)gsl * width + padl + off;
  const T acc = fold_row<T>(wins, (long long)n1 + K - 1, gs, K - 1, kc);
  if (cell() < n1)
    atomic_max(buf + (long long)out * width + padl + cell(), (double)acc);
}

dim3 grid_for(int n1, int rows) {
  return dim3((unsigned)((n1 + BLOCK - 1) / BLOCK), (unsigned)rows);
}

// variant 0 is "narrow", 1 "wide" (kernels/maxplus.py: VARIANTS).
template <typename T>
int conv(const T* prev, const T* g, T* out, int n1, int band, int variant,
         void* stream) {
  if (n1 < 1 || band < 0 || band >= n1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    maxplus_conv_narrow_kernel<T><<<grid_for(n1, 1), BLOCK, 0, s>>>(
        prev, g, out, n1, band);
  else if (variant == 1)
    maxplus_conv_wide_kernel<T><<<(n1 + WARPS - 1) / WARPS, WARPS * 32, 0,
                                  s>>>(prev, g, out, n1, band);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The launch copies CAP bands into its parameters: the smallest CAP that
// holds B keeps the usual launch small.
template <typename T, int CAP>
int conv_batched_cap(const T* prev, const T* g, const int* bands, T* out,
                     int B, int n1, void* stream) {
  Bands<CAP> bs;
  for (int r = 0; r < B; ++r) bs.b[r] = bands[r];
  maxplus_conv_batched_kernel<T, CAP><<<grid_for(n1, B), BLOCK, 0,
                                        (cudaStream_t)stream>>>(
      prev, g, out, n1, bs);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_batched(const T* prev, const T* g, const int* bands, T* out, int B,
                 int n1, void* stream) {
  if (B <= 64) return conv_batched_cap<T, 64>(prev, g, bands, out, B, n1, stream);
  if (B <= 1024)
    return conv_batched_cap<T, 1024>(prev, g, bands, out, B, n1, stream);
  if (B <= MAX_BANDS)
    return conv_batched_cap<T, MAX_BANDS>(prev, g, bands, out, B, n1, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int scan_chunk(const T* wins, const T* gs, T* out, int B, int n1, int K,
               void* stream) {
  maxplus_scan_chunk_kernel<T><<<grid_for(n1, B), BLOCK, 0,
                                 (cudaStream_t)stream>>>(wins, gs, out, n1,
                                                         K);
  return (int)cudaGetLastError();
}

template <typename T>
int scan_step(double* buf, const int* tables, int n_steps, int step, int G,
              int K, int n1, int padl, int width, void* stream) {
  maxplus_scan_step_kernel<T><<<grid_for(n1, G), BLOCK, 0,
                                (cudaStream_t)stream>>>(
      buf, tables, n_steps, step, G, K, n1, padl, width);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  Pointers are device pointers to contiguous
// row-major arrays, except `bands`: a HOST int32 array of B clamped bands
// (0 <= band <= n1-1, B <= MAX_BANDS), copied into the launch.  Kernel 3's
// entries take its clamped band and its variant (0 narrow, 1 wide) and
// refuse any other.  Each returns cudaGetLastError() after its launch.
extern "C" {

int repro_maxplus_conv_f32(const float* prev, const float* g, float* out,
                           int n1, int band, int variant, void* stream) {
  return conv<float>(prev, g, out, n1, band, variant, stream);
}
int repro_maxplus_conv_f64(const double* prev, const double* g, double* out,
                           int n1, int band, int variant, void* stream) {
  return conv<double>(prev, g, out, n1, band, variant, stream);
}
int repro_maxplus_conv_batched_f32(const float* prev, const float* g,
                                   const int* bands, float* out, int B,
                                   int n1, void* stream) {
  return conv_batched<float>(prev, g, bands, out, B, n1, stream);
}
int repro_maxplus_conv_batched_f64(const double* prev, const double* g,
                                   const int* bands, double* out, int B,
                                   int n1, void* stream) {
  return conv_batched<double>(prev, g, bands, out, B, n1, stream);
}
int repro_maxplus_scan_chunk_f32(const float* wins, const float* gs,
                                 float* out, int B, int n1, int K,
                                 void* stream) {
  return scan_chunk<float>(wins, gs, out, B, n1, K, stream);
}
int repro_maxplus_scan_chunk_f64(const double* wins, const double* gs,
                                 double* out, int B, int n1, int K,
                                 void* stream) {
  return scan_chunk<double>(wins, gs, out, B, n1, K, stream);
}
// `buf` is the float64 slot buffer in both; the suffix names the
// arithmetic type.
int repro_maxplus_scan_step_f32(double* buf, const int* tables, int n_steps,
                                int step, int G, int K, int n1, int padl,
                                int width, void* stream) {
  return scan_step<float>(buf, tables, n_steps, step, G, K, n1, padl, width,
                          stream);
}
int repro_maxplus_scan_step_f64(double* buf, const int* tables, int n_steps,
                                int step, int G, int K, int n1, int padl,
                                int width, void* stream) {
  return scan_step<double>(buf, tables, n_steps, step, G, K, n1, padl, width,
                           stream);
}

}  // extern "C"
