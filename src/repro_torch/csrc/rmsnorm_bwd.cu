// RMSNorm backward for Hopper (sm_90a), CUDA C++ with a plain C entry point
// bound through ctypes (repro_torch/kernels/rmsnorm_bwd.py).
//
// Replaces no TPU kernel: it is the port of the analytic VJP
// repro/models/layers.py: _rmsnorm_fused_bwd (pure jnp), the backward of
// kernel 2 (csrc/rmsnorm.cu).  Row by row over x and g viewed as (rows, d):
//   r      = rsqrt(mean(x^2) + eps)
//   gs     = g * scale
//   dot    = sum(gs * x) / d
//   dx     = r * gs - (x * r^3) * dot            in x's dtype
//   dscale = sum over rows of (g * x) * r        in scale's dtype
// all in f32, with x and g in bf16 or f32 (g in x's dtype) and scale (d,)
// in bf16 or f32.
//
// What bounds it on the H100: bytes.  A row reads x and g (2d elements)
// and writes dx (d) for ~10d flops, so at 3.35 TB/s against 67 TFLOP/s
// (f32) the bytes take ~5-20x longer than the arithmetic.
// Design:
//   * Rows are split between the blocks of a fixed grid: a warp per row
//     for d <= 1024 (8 row groups a block), the whole block of 256 threads
//     per row above.  A row's two sums (x.x and gs.x) are reduced in f32 by
//     warp shuffles in a fixed butterfly order, then (a block per row) the
//     warps' partial sums by one warp in warp order.
//   * dscale without atomics.  Each thread owns fixed columns of its row
//     group and adds (g * x) * r of every row it visits, in row order, into
//     that group's f32 accumulator row in shared memory; at the end the
//     block sums its groups in group order into one f32 partial row of a
//     workspace (grid, d).  A second launch sums the partials column by
//     column in block order and casts once.  The grid depends on (rows, d)
//     alone, so the same inputs give the same bits on every run.
//   * 16-byte loads of x and g (8 bf16 or 4 f32 a thread) where d is a
//     multiple of the vector and both are 16-byte aligned with aligned row
//     strides; scalar accesses otherwise.  x and g may be strided views
//     (rows of a uniform stride, unit stride inside a row), so the strided
//     slice of MLA's 576-wide latent projection is read in place.
//   * The row is read twice (the sums, then dx and dscale): the second
//     read is served by L1/L2 (at most 2 x 16 KB a row at d = 4096 f32).
//   * Products rounded one at a time in the plain version's order.
// Not done yet: keeping the row in registers instead of the second read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / WARP;
constexpr int WARP_ROW_MAX_D = 1024;   // above this, one block per row
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;

template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Butterfly: at every step lanes i and i^off add the same two values, so
// all lanes end with the same sum.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = WARP / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The first pass's two partial sums over the elements thread t of nt owns:
// x.x and (g * scale).x.
template <typename TX, typename TS, bool VEC>
__device__ __forceinline__ void partial_sums(const TX* __restrict__ xr,
                                             const TX* __restrict__ gr,
                                             const TS* __restrict__ scale,
                                             int d, int t, int nt, float& ss,
                                             float& dt) {
  if constexpr (VEC) {
    constexpr int V = Pack<TX>::N;
    const Pack<TX>* xv = reinterpret_cast<const Pack<TX>*>(xr);
    const Pack<TX>* gv = reinterpret_cast<const Pack<TX>*>(gr);
    for (int i = t; i < d / V; i += nt) {
      const Pack<TX> xp = xv[i], gp = gv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = to_f32(xp.v[j]);
        ss = __fmaf_rn(x, x, ss);
        dt = __fmaf_rn(__fmul_rn(to_f32(gp.v[j]), to_f32(scale[i * V + j])),
                       x, dt);
      }
    }
  } else {
    for (int c = t; c < d; c += nt) {
      const float x = to_f32(xr[c]);
      ss = __fmaf_rn(x, x, ss);
      dt = __fmaf_rn(__fmul_rn(to_f32(gr[c]), to_f32(scale[c])), x, dt);
    }
  }
}

// One element of the second pass: returns dx and adds (g * x) * r to the
// column's accumulator.
template <typename TX, typename TS>
__device__ __forceinline__ TX dx_one(float xv, float gv, TS s, float r,
                                     float r3, float dot, float* acc) {
  const float gs = __fmul_rn(gv, to_f32(s));
  *acc = __fadd_rn(*acc, __fmul_rn(__fmul_rn(gv, xv), r));
  return from_f32<TX>(
      __fsub_rn(__fmul_rn(r, gs), __fmul_rn(__fmul_rn(xv, r3), dot)));
}

// Writes dx of the elements thread t of nt owns and adds their dscale
// terms into ``mine`` (the row group's accumulator row).
template <typename TX, typename TS, bool VEC>
__device__ __forceinline__ void write_row(const TX* __restrict__ xr,
                                          const TX* __restrict__ gr,
                                          const TS* __restrict__ scale,
                                          TX* __restrict__ dr, float* mine,
                                          int d, int t, int nt, float r,
                                          float r3, float dot) {
  if constexpr (VEC) {
    constexpr int V = Pack<TX>::N;
    const Pack<TX>* xv = reinterpret_cast<const Pack<TX>*>(xr);
    const Pack<TX>* gv = reinterpret_cast<const Pack<TX>*>(gr);
    Pack<TX>* ov = reinterpret_cast<Pack<TX>*>(dr);
    for (int i = t; i < d / V; i += nt) {
      const Pack<TX> xp = xv[i], gp = gv[i];
      Pack<TX> o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = i * V + j;
        o.v[j] = dx_one<TX>(to_f32(xp.v[j]), to_f32(gp.v[j]), scale[c], r,
                            r3, dot, mine + c);
      }
      ov[i] = o;
    }
  } else {
    for (int c = t; c < d; c += nt)
      dr[c] = dx_one<TX>(to_f32(xr[c]), to_f32(gr[c]), scale[c], r, r3, dot,
                         mine + c);
  }
}

// TPR threads per row: WARP (8 row groups a block) or NTHREADS (one).
template <typename TX, typename TS, bool VEC, int TPR>
__global__ void __launch_bounds__(NTHREADS)
    rmsnorm_bwd_rows(const TX* __restrict__ x, long long sx,
                     const TX* __restrict__ g, long long sg,
                     const TS* __restrict__ scale, TX* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int d,
                     float eps) {
  constexpr int G = NTHREADS / TPR;
  extern __shared__ float acc[];          // [G][d]
  __shared__ float part[2][WARPS];
  __shared__ float total[2];
  const int grp = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  for (int i = threadIdx.x; i < G * d; i += NTHREADS) acc[i] = 0.f;
  __syncthreads();
  float* mine = acc + grp * d;
  const long long step = static_cast<long long>(gridDim.x) * G;
  // every thread of a block walks the same number of rows when TPR is the
  // block (the barriers below); a warp's rows are its own otherwise
  for (long long row = static_cast<long long>(blockIdx.x) * G + grp;
       row < rows; row += step) {
    const TX* xr = x + row * sx;
    const TX* gr = g + row * sg;
    float ss = 0.f, dt = 0.f;
    partial_sums<TX, TS, VEC>(xr, gr, scale, d, t, TPR, ss, dt);
    ss = warp_sum(ss);
    dt = warp_sum(dt);
    if constexpr (TPR == NTHREADS) {
      if (lane == 0) {
        part[0][warp] = ss;
        part[1][warp] = dt;
      }
      __syncthreads();
      if (warp == 0) {
        const float a = warp_sum(lane < WARPS ? part[0][lane] : 0.f);
        const float b = warp_sum(lane < WARPS ? part[1][lane] : 0.f);
        if (lane == 0) {
          total[0] = a;
          total[1] = b;
        }
      }
      __syncthreads();
      ss = total[0];
      dt = total[1];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float r3 = __fmul_rn(__fmul_rn(r, r), r);
    const float dot = dt / static_cast<float>(d);
    write_row<TX, TS, VEC>(xr, gr, scale, dx + row * d, mine, d, t, TPR, r,
                           r3, dot);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) s = __fadd_rn(s, acc[k * d + c]);
    partial[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

// dscale[c] = sum over b in order of partial[b][c], cast once.
template <typename TS>
__global__ void __launch_bounds__(NTHREADS)
    rmsnorm_bwd_dscale(const float* __restrict__ partial, int blocks, int d,
                       TS* __restrict__ dscale) {
  const int c = blockIdx.x * NTHREADS + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b)
    s = __fadd_rn(s, partial[static_cast<long long>(b) * d + c]);
  dscale[c] = from_f32<TS>(s);
}

template <typename TX, typename TS, bool VEC, int TPR>
int launch_rows(const TX* x, long long sx, const TX* g, long long sg,
                const TS* s, TX* dx, float* partial, long long rows, int d,
                int blocks, float eps, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (NTHREADS / TPR) * d;
  auto kernel = rmsnorm_bwd_rows<TX, TS, VEC, TPR>;
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<blocks, NTHREADS, smem, stream>>>(x, sx, g, sg, s, dx, partial,
                                             rows, d, eps);
  return int(cudaGetLastError());
}

template <typename TX, typename TS>
int launch(const void* xp, long long sx, const void* gp, long long sg,
           const void* sp, void* dxp, float* partial, void* dsp,
           long long rows, int d, int blocks, float eps,
           cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xp);
  const TX* g = static_cast<const TX*>(gp);
  const TS* s = static_cast<const TS*>(sp);
  TX* dx = static_cast<TX*>(dxp);
  constexpr int V = Pack<TX>::N;
  const bool vec = d % V == 0 && sx % V == 0 && sg % V == 0 &&
                   reinterpret_cast<uintptr_t>(xp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gp) % 16 == 0;
  int err;
  if (d <= WARP_ROW_MAX_D)
    err = vec ? launch_rows<TX, TS, true, WARP>(x, sx, g, sg, s, dx, partial,
                                                rows, d, blocks, eps, stream)
              : launch_rows<TX, TS, false, WARP>(x, sx, g, sg, s, dx,
                                                 partial, rows, d, blocks,
                                                 eps, stream);
  else
    err = vec ? launch_rows<TX, TS, true, NTHREADS>(x, sx, g, sg, s, dx,
                                                    partial, rows, d, blocks,
                                                    eps, stream)
              : launch_rows<TX, TS, false, NTHREADS>(x, sx, g, sg, s, dx,
                                                     partial, rows, d,
                                                     blocks, eps, stream);
  if (err != 0) return err;
  rmsnorm_bwd_dscale<TS><<<(d + NTHREADS - 1) / NTHREADS, NTHREADS, 0,
                           stream>>>(partial, blocks, d,
                                     static_cast<TS*>(dsp));
  return int(cudaGetLastError());
}

}  // namespace

// x: (rows, d) of x_dtype, row stride sx elements, unit stride inside a
// row; g likewise (stride sg), in x_dtype; scale: (d,) contiguous, of
// s_dtype; dx: (rows, d) contiguous, of x_dtype; partial: (blocks, d)
// float32 workspace; dscale: (d,) of s_dtype.  Dtype codes: 0 = float32,
// 1 = bfloat16.  Two launches on the stream; returns the first failing
// launch's cudaError_t, or 0.
extern "C" int repro_rmsnorm_bwd(const void* x, long long sx, const void* g,
                                 long long sg, const void* scale, void* dx,
                                 float* partial, void* dscale,
                                 long long rows, int d, int blocks,
                                 int x_dtype, int s_dtype, float eps,
                                 void* stream) {
  if (rows < 1 || d < 1 || blocks < 1 || sx < d || sg < d)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, sx, g, sg, scale, dx, partial, dscale,
                                rows, d, blocks, eps, st);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, sx, g, sg, scale, dx, partial,
                                        dscale, rows, d, blocks, eps, st);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, sx, g, sg, scale, dx, partial,
                                        dscale, rows, d, blocks, eps, st);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, sx, g, sg, scale, dx,
                                                partial, dscale, rows, d,
                                                blocks, eps, st);
  return int(cudaErrorInvalidValue);
}
