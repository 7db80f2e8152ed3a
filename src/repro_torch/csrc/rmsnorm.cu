// RMSNorm forward for Hopper (sm_90a), CUDA C++ with a plain C entry point
// bound through ctypes (repro_torch/kernels/rmsnorm.py).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py: rmsnorm_fwd ->
// _rmsnorm_kernel.  Row by row over x viewed as (rows, d):
//   out = (x * rsqrt(mean(x^2) + eps)) * scale    in f32, cast to x's dtype
// with x in bf16 or f32 and scale (d,) in bf16 or f32.
//
// What bounds it on the H100: bytes.  A row reads d elements and writes d
// and does ~4d flops, so at 3.35 TB/s against 67 TFLOP/s (f32) the bytes
// take ~10-40x longer than the arithmetic.  At decode shapes (8 to 256
// rows) the launch itself dominates.
// Design:
//   * One warp per row for d <= 1024 (8 rows per block of 256 threads);
//     one block of 256 threads per row above that.  A row's sum of squares
//     never leaves its block: one pass, no atomics, no second launch.  (The
//     TPU kernel tiles 256 rows x d into VMEM; here a row is the unit.)
//   * 16-byte loads and stores (8 bf16 or 4 f32 a thread) where d is a
//     multiple of the vector and x and out are 16-byte aligned, scalar
//     accesses otherwise.
//   * The sum of squares in f32, reduced by warp shuffles in a fixed
//     butterfly order, then (one block per row) the warps' partial sums by
//     one warp in warp order: the result does not depend on timing, so the
//     same input gives the same bits on every run.
//   * The row is read a second time to write it (from L1/L2: at most 16 KB
//     a row); nothing is written before the row's norm is known.
//   * Products rounded one at a time in the plain version's order,
//     (x * r) * scale, then one rounding to x's dtype.
// Not done yet: keeping the row in registers instead of the second read;
// fusing the norm into the projection that follows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int NTHREADS = 256;
constexpr int WARPS = NTHREADS / WARP;
constexpr int WARP_ROW_MAX_D = 1024;   // above this, one block per row

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

// Sum of squares of the elements thread t of nt owns in row xr.
template <typename TX, bool VEC>
__device__ __forceinline__ float partial_sumsq(const TX* __restrict__ xr,
                                               int d, int t, int nt) {
  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int V = Pack<TX>::N;
    const Pack<TX>* xv = reinterpret_cast<const Pack<TX>*>(xr);
    for (int i = t; i < d / V; i += nt) {
      const Pack<TX> pk = xv[i];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_f32(pk.v[j]);
        ss = __fmaf_rn(v, v, ss);
      }
    }
  } else {
    for (int i = t; i < d; i += nt) {
      const float v = to_f32(xr[i]);
      ss = __fmaf_rn(v, v, ss);
    }
  }
  return ss;
}

template <typename TX, typename TS>
__device__ __forceinline__ TX norm_one(TX x, TS s, float r) {
  return from_f32<TX>(__fmul_rn(__fmul_rn(to_f32(x), r), to_f32(s)));
}

// Writes the elements thread t of nt owns: (x * r) * scale.
template <typename TX, typename TS, bool VEC>
__device__ __forceinline__ void write_row(const TX* __restrict__ xr,
                                          const TS* __restrict__ scale,
                                          TX* __restrict__ orow, int d,
                                          float r, int t, int nt) {
  if constexpr (VEC) {
    constexpr int V = Pack<TX>::N;
    const Pack<TX>* xv = reinterpret_cast<const Pack<TX>*>(xr);
    Pack<TX>* ov = reinterpret_cast<Pack<TX>*>(orow);
    for (int i = t; i < d / V; i += nt) {
      const Pack<TX> pk = xv[i];
      Pack<TX> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = norm_one(pk.v[j], scale[i * V + j], r);
      ov[i] = o;
    }
  } else {
    for (int i = t; i < d; i += nt) orow[i] = norm_one(xr[i], scale[i], r);
  }
}

template <typename TX, typename TS, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    rmsnorm_warp_rows(const TX* __restrict__ x, const TS* __restrict__ scale,
                      TX* __restrict__ out, long long rows, int d,
                      float eps) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (row >= rows) return;                 // the whole warp leaves together
  const TX* xr = x + row * d;
  const float ss = warp_sum(partial_sumsq<TX, VEC>(xr, d, lane, WARP));
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  write_row<TX, TS, VEC>(xr, scale, out + row * d, d, r, lane, WARP);
}

template <typename TX, typename TS, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
    rmsnorm_block_rows(const TX* __restrict__ x, const TS* __restrict__ scale,
                       TX* __restrict__ out, int d, float eps) {
  __shared__ float part[WARPS];
  __shared__ float total;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long row = blockIdx.x;
  const TX* xr = x + row * d;
  const float ss =
      warp_sum(partial_sumsq<TX, VEC>(xr, d, threadIdx.x, NTHREADS));
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const float v = warp_sum(lane < WARPS ? part[lane] : 0.f);
    if (lane == 0) total = v;
  }
  __syncthreads();
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
  write_row<TX, TS, VEC>(xr, scale, out + row * d, d, r, threadIdx.x,
                         NTHREADS);
}

template <typename TX, typename TS>
int launch(const void* xp, const void* sp, void* op, long long rows, int d,
           float eps, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xp);
  const TS* s = static_cast<const TS*>(sp);
  TX* out = static_cast<TX*>(op);
  const bool vec = d % Pack<TX>::N == 0 &&
                   reinterpret_cast<uintptr_t>(xp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(op) % 16 == 0;
  if (d <= WARP_ROW_MAX_D) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(blocks));
    if (vec)
      rmsnorm_warp_rows<TX, TS, true>
          <<<grid, NTHREADS, 0, stream>>>(x, s, out, rows, d, eps);
    else
      rmsnorm_warp_rows<TX, TS, false>
          <<<grid, NTHREADS, 0, stream>>>(x, s, out, rows, d, eps);
  } else {
    if (rows > 0x7fffffffLL) return int(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(rows));
    if (vec)
      rmsnorm_block_rows<TX, TS, true>
          <<<grid, NTHREADS, 0, stream>>>(x, s, out, d, eps);
    else
      rmsnorm_block_rows<TX, TS, false>
          <<<grid, NTHREADS, 0, stream>>>(x, s, out, d, eps);
  }
  return int(cudaGetLastError());
}

}  // namespace

// x, out: (rows, d) contiguous, of x_dtype; scale: (d,) contiguous, of
// s_dtype.  Dtype codes: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t.
extern "C" int repro_rmsnorm_fwd(const void* x, const void* scale, void* out,
                                 long long rows, int d, int x_dtype,
                                 int s_dtype, float eps, void* stream) {
  if (rows < 1 || d < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, st);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, st);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, st);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                                st);
  return int(cudaErrorInvalidValue);
}
