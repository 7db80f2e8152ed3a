// Max-plus (tropical) convolutions on Hopper: the Unicron planner's DP step.
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/maxplus.py:
//   maxplus_conv          (_maxplus_kernel)          out[j] = max_{k<=min(j,band)} prev[j-k] + g[k]
//   maxplus_conv_batched  (_maxplus_batched_kernel)  B rows, each with its own band
//   maxplus_scan_chunk    (_maxplus_scan_kernel)     out[r,j] = max_{k<K} wins[r,j+K-1-k] + gs[r,k]
//
// All three are one computation: out[j] = max_{k<kc} src[j + base - k] + g[k],
// with src read as -inf outside [0, src_len).  conv: base 0, kc = band+1;
// scan chunk: base K-1, kc = K.  One thread owns one output cell of one row;
// the grid is (ceil(n1 / BLOCK), rows).  The block stages the src span its
// cells read and the g values of a tile of k in shared memory, then folds
// acc = fmax(acc, w + g[k]) over the tile.  A row's band is a loop bound
// (the batched kernel reads bands[r]): no -inf-masked copy of g is built.
//
// Bitwise contract: each candidate is one IEEE add (no multiply, so nothing
// is contracted into an FMA) and max is exact and order-free, so every
// output equals the plain PyTorch version (repro_torch/kernels/ref.py) bit
// for bit in float32 and float64.  fmax returns the non-NaN operand where
// torch.maximum propagates NaN; the planner's inputs are never NaN (-inf at
// most, and -inf + finite = -inf), so the two agree on every input it gives.
//
// Bound: at the planner's sizes (n1 ~ 1e3, B <= 64, band ~ 16) a launch does
// a few microseconds of work, so launch latency and the host round trip of
// each level bound it.  Otherwise it is 2*B*n1*(band+1) add+max operations
// against 33.5 TFLOP/s (fp64; 67 f32) and (2*n1+band+1)*B*8 bytes against
// 3.35 TB/s, i.e. operation-bound once band+1 exceeds ~20 in fp64.  The
// design keeps every candidate out of device memory (one load per staged
// element, then shared-memory reads) and sizes the k tile to the band, so a
// narrow band stages only BLOCK+band elements per block.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BLOCK = 256;   // output cells per block (one per thread)
constexpr int TK = 256;      // k values per staged tile

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return -CUDART_INF_F; }
template <> __device__ __forceinline__ double neg_inf<double>() { return -CUDART_INF; }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

// out[j] = max_{0 <= k < kc} src[j + base - k] + g[k] for the BLOCK cells
// j0 .. j0+BLOCK-1 of one row (j < n1 written).
template <typename T>
__device__ void fold_row(const T* __restrict__ src, long long src_len,
                         const T* __restrict__ g, T* __restrict__ out,
                         int n1, int base, int kc) {
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
      w[t] = (idx >= 0 && idx < src_len) ? src[idx] : neg_inf<T>();
    }
    for (int t = tid; t < tk; t += BLOCK) gt[t] = g[k0 + t];
    __syncthreads();
    const T* wp = w + tid + tk - 1;
#pragma unroll 8
    for (int kk = 0; kk < tk; ++kk) acc = vmax(acc, wp[-kk] + gt[kk]);
    __syncthreads();
  }
  const long long j = j0 + tid;
  if (j < n1) out[j] = acc;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_conv_kernel(const T* __restrict__ prev, const T* __restrict__ g,
                    T* __restrict__ out, int n1, int band) {
  fold_row<T>(prev, n1, g, out, n1, 0, band + 1);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_conv_batched_kernel(const T* __restrict__ prev,
                            const T* __restrict__ g,
                            const int* __restrict__ bands,
                            T* __restrict__ out, int n1) {
  const long long r = blockIdx.y;
  fold_row<T>(prev + r * n1, n1, g + r * n1, out + r * n1, n1, 0,
              bands[r] + 1);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
maxplus_scan_chunk_kernel(const T* __restrict__ wins,
                          const T* __restrict__ gs, T* __restrict__ out,
                          int n1, int K) {
  const long long r = blockIdx.y;
  const long long wlen = (long long)n1 + K - 1;
  fold_row<T>(wins + r * wlen, wlen, gs + r * K, out + r * n1, n1, K - 1, K);
}

dim3 grid_for(int n1, int rows) {
  return dim3((unsigned)((n1 + BLOCK - 1) / BLOCK), (unsigned)rows);
}

template <typename T>
int conv(const T* prev, const T* g, T* out, int n1, int band, void* stream) {
  maxplus_conv_kernel<T><<<grid_for(n1, 1), BLOCK, 0,
                           (cudaStream_t)stream>>>(prev, g, out, n1, band);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_batched(const T* prev, const T* g, const int* bands, T* out, int B,
                 int n1, void* stream) {
  maxplus_conv_batched_kernel<T><<<grid_for(n1, B), BLOCK, 0,
                                   (cudaStream_t)stream>>>(prev, g, bands,
                                                           out, n1);
  return (int)cudaGetLastError();
}

template <typename T>
int scan_chunk(const T* wins, const T* gs, T* out, int B, int n1, int K,
               void* stream) {
  maxplus_scan_chunk_kernel<T><<<grid_for(n1, B), BLOCK, 0,
                                 (cudaStream_t)stream>>>(wins, gs, out, n1,
                                                         K);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  Pointers are device pointers to contiguous
// row-major arrays; `bands` is a device int32 array of B clamped bands
// (0 <= band <= n1-1).  Each returns cudaGetLastError() after its launch.
extern "C" {

int repro_maxplus_conv_f32(const float* prev, const float* g, float* out,
                           int n1, int band, void* stream) {
  return conv<float>(prev, g, out, n1, band, stream);
}
int repro_maxplus_conv_f64(const double* prev, const double* g, double* out,
                           int n1, int band, void* stream) {
  return conv<double>(prev, g, out, n1, band, stream);
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

}  // extern "C"
