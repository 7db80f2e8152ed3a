// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// entry point bound through ctypes
// (repro_torch/kernels/flash_attention_bwd.py).
//
// Replaces repro/models/flash_vjp.py:_bwd_blocked, the backward of the JAX
// package's `kernel="flash"` attention.  That function is pure jnp, not a
// TPU kernel: it is the custom VJP whose forward saves only (o, lse), so
// nothing of size O(Sq * Sk) reaches device memory.  Same function: from q,
// k, v, o, lse (csrc/flash_attention.cu writes it) and the output gradient
// dO, with s = q.k / sqrt(D) (tanh soft-capped where asked), P = exp(s - lse)
// on live (query, key) pairs and 0 elsewhere (causal and sliding-window
// masks with q_offset, keys past Sk; a row with no live key gives P = 0
// whatever its lse), Dvec = rowsum(dO * o),
//   dS = P (dP - Dvec) dcap / sqrt(D),  dP = dO V^T,
//   dcap = 1 - tanh^2(s_raw / softcap) with a soft-cap, else 1,
//   dq = dS K,  dk = dS^T Q,  dv = P^T dO,
// dk and dv summed over the G = H / KV query heads of each KV head (GQA,
// MQA).  The reference's two passes, each recomputing S and dP, so neither
// needs atomics or an (Sq, Sk) tensor.
//
// What bounds it on the H100: S and dP recomputed and the three products
// are at least 2 (3 D + 2 Dv) operations per live (query, key) pair
// against O(S (D + Dv)) bytes per (batch, head), so at the training shapes
// (S = 1024, D = 64..256) it is bound by operations at the bf16 tensor
// cores' 989 TFLOP/s: ~0.23 ms at deepseek-v3-671b's MLA shape (B = 2, S =
// 1024, H = KV = 128, D = 192, Dv = 128, causal; chip_smoke.py's
// attn_bwd_bound).  The two passes do 2 (4 D + 3 Dv) (S and dP twice).
// Two variants; the wrapper picks one (variant() in the Python module) and
// passes it here; the entry point checks that it takes the inputs and never
// substitutes the other:
//   * "wgmma" (namespace wg, the training path): bf16 at D = Dv in {64, 80,
//     128, 256} or D = 192 over Dv = 128, 16-byte aligned bases and
//     strides.  Every product on the tensor cores (wgmma, bf16 operands,
//     f32 sums), tiles brought by TMA into mbarrier rings, P and dS fed
//     from registers.  Its design note, the register split and the head
//     split are above the namespace.
//   * "cuda_core": everything else, f32 included: the first version (PR
//     24), 2 (4 D + 3 Dv) operations per pair on the CUDA cores in f32
//     (67 TFLOP/s peak).  What that design does about its bound: every
//     product reads its operands from shared memory, staged once per tile
//     as f32 and read as float4; one side of each dot product is a lane's
//     own row (rows padded so that 8 lanes' 16-byte reads hit 8 different
//     bank groups), the other a broadcast; P and dS never leave registers
//     (they are broadcast by shuffle into the accumulating products); dead
//     tiles are skipped from the mask's bounds.  Three kernels on one
//     stream:
//       - dvec_kernel: Dvec = rowsum(dO * o) per (batch, row, head), one
//         warp a row, into an f32 scratch the wrapper allocates.
//       - dq_kernel, grid (q tile of 32 rows, head, batch): loops over the
//         KV tiles of 32 keys the rows can see; lane j holds key j, each
//         warp 8 rows; dq for the block's rows accumulates in registers.
//       - dkdv_kernel, grid (KV tile, KV head, batch): loops over the q
//         tiles of 32 rows that can see its keys and over the G heads of
//         the group; lane i holds query row i, each warp KPW keys; dk and
//         dv accumulate in registers.
// No atomics in either variant: each output element is written by one
// thread of one block, or summed from per-block partials in a fixed order,
// so a gradient repeats bit for bit.  The C entry refuses inputs a variant
// cannot take (cudaErrorInvalidValue) before any launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int MAX_DEVICES = 64;

// Raises the kernel's dynamic shared-memory limit to `bytes` once per
// device (and again only if a later call needs more).
template <auto Kernel>
cudaError_t set_smem(size_t bytes) {
  static std::atomic<size_t> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return err;
  size_t seen = done[dev].load();
  while (seen < bytes && !done[dev].compare_exchange_weak(seen, bytes)) {
  }
  return cudaSuccess;
}

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BQ = 32;              // query rows per tile
constexpr int BK = 32;              // keys per tile of the dq pass
constexpr int ROWS = BQ / NWARPS;   // query rows per warp in the dq pass
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, Sq, H) contiguous
  float* dvec;        // (B, Sq, H) contiguous scratch
  void* dq;           // (B, Sq, H, D) contiguous
  void* dk;           // (B, Sk, KV, D) contiguous
  void* dv;           // (B, Sk, KV, Dv) contiguous
  int bf16;           // 0: float32, 1: bfloat16 (every tensor but lse, dvec)
  int B, Sq, Sk, H, KV, D, Dv;
  // strides in elements of dims 0..2 (batch, seq, head); dim 3 contiguous
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, os0, os1, os2, gs0,
      gs1, gs2;
  int causal, window, q_offset;
  float softcap, scale;
};

__device__ __forceinline__ float ld(const void* base, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}
__device__ __forceinline__ void st(void* base, long long i, float x,
                                   int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Row stride (floats) of a tile whose rows each lane reads as float4 at
// once: a multiple of 4 with an odd number of float4s, so the 8 lanes of
// one 128-byte phase fall on 8 different groups of 4 banks.
__host__ __device__ __forceinline__ int lane_stride(int d4) {
  return ((d4 >> 2) | 1) << 2;
}

__device__ __forceinline__ bool live(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  return ok;
}

// P and dS of one (query, key) pair from q.k, dO.v, the row's lse and Dvec.
__device__ __forceinline__ float dscore(const Params& p, float qk, float dp,
                                        float lse, float dvec, bool ok,
                                        float* prob) {
  float s = qk * p.scale, dcap = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(s / p.softcap);
    s = t * p.softcap;
    dcap = 1.f - t * t;
  }
  const float pr = ok ? expf(s - lse) : 0.f;
  *prob = pr;
  return pr * (dp - dvec) * dcap * p.scale;
}

// Copies rows [r0, r0 + n) of one (batch, head) of a (B, S, heads, width)
// tensor into an f32 tile of row stride `stride`, zero past `rows` and past
// `width` up to `width4`.
__device__ __forceinline__ void stage(float* dst, const void* src,
                                      long long base, long long s1, int r0,
                                      int n, int rows, int width, int width4,
                                      int stride, int bf16) {
  for (int i = threadIdx.x; i < n * width4; i += NTHREADS) {
    const int r = i / width4, c = i - r * width4, row = r0 + r;
    dst[r * stride + c] = row < rows && c < width
                              ? ld(src, base + row * s1 + c, bf16)
                              : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS) dvec_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + warp;
  if (row >= static_cast<long long>(p.B) * p.Sq * p.H) return;
  const int h = int(row % p.H);
  const long long bq = row / p.H;
  const int q = int(bq % p.Sq), b = int(bq / p.Sq);
  const long long oo = b * p.os0 + q * p.os1 + h * p.os2;
  const long long go = b * p.gs0 + q * p.gs1 + h * p.gs2;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32)
    acc += ld(p.o, oo + c, p.bf16) * ld(p.dout, go + c, p.bf16);
  acc = warp_sum(acc);
  if (lane == 0) p.dvec[row] = acc;
}

// ND = 32-wide column groups of D held per lane (2 * ceil(D / 64)).
template <int ND>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, Dv = p.Dv;
  const int D4 = (D + 3) & ~3, Dv4 = (Dv + 3) & ~3;
  const int KS = lane_stride(D4), VS = lane_stride(Dv4);
  float* sQ = smem;             // BQ x D4, rows read as broadcasts
  float* sG = sQ + BQ * D4;     // BQ x Dv4: dO
  float* sK = sG + BQ * Dv4;    // BK x KS, row j read by lane j
  float* sV = sK + BK * KS;     // BK x VS

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  stage(sQ, p.q, b * p.qs0 + h * p.qs2, p.qs1, q0, BQ, p.Sq, D, D4, D4,
        p.bf16);
  stage(sG, p.dout, b * p.gs0 + h * p.gs2, p.gs1, q0, BQ, p.Sq, Dv, Dv4, Dv4,
        p.bf16);

  float lse[ROWS], dvec[ROWS], acc[ROWS][ND];
  int qpos[ROWS];
  bool qok[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + warp * ROWS + r;
    qok[r] = q < p.Sq;
    qpos[r] = p.q_offset + q;
    const long long i = (static_cast<long long>(b) * p.Sq + q) * p.H + h;
    lse[r] = qok[r] ? p.lse[i] : 0.f;
    dvec[r] = qok[r] ? p.dvec[i] : 0.f;
#pragma unroll
    for (int t = 0; t < ND; ++t) acc[r][t] = 0.f;
  }

  // KV tiles that can hold a live key for some row of this block
  const int q_lo = p.q_offset + q0, q_hi = q_lo + BQ - 1;
  int kt_begin = 0, kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = q_hi < 0 ? 0 : min(kt_end, q_hi / BK + 1);
  if (p.window > 0) {
    const int first = q_lo - p.window + 1;  // first key the top row sees
    if (first > 0) kt_begin = first / BK;
  }

  const float4* qrow[ROWS];
  const float4* grow[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    qrow[r] = reinterpret_cast<const float4*>(sQ + (warp * ROWS + r) * D4);
    grow[r] = reinterpret_cast<const float4*>(sG + (warp * ROWS + r) * Dv4);
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage(sK, p.k, b * p.ks0 + kvh * p.ks2, p.ks1, k0, BK, p.Sk, D, D4, KS,
          p.bf16);
    stage(sV, p.v, b * p.vs0 + kvh * p.vs2, p.vs1, k0, BK, p.Sk, Dv, Dv4, VS,
          p.bf16);
    __syncthreads();

    // s[r] = q[row r] . k[key lane]; dp[r] = dO[row r] . v[key lane]
    float s[ROWS], dp[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sK + lane * KS);
    for (int d = 0; d < D4 / 4; ++d) {
      const float4 kd = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += dot4(qrow[r][d], kd);
    }
    const float4* vrow = reinterpret_cast<const float4*>(sV + lane * VS);
    for (int d = 0; d < Dv4 / 4; ++d) {
      const float4 vd = vrow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dp[r] += dot4(grow[r][d], vd);
    }

    float ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float pr;
      ds[r] = dscore(p, s[r], dp[r], lse[r], dvec[r],
                     qok[r] && live(p, qpos[r], k0 + lane), &pr);
    }

    // dq[r][c] += sum_j ds[r][j] k[j][c]; ds[r][j] lives in lane j
    for (int j = 0; j < BK; ++j) {
      float dj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dj[r] = __shfl_sync(FULL, ds[r], j);
      const float* kr = sK + j * KS;
#pragma unroll
      for (int t = 0; t < ND; ++t) {
        const int c = lane + 32 * t;
        const float kc = c < D ? kr[c] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][t] += dj[r] * kc;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (!qok[r]) continue;
    const long long row =
        (static_cast<long long>(b) * p.Sq + q0 + warp * ROWS + r) * p.H + h;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int c = lane + 32 * t;
      if (c < D) st(p.dq, row * D + c, acc[r][t], p.bf16);
    }
  }
}

// Keys per warp of the dk, dv pass: 8 where the accumulators are small,
// else 4 (dk and dv take KPW * (ND + NDV) registers a lane).
template <int ND, int NDV>
struct Dkdv {
  static constexpr int KPW = ND + NDV <= 8 ? 8 : 4;
  static constexpr int BKV = NWARPS * KPW;  // keys per block
};

template <int ND, int NDV>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const Params p) {
  constexpr int KPW = Dkdv<ND, NDV>::KPW, BKV = Dkdv<ND, NDV>::BKV;
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, Dv = p.Dv;
  const int D4 = (D + 3) & ~3, Dv4 = (Dv + 3) & ~3;
  const int QS = lane_stride(D4), GS = lane_stride(Dv4);
  float* sK = smem;              // BKV x D4, rows read as broadcasts
  float* sV = sK + BKV * D4;     // BKV x Dv4
  float* sQ = sV + BKV * Dv4;    // BQ x QS, row i read by lane i
  float* sG = sQ + BQ * QS;      // BQ x GS: dO
  float* sL = sG + BQ * GS;      // BQ: lse
  float* sD = sL + BQ;           // BQ: Dvec

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;

  stage(sK, p.k, b * p.ks0 + kvh * p.ks2, p.ks1, k0, BKV, p.Sk, D, D4, D4,
        p.bf16);
  stage(sV, p.v, b * p.vs0 + kvh * p.vs2, p.vs1, k0, BKV, p.Sk, Dv, Dv4, Dv4,
        p.bf16);

  float dk[KPW][ND], dv[KPW][NDV];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
#pragma unroll
    for (int t = 0; t < ND; ++t) dk[j][t] = 0.f;
#pragma unroll
    for (int t = 0; t < NDV; ++t) dv[j][t] = 0.f;
  }
  const int key0 = k0 + warp * KPW;  // this warp's first key

  // q tiles whose rows can see a key of this block: causal needs
  // q_offset + q >= k0, a window q_offset + q < k_hi + window
  const int k_hi = min(k0 + BKV, p.Sk) - 1;
  int q_begin = 0, q_end = p.Sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) q_end = min(q_end, max(0, k_hi + p.window - p.q_offset));
  const int qt_begin = q_begin / BQ;
  const int qt_end = q_end > q_begin ? (q_end + BQ - 1) / BQ : qt_begin;

  const float4* krow[KPW];
  const float4* vrow[KPW];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    krow[j] = reinterpret_cast<const float4*>(sK + (warp * KPW + j) * D4);
    vrow[j] = reinterpret_cast<const float4*>(sV + (warp * KPW + j) * Dv4);
  }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BQ;
    const int q = q0 + lane, qpos = p.q_offset + q;
    const bool qok = q < p.Sq;
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      __syncthreads();  // the previous tile's rows are no longer read
      stage(sQ, p.q, b * p.qs0 + h * p.qs2, p.qs1, q0, BQ, p.Sq, D, D4, QS,
            p.bf16);
      stage(sG, p.dout, b * p.gs0 + h * p.gs2, p.gs1, q0, BQ, p.Sq, Dv, Dv4,
            GS, p.bf16);
      if (threadIdx.x < BQ) {
        const long long i = (static_cast<long long>(b) * p.Sq + q) * p.H + h;
        sL[lane] = qok ? p.lse[i] : 0.f;
        sD[lane] = qok ? p.dvec[i] : 0.f;
      }
      __syncthreads();

      // s[j] = q[row lane] . k[key j]; dp[j] = dO[row lane] . v[key j]
      float s[KPW], dp[KPW];
#pragma unroll
      for (int j = 0; j < KPW; ++j) s[j] = dp[j] = 0.f;
      const float4* qr = reinterpret_cast<const float4*>(sQ + lane * QS);
      for (int d = 0; d < D4 / 4; ++d) {
        const float4 qd = qr[d];
#pragma unroll
        for (int j = 0; j < KPW; ++j) s[j] += dot4(qd, krow[j][d]);
      }
      const float4* gr = reinterpret_cast<const float4*>(sG + lane * GS);
      for (int d = 0; d < Dv4 / 4; ++d) {
        const float4 gd = gr[d];
#pragma unroll
        for (int j = 0; j < KPW; ++j) dp[j] += dot4(gd, vrow[j][d]);
      }

      float pr[KPW], ds[KPW];
      const float l = sL[lane], dvv = sD[lane];
#pragma unroll
      for (int j = 0; j < KPW; ++j)
        ds[j] = dscore(p, s[j], dp[j], l, dvv,
                       qok && live(p, qpos, key0 + j), &pr[j]);

      // dv[j][c] += sum_i P[i][j] dO[i][c]; dk[j][c] += sum_i dS[i][j]
      // q[i][c]; P[i][j] and dS[i][j] live in lane i
      for (int i = 0; i < BQ; ++i) {
        float pi[KPW], di[KPW];
#pragma unroll
        for (int j = 0; j < KPW; ++j) {
          pi[j] = __shfl_sync(FULL, pr[j], i);
          di[j] = __shfl_sync(FULL, ds[j], i);
        }
        const float* gi = sG + i * GS;
        const float* qi = sQ + i * QS;
#pragma unroll
        for (int t = 0; t < NDV; ++t) {
          const int c = lane + 32 * t;
          const float x = c < Dv ? gi[c] : 0.f;
#pragma unroll
          for (int j = 0; j < KPW; ++j) dv[j][t] += pi[j] * x;
        }
#pragma unroll
        for (int t = 0; t < ND; ++t) {
          const int c = lane + 32 * t;
          const float x = c < D ? qi[c] : 0.f;
#pragma unroll
          for (int j = 0; j < KPW; ++j) dk[j][t] += di[j] * x;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int key = key0 + j;
    if (key >= p.Sk) continue;
    const long long row =
        (static_cast<long long>(b) * p.Sk + key) * p.KV + kvh;
#pragma unroll
    for (int t = 0; t < ND; ++t) {
      const int c = lane + 32 * t;
      if (c < D) st(p.dk, row * D + c, dk[j][t], p.bf16);
    }
#pragma unroll
    for (int t = 0; t < NDV; ++t) {
      const int c = lane + 32 * t;
      if (c < Dv) st(p.dv, row * Dv + c, dv[j][t], p.bf16);
    }
  }
}

// 2 * ceil(n / 64): the 32-wide column groups a lane holds for width n
int groups(int n) { return 2 * ((n + 63) / 64); }

template <int ND>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const int D4 = (p.D + 3) & ~3, Dv4 = (p.Dv + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t(BQ) * (D4 + Dv4) +
                                       size_t(BK) * (lane_stride(D4) +
                                                     lane_stride(Dv4)));
  cudaError_t err = set_smem<dq_kernel<ND>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  dq_kernel<ND><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ND, int NDV>
cudaError_t launch_dkdv(const Params& p, cudaStream_t stream) {
  constexpr int BKV = Dkdv<ND, NDV>::BKV;
  const int D4 = (p.D + 3) & ~3, Dv4 = (p.Dv + 3) & ~3;
  const size_t smem =
      sizeof(float) * (size_t(BKV) * (D4 + Dv4) +
                       size_t(BQ) * (lane_stride(D4) + lane_stride(Dv4)) +
                       2 * BQ);
  cudaError_t err = set_smem<dkdv_kernel<ND, NDV>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BKV - 1) / BKV, p.KV, p.B);
  dkdv_kernel<ND, NDV><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int ND>
cudaError_t dispatch_dkdv(const Params& p, cudaStream_t stream) {
  switch (groups(p.Dv)) {
    case 2: return launch_dkdv<ND, 2>(p, stream);
    case 4: return launch_dkdv<ND, 4>(p, stream);
    case 6: return launch_dkdv<ND, 6>(p, stream);
    case 8: return launch_dkdv<ND, 8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  dvec_kernel<<<dim3(unsigned((rows + NWARPS - 1) / NWARPS)), NTHREADS, 0,
                stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (groups(p.D)) {
    case 2: err = launch_dq<2>(p, stream); break;
    case 4: err = launch_dq<4>(p, stream); break;
    case 6: err = launch_dq<6>(p, stream); break;
    case 8: err = launch_dq<8>(p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (groups(p.D)) {
    case 2: return dispatch_dkdv<2>(p, stream);
    case 4: return dispatch_dkdv<4>(p, stream);
    case 6: return dispatch_dkdv<6>(p, stream);
    case 8: return dispatch_dkdv<8>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// 16-byte aligned base and (batch, seq, head) strides of a bf16 tensor.
bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

// ---------------------------------------------------------------------------
// bf16 on the warpgroup tensor cores (wgmma), TMA loads, warp specialisation
// ---------------------------------------------------------------------------
//
// The training path's backward.  Every tile is 64 rows (query rows or keys)
// by the head width, stored as one TMA box per 64 columns: 64 rows of 128
// bytes in the 128-byte swizzle that wgmma reads (the forward's layout,
// csrc/flash_attention.cu).  Four kernels a call, on one stream:
//   * rowstat_kernel: each row's lse (in log2 units) and Dvec = rowsum(dO o)
//     into a (2, B, H, Sq_pad) f32 scratch, rows past Sq zero: the dk, dv
//     pass reads the 64 values of a q tile as one 256-byte bulk copy.
//   * dq_wgmma_kernel, grid (head, batch, q tile of 64 rows; the q tiles
//     reversed, so under a causal mask the heaviest start first): a
//     producer warpgroup (one thread issues the TMA loads: Q and dO once,
//     then K and V tiles of 64 keys into an mbarrier ring) and one
//     consumer warpgroup; two blocks an SM where D, Dv <= 128 (the
//     producer gives its registers to the consumer through setmaxnreg).
//     Per KV tile: S = Q K^T and dP = dO V^T as
//     wgmma.m64n64k16 with both operands K-major in shared memory; P =
//     exp2(s scale log2(e) - lse2), the mask only on tiles that cross an
//     edge, the soft-cap's dcap; dS = P (dP - Dvec) dcap scale, rounded
//     to bf16 and fed from registers as the A fragment (the S accumulator
//     pairs of n-blocks 2j and 2j + 1 are the A fragment of key chunk j,
//     as the forward feeds P); dQ += dS K with K as an MN-major B (the
//     transpose bit), one wgmma per 64 columns of D.  dQ stays in
//     registers (128 f32 a lane at D = 256).  Software-pipelined as the
//     forward is (S and dP of tile it + 1 issued with dQ of tile it, and
//     tile it + 1's dS computed while that dQ product runs), except at D
//     = 256, where the pipeline's registers spill.
//   * dkdv_wgmma_kernel, grid (KV head x head split, batch, KV tile of 64
//     keys): a producer warpgroup loads K and V once, then per (head of the
//     block's share of the group, q tile) Q, dO and the tile's lse and Dvec
//     into a two-slot ring.  Two consumer warpgroups share the 64 keys and
//     split the work by output (the register split): "V" computes S^T =
//     K Q^T, P^T (lse per column, from shared memory), hands P dcap to "K"
//     through shared memory (f32, two buffers, named barriers), and
//     accumulates dV += P^T dO; "K" computes dP^T = V dO^T, dS^T = P dcap
//     (dP^T - Dvec) scale, and accumulates dK += dS^T Q (dO and Q as
//     MN-major B).  Computing S and dP transposed puts P^T and dS^T in the
//     accumulator layout that wgmma takes as A.  Each warpgroup does D + Dv
//     multiply-adds per pair, so neither waits long for the other, and
//     each holds one accumulator: dV or dK, 128 f32 a lane at D = Dv =
//     256, 96 at MLA's D = 192 (setmaxnreg: producer 40, consumers 232).
//   * reduce_kernel, only with a head split: the split's f32 partial dK
//     and dV summed in split order, written as bf16.
// Widths: D = Dv in {64, 128, 256}, D = Dv = 80 and D = 192 over Dv = 128.
// A row of 80 is read as two boxes, the second zero-filled past column 80
// by TMA, so D = 80 runs as a padded 128 where D is the product's output
// width (dQ, dK, dV: 1.6x their multiply-adds) and at its own 80 where D
// is the summed dimension (S and dP: five k-steps of 16).
// Head split (MQA, GQA): without one, gemma-2b's dk, dv grid (KV = 1) is 32
// blocks on 132 SMs.  The wrapper picks the smallest divisor `split` of
// the group G = H / KV that gives a full wave (kernels.flash_attention_bwd.
// plan); each block then takes G / split heads and writes its f32 partial
// dK and dV into a workspace (split x B x Sk x KV x (D + Dv) f32: 33.5 MB
// at gemma-2b's training shape, 8-way) that reduce_kernel sums in a fixed
// order.  No atomics anywhere, so dq, dk and dv repeat bit for bit.
// No wgmma sits under a branch the compiler cannot prove warp-uniform
// (roles and warps come through a shuffle from lane 0; the mbarrier poll is
// one asm block), else ptxas serialises it (C7520).
// Chosen on an H100 80GB HBM3 at 700 W by graph time at the seven
// training shapes (chip_smoke.py's BWD_SHAPES), configurations built side
// by side: two dq blocks an SM with the pipeline cut the dq pass by a
// third to a half at D <= 128 (PERF.md).  Tried and not kept, as no
// faster: four ring slots instead of two in either pass; the pipeline with
// two slots (each load's latency shows); the pipeline in the dk, dv pass
// (it spills at D = 256); "K" recomputing S^T and P itself instead of the
// hand-over.  What is left: the dk, dv pass spends a few microseconds per
// 64 x 64 item whatever the width, far from the tensor cores' peak, and is
// the larger pass at every shape.

namespace wg {

constexpr int BM = 64;            // rows of every tile: query rows or keys
constexpr int ROW = 128;          // bytes of one swizzled box row: 64 bf16
constexpr int BOX = BM * ROW;     // bytes of one 64 x 64 box
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DQ_THREADS = 256;   // producer + one consumer warpgroup
constexpr int KV_THREADS = 384;   // producer + two consumer warpgroups
// setmaxnreg split of the dk, dv pass: ptxas gives each of its 384 threads
// 65536 / 384 rounded down to 8 = 168 registers at entry
constexpr int KV_ENTRY_REGS = 168;
constexpr int KV_PRODUCER_REGS = 40;
constexpr int KV_CONSUMER_REGS = 232;
static_assert(128 * KV_PRODUCER_REGS + 256 * KV_CONSUMER_REGS ==
                  KV_THREADS * KV_ENTRY_REGS,
              "the setmaxnreg split must hand out exactly the entry count");
// named barriers of the P dcap exchange (0 is __syncthreads)
constexpr int X_FULL = 1, X_EMPTY = 3;

template <int D, int Dv>
struct Cfg {
  static constexpr int ND = (D + 63) / 64;   // boxes of a q or k row
  static constexpr int NV = (Dv + 63) / 64;  // boxes of a v or dO row
  static constexpr int KD = D / 16;          // k-steps of S over D
  static constexpr int KDV = Dv / 16;        // k-steps of dP over Dv
  static constexpr int QK_BYTES = ND * BOX;  // one 64-row q or k tile
  static constexpr int V_BYTES = NV * BOX;   // one 64-row v or dO tile
  static constexpr int STAT_BYTES = 2 * BM * 4;   // a q tile's lse, Dvec
  static constexpr int X_BYTES = 32 * 128 * 4;    // one P dcap buffer
  // Chosen by measurement (see the note above the namespace).  dq pass:
  // two blocks an SM where D, Dv <= 128 (their shared memory fits; the
  // producer's registers go to the consumer: setmaxnreg 24 / 232 from
  // 128 at entry), ring slots, and the software pipeline wherever the
  // registers allow it (not at D = 256: it spills there).  dk, dv pass:
  // two ring slots (more did not help).
  static constexpr int DQ_BLOCKS = ND + NV <= 4 ? 2 : 1;
  static constexpr int DQ_STAGES =
      ND + NV <= 4 ? (D <= 64 ? 4 : 2) : (D == 256 ? 2 : 4);
  static constexpr bool DQ_PIPELINE = D != 256;
  static constexpr int KV_STAGES = 2;
  static constexpr int DQ_ENTRY_REGS = DQ_BLOCKS == 2 ? 128 : 0;
  // + 1024 to align the tiles to the 1024-byte swizzle atom
  static constexpr int DQ_SMEM =
      1024 + (1 + DQ_STAGES) * (QK_BYTES + V_BYTES);
  static constexpr int KV_SMEM =
      1024 + (1 + KV_STAGES) * (QK_BYTES + V_BYTES) +
      KV_STAGES * STAT_BYTES + 2 * X_BYTES;
  static_assert(DQ_SMEM * DQ_BLOCKS <= 232448 - 1024 * DQ_BLOCKS,
                "the dq pass's shared memory");
  static_assert(KV_SMEM <= 232448 - 64, "the dk, dv pass's shared memory");
};

struct WgParams {
  const float* stat;     // (2, B, H, Sq_pad): lse * log2(e), then Dvec
  float* ws;             // (split, nk + nv) f32 partials, or null
  __nv_bfloat16* dq;     // (B, Sq, H, D) contiguous
  __nv_bfloat16* dk;     // (B, Sk, KV, D) contiguous
  __nv_bfloat16* dv;     // (B, Sk, KV, Dv) contiguous
  long long nk, nv;      // elements of dk and of dv
  int B, Sq, Sk, H, KV, Sq_pad, split, n_qtiles;
  int causal, window, q_offset;
  float softcap, scale;
  // TMA coordinate slot (0..2) of head, seq and batch: 2 bits each
  int slots_q, slots_k, slots_v, slots_do;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed: one asm
// block (no divergent branch around the wgmma that follow); traps after
// 2^24 polls, so a lost load surfaces as a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 16777216;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `n` boxes (64 columns each, from column 0; 64 rows from `row`) of one
// (head, batch) into consecutive boxes at `dst`; `slots` says which TMA
// coordinate each of head, seq, batch is.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int slots, int n,
                                          int head, int row, int batch) {
  auto at = [&](int i) {
    return (slots & 3) == i ? head : ((slots >> 2) & 3) == i ? row : batch;
  };
#pragma unroll 1
  for (int j = 0; j < n; ++j)
    tma_load(dst + j * BOX, map, bar, 64 * j, at(0), at(1), at(2));
}

// A plain bulk copy (no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) into shared memory, counted into `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a box stored as 128-byte rows in the
// 128-byte swizzle: start address >> 4, leading and stride byte offsets
// (1024 bytes from one group of 8 rows to the next) >> 4, layout 1.
__device__ __forceinline__ unsigned long long desc(uint32_t addr) {
  return static_cast<unsigned long long>((addr >> 4) & 0x3FFF) |
         (static_cast<unsigned long long>(1024 >> 4) << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}
// descriptor step to k-step kk of a K-major tile: 32 bytes per 16 columns
// inside a box, one box per 64 columns
__device__ __forceinline__ unsigned long long kstep(int kk) {
  return static_cast<unsigned long long>(((kk / 4) * BOX + (kk % 4) * 32) >>
                                         4);
}
// descriptor step to rows [16 j, 16 j + 16) of box n of an MN-major B
__device__ __forceinline__ unsigned long long mnstep(int n, int j) {
  return static_cast<unsigned long long>((n * BOX + j * 16 * ROW) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&d)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m) fence_regs(d[m]);
}
__device__ __forceinline__ void fence_regs(unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
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

// d (64 x 64) = A (64 x 16) B^T + (accumulate ? d : 0); A and B (64 x 16)
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], unsigned long long a,
                                         unsigned long long b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, bf16 pairs in registers) B (16 x 64, MN-major
// in shared memory: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const unsigned (&a)[4],
                                         unsigned long long b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// A 64 x 64 accumulator as bf16 A fragments: the pairs of n-blocks 2j and
// 2j + 1 are the A fragment of k chunk j.
__device__ __forceinline__ void pack(const float (&s)[32],
                                     unsigned (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
    a[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    a[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    a[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// Accumulator element i of a lane: row r_i = 16 warp + g + 8 ((i >> 1) & 1),
// column c_i = 8 (i / 4) + 2 tig + (i & 1).
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int i, int tig) {
  return 8 * (i / 4) + 2 * tig + (i & 1);
}

// Whether (query row q, key) is a live pair.
__device__ __forceinline__ bool live(const WgParams& p, int q, int key) {
  const int qpos = p.q_offset + q;
  bool ok = key < p.Sk && q < p.Sq;
  if (p.causal) ok = ok && key <= qpos;
  if (p.window > 0) ok = ok && key > qpos - p.window;
  return ok;
}

// Whether every pair of rows [q0, q0 + 64) and keys [k0, k0 + 64) is live.
__device__ __forceinline__ bool all_live(const WgParams& p, int q0, int k0) {
  if (k0 + BM > p.Sk || q0 + BM > p.Sq) return false;
  const int lo = p.q_offset + q0;
  if (p.causal && k0 + BM - 1 > lo) return false;
  if (p.window > 0 && k0 <= lo + BM - 1 - p.window) return false;
  return true;
}

// P (in place of the raw scores s) and dcap of one element, the row's lse
// in log2 units; the caller masks.
__device__ __forceinline__ float prob(const WgParams& p, float s, float lse2,
                                      float* dcap) {
  if (p.softcap > 0.f) {
    const float t = tanhf(s * (p.scale / p.softcap));
    *dcap = 1.f - t * t;
    return exp2f(t * (p.softcap * LOG2E) - lse2);
  }
  *dcap = 1.f;
  return exp2f(s * (p.scale * LOG2E) - lse2);
}

// KV tiles [*kb, *ke) holding a live key for some query position in
// [lo, hi].
__device__ __forceinline__ void kv_tiles(const WgParams& p, int lo, int hi,
                                         int* kb, int* ke) {
  *kb = 0;
  *ke = (p.Sk + BM - 1) / BM;
  if (p.causal) *ke = hi < 0 ? 0 : min(*ke, hi / BM + 1);
  if (p.window > 0) {
    const int first = lo - p.window + 1;  // first key the top row sees
    if (first > 0) *kb = first / BM;
  }
}

// q tiles [*qb, *qe) holding a row that sees some key in [k0, k_hi].
__device__ __forceinline__ void q_tiles(const WgParams& p, int k0, int k_hi,
                                        int* qb, int* qe) {
  int q_begin = 0, q_end = p.Sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) q_end = min(q_end, max(0, k_hi + p.window - p.q_offset));
  *qb = q_begin / BM;
  *qe = q_end > q_begin ? (q_end + BM - 1) / BM : *qb;
}

// Stores rows (16 warp + g, + 8) of a 64-row accumulator of `W` columns
// (N boxes) from `row0` as bf16 into `out` (row stride `stride` rows of W,
// row r at (row_index(r)) * W), or as f32 into `ws` when it is not null;
// rows at or past `rows`, columns at or past W skipped.
template <int W, int N, typename Index>
__device__ __forceinline__ void store_acc(const float (&acc)[N][32],
                                          int row0, int rows, int tig,
                                          Index row_index, __nv_bfloat16* out,
                                          float* ws) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const long long base = row_index(row) * W;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * n + 8 * j + 2 * tig;
        if (col >= W) continue;
        const float lo = acc[n][4 * j + 2 * r], hi = acc[n][4 * j + 2 * r + 1];
        if (ws != nullptr)
          *reinterpret_cast<float2*>(ws + base + col) = make_float2(lo, hi);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + base + col) =
              __floats2bfloat162_rn(lo, hi);
      }
  }
}

// Each row's lse (log2 units) and Dvec = rowsum(dO o) into the (2, B, H,
// Sq_pad) scratch; rows past Sq get 0.  One warp a row, 16-byte loads.
__global__ void __launch_bounds__(NTHREADS) rowstat_kernel(const Params p,
                                                          float* stat,
                                                          int Sq_pad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long total = static_cast<long long>(p.B) * p.H * Sq_pad;
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + warp;
  if (row >= total) return;
  const int q = int(row % Sq_pad);
  const long long bh = row / Sq_pad;
  const int h = int(bh % p.H), b = int(bh / p.H);
  float lse2 = 0.f, acc = 0.f;
  if (q < p.Sq) {
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) +
                             b * p.os0 + q * p.os1 + h * p.os2;
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.dout) +
                             b * p.gs0 + q * p.gs1 + h * p.gs2;
    for (int c = 8 * lane; c < p.Dv; c += 256) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(g + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(o2[i]);
        const float2 d = __bfloat1622float2(g2[i]);
        acc += a.x * d.x + a.y * d.y;
      }
    }
    acc = warp_sum(acc);
    lse2 = p.lse[(static_cast<long long>(b) * p.Sq + q) * p.H + h] * LOG2E;
  }
  if (lane == 0) {
    stat[row] = lse2;
    stat[total + row] = acc;
  }
}

template <int D, int Dv>
__global__ void __launch_bounds__(DQ_THREADS, Cfg<D, Dv>::DQ_BLOCKS)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const WgParams p) {
  using C = Cfg<D, Dv>;
  constexpr int ND = C::ND, NV = C::NV, STAGES = C::DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q and dO full, then per slot: K and V full, empty
  __shared__ __align__(8) unsigned long long bars[1 + 2 * STAGES];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sO = sQ + C::QK_BYTES;  // dO
  const uint32_t sKV = sO + C::V_BYTES;  // slot s: K, then V
  const uint32_t bar_q = smem_u32(bars);
  auto bar_f = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto slot_k = [&](int it) {
    return sKV + (it % STAGES) * (C::QK_BYTES + C::V_BYTES);
  };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (p.n_qtiles - 1 - int(blockIdx.z)) * BM;
  int kb, ke;
  kv_tiles(p, p.q_offset + q0, p.q_offset + min(q0 + BM, p.Sq) - 1, &kb,
           &ke);
  const int n_tiles = max(ke - kb, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(FULL, int(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    if constexpr (C::DQ_BLOCKS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KV);
      mbar_expect_tx(bar_q, C::QK_BYTES + C::V_BYTES);
      load_tile(sQ, &tm_q, bar_q, p.slots_q, ND, h, q0, b);
      load_tile(sO, &tm_do, bar_q, p.slots_do, NV, h, q0, b);
#pragma unroll 1
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, k0 = (kb + it) * BM;
        mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_f(s), C::QK_BYTES + C::V_BYTES);
        load_tile(slot_k(it), &tm_k, bar_f(s), p.slots_k, ND, kvh, k0, b);
        load_tile(slot_k(it) + C::QK_BYTES, &tm_v, bar_f(s), p.slots_v, NV,
                  kvh, k0, b);
      }
    }
    return;
  }
  // ---- the consumer: 64 query rows ----
  if constexpr (C::DQ_BLOCKS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int warp = __shfl_sync(FULL, int(threadIdx.x) / 32 % 4, 0);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const long long total = static_cast<long long>(p.B) * p.H * p.Sq_pad;
  const float* stat = p.stat + (static_cast<long long>(b) * p.H + h) *
                                   p.Sq_pad;
  float lse2[2], dvec[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // rows past Sq read the scratch's zero padding (Sq_pad >= the tile)
    lse2[r] = stat[row0 + 8 * r];
    dvec[r] = stat[total + row0 + 8 * r];
  }
  const float sc = p.scale;

  float dq[ND][32];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[n][i] = 0.f;

  mbar_wait(bar_q, 0);
  auto wait_full = [&](int it) {
    mbar_wait(bar_f(it % STAGES), (it / STAGES) & 1);
  };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(bar_e(it % STAGES));
  };
  // S = Q K^T and dP = dO V^T of tile it (issued, not waited for)
  auto scores = [&](int it, float (&s_)[32], float (&dp)[32]) {
    const uint32_t sk = slot_k(it), sv = sk + C::QK_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss(s_, desc(sQ) + kstep(kk), desc(sk) + kstep(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::KDV; ++kk)
      wgmma_ss(dp, desc(sO) + kstep(kk), desc(sv) + kstep(kk), kk > 0);
    wgmma_commit();
  };
  // dS = P (dP - Dvec) dcap scale of tile it, in place of the scores
  auto dscores = [&](int it, float (&s_)[32], const float (&dp)[32]) {
    const int k0 = (kb + it) * BM;
    const bool full = all_live(p, q0, k0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float dcap;
      const float pr = prob(p, s_[i], lse2[r], &dcap);
      const float ds = pr * (dp[i] - dvec[r]) * dcap * sc;
      s_[i] = full || live(p, row0 + 8 * r, k0 + acc_col(i, tig)) ? ds : 0.f;
    }
  };
  // dQ += dS K of tile it (issued, not waited for)
  auto accumulate = [&](int it, const unsigned (&a)[4][4]) {
    const uint32_t sk = slot_k(it);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        wgmma_rs(dq[n], a[j], desc(sk) + mnstep(n, j));
    wgmma_commit();
  };
  if constexpr (C::DQ_PIPELINE) {
    // Software pipeline: tile it + 1's S and dP, then tile it's dQ
    // product; tile it + 1's dS runs on the CUDA cores while tile it's dQ
    // holds the tensor cores.
    if (n_tiles > 0) {
      float s_[32], dp[32];
      unsigned a[4][4];
      wait_full(0);
      wgmma_fence();
      scores(0, s_, dp);
      wgmma_wait<0>();
      fence_regs(s_);
      fence_regs(dp);
      dscores(0, s_, dp);
      pack(s_, a);
      int it = 0;
#pragma unroll 1
      for (; it + 1 < n_tiles; ++it) {
        wait_full(it + 1);
        wgmma_fence();
        scores(it + 1, s_, dp);
        accumulate(it, a);
        wgmma_wait<1>();  // S, dP of tile it + 1; tile it's dQ may run on
        fence_regs(s_);
        fence_regs(dp);
        dscores(it + 1, s_, dp);
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(a);
        release(it);
        pack(s_, a);
      }
      wgmma_fence();
      accumulate(it, a);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(a);
      release(it);
    }
  } else {
#pragma unroll 1
    for (int it = 0; it < n_tiles; ++it) {
      float s_[32], dp[32];
      unsigned a[4][4];
      wait_full(it);
      wgmma_fence();
      scores(it, s_, dp);
      wgmma_wait<0>();
      fence_regs(s_);
      fence_regs(dp);
      dscores(it, s_, dp);
      pack(s_, a);
      wgmma_fence();
      accumulate(it, a);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(a);
      release(it);
    }
  }
  store_acc<D>(dq, row0, p.Sq, tig,
               [&](int row) {
                 return (static_cast<long long>(b) * p.Sq + row) * p.H + h;
               },
               p.dq, nullptr);
}

// The dk, dv pass's ring of (Q, dO, lse, Dvec) slots, as a consumer sees
// it.
template <int D, int Dv>
struct Ring {
  static constexpr int STAGES = Cfg<D, Dv>::KV_STAGES;
  uint32_t stage0;     // slot s: Q, then dO
  const float* stat;   // slot s: the q tile's lse (log2 units), then Dvec
  uint32_t bar_f0, bar_e0;
  __device__ uint32_t q(int it) const {
    return stage0 +
           (it % STAGES) * (Cfg<D, Dv>::QK_BYTES + Cfg<D, Dv>::V_BYTES);
  }
  __device__ uint32_t dout(int it) const {
    return q(it) + Cfg<D, Dv>::QK_BYTES;
  }
  __device__ const float* lse2(int it) const {
    return stat + (it % STAGES) * 2 * BM;
  }
  __device__ const float* dvec(int it) const { return lse2(it) + BM; }
};

// A dk, dv consumer's walk over its `total` items: each item's first
// product (`scores`), the elementwise step (`probs`, in place), P^T or
// dS^T packed to bf16, and the accumulating product (`accumulate` into
// `acc`), in turn.  (A software pipeline as in the dq pass, with more ring
// slots, was no faster here.)
template <int D, int Dv, int N, typename Scores, typename Probs,
          typename Accumulate>
__device__ __forceinline__ void walk(int total, const Ring<D, Dv>& ring,
                                     int lane, float (&acc)[N][32],
                                     Scores scores, Probs probs,
                                     Accumulate accumulate) {
  constexpr int STAGES = Ring<D, Dv>::STAGES;
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    float x[32];
    unsigned a[4][4];
    mbar_wait(ring.bar_f0 + 8u * (it % STAGES), (it / STAGES) & 1);
    wgmma_fence();
    scores(it, x);
    wgmma_wait<0>();
    fence_regs(x);
    probs(it, x);
    pack(x, a);
    wgmma_fence();
    accumulate(it, a);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    if (lane == 0) mbar_arrive(ring.bar_e0 + 8u * (it % STAGES));
  }
}

// The dk, dv pass's "V" warpgroup: S^T, P^T, the P dcap hand-over, dV.
template <int D, int Dv>
__device__ __forceinline__ void dkdv_v_role(
    const WgParams& p, const Ring<D, Dv>& ring, uint32_t sK, float* sX,
    int k0, int qt_begin, int nq, int total, int warp, int lane, int b,
    int kvh, int part, float* ws) {
  using C = Cfg<D, Dv>;
  constexpr int NV = C::NV;
  const int g = lane / 4, tig = lane % 4, t = int(threadIdx.x) % 128;
  const int key0 = k0 + warp * 16 + g;
  float dv[NV][32];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[n][i] = 0.f;
  // S^T = K Q^T of item it (issued, not waited for)
  auto scores = [&](int it, float (&st)[32]) {
    const uint32_t sq = ring.q(it);
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss(st, desc(sK) + kstep(kk), desc(sq) + kstep(kk), kk > 0);
    wgmma_commit();
  };
  // P^T of item it in place of S^T, and P dcap handed to "K"
  auto probs = [&](int it, float (&st)[32]) {
    const int x = it % 2, q0 = (qt_begin + it % nq) * BM;
    const float* lse2 = ring.lse2(it);
    if (it >= 2)  // "K" has read this buffer's previous item
      asm volatile("bar.sync %0, 256;\n" ::"r"(X_EMPTY + x) : "memory");
    float* xb = sX + x * 32 * 128;
    const bool full = all_live(p, q0, k0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = acc_col(i, tig);
      float dcap;
      const float pr = prob(p, st[i], lse2[c], &dcap);
      const bool ok = full || live(p, q0 + c, key0 + acc_row(i));
      st[i] = ok ? pr : 0.f;
      xb[i * 128 + t] = ok ? pr * dcap : 0.f;
    }
    asm volatile("bar.arrive %0, 256;\n" ::"r"(X_FULL + x) : "memory");
  };
  // dV += P^T dO of item it (issued, not waited for)
  auto accumulate = [&](int it, const unsigned (&a)[4][4]) {
    const uint32_t so = ring.dout(it);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < NV; ++n)
        wgmma_rs(dv[n], a[j], desc(so) + mnstep(n, j));
    wgmma_commit();
  };
  walk(total, ring, lane, dv, scores, probs, accumulate);
  store_acc<Dv>(dv, key0, p.Sk, tig,
                [&](int key) {
                  return (static_cast<long long>(b) * p.Sk + key) * p.KV +
                         kvh;
                },
                p.dv, ws == nullptr ? nullptr : ws + part * (p.nk + p.nv) +
                                                     p.nk);
}

// The dk, dv pass's "K" warpgroup: dP^T, dS^T from the handed-over P dcap,
// dK.
template <int D, int Dv>
__device__ __forceinline__ void dkdv_k_role(
    const WgParams& p, const Ring<D, Dv>& ring, uint32_t sV,
    const float* sX, int k0, int total, int warp, int lane, int b, int kvh,
    int part, float* ws) {
  using C = Cfg<D, Dv>;
  constexpr int ND = C::ND;
  const int g = lane / 4, tig = lane % 4, t = int(threadIdx.x) % 128;
  const int key0 = k0 + warp * 16 + g;
  const float sc = p.scale;
  float dk[ND][32];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[n][i] = 0.f;
  // dP^T = V dO^T of item it (issued, not waited for)
  auto scores = [&](int it, float (&dp)[32]) {
    const uint32_t so = ring.dout(it);
#pragma unroll
    for (int kk = 0; kk < C::KDV; ++kk)
      wgmma_ss(dp, desc(sV) + kstep(kk), desc(so) + kstep(kk), kk > 0);
    wgmma_commit();
  };
  // dS^T of item it in place of dP^T, from the P dcap "V" handed over
  auto probs = [&](int it, float (&dp)[32]) {
    const int x = it % 2;
    const float* dvec = ring.dvec(it);
    asm volatile("bar.sync %0, 256;\n" ::"r"(X_FULL + x) : "memory");
    const float* xb = sX + x * 32 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = xb[i * 128 + t] * (dp[i] - dvec[acc_col(i, tig)]) * sc;
    if (it + 2 < total)  // "V" writes this buffer again
      asm volatile("bar.arrive %0, 256;\n" ::"r"(X_EMPTY + x) : "memory");
  };
  // dK += dS^T Q of item it (issued, not waited for)
  auto accumulate = [&](int it, const unsigned (&a)[4][4]) {
    const uint32_t sq = ring.q(it);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < ND; ++n)
        wgmma_rs(dk[n], a[j], desc(sq) + mnstep(n, j));
    wgmma_commit();
  };
  walk(total, ring, lane, dk, scores, probs, accumulate);
  store_acc<D>(dk, key0, p.Sk, tig,
               [&](int key) {
                 return (static_cast<long long>(b) * p.Sk + key) * p.KV + kvh;
               },
               p.dk, ws == nullptr ? nullptr : ws + part * (p.nk + p.nv));
}

template <int D, int Dv>
__global__ void __launch_bounds__(KV_THREADS, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const WgParams p) {
  using C = Cfg<D, Dv>;
  constexpr int ND = C::ND, NV = C::NV, STAGES = C::KV_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // K and V full, then per slot: Q, dO, lse and Dvec full, empty
  __shared__ __align__(8) unsigned long long bars[1 + 2 * STAGES];

  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + C::QK_BYTES;
  const uint32_t stage0 = sV + C::V_BYTES;  // slot s: Q, then dO
  const uint32_t sStat_u = stage0 + STAGES * (C::QK_BYTES + C::V_BYTES);
  float* sStat = reinterpret_cast<float*>(smem_raw + (sStat_u - base));
  float* sX = sStat + STAGES * 2 * BM;  // two buffers of 32 x 128 f32
  const uint32_t bar_kv = smem_u32(bars);
  const uint32_t bar_f0 = bar_kv + 8u, bar_e0 = bar_kv + 8u * (1 + STAGES);

  const int kt = blockIdx.z, b = blockIdx.y;
  const int kvh = blockIdx.x / p.split, part = blockIdx.x % p.split;
  const int nh = p.H / p.KV / p.split;           // heads of this block
  const int h0 = kvh * (p.H / p.KV) + part * nh;
  const int k0 = kt * BM;
  int qb, qe;
  q_tiles(p, k0, min(k0 + BM, p.Sk) - 1, &qb, &qe);
  const int nq = qe - qb, total = nh * nq;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f0 + 8u * s, 1);
      mbar_init(bar_e0 + 8u * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(FULL, int(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        KV_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, C::QK_BYTES + C::V_BYTES);
      load_tile(sK, &tm_k, bar_kv, p.slots_k, ND, kvh, k0, b);
      load_tile(sV, &tm_v, bar_kv, p.slots_v, NV, kvh, k0, b);
      const long long plane = static_cast<long long>(p.B) * p.H * p.Sq_pad;
#pragma unroll 1
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        const int h = h0 + it / nq, q0 = (qb + it % nq) * BM;
        const uint32_t sq = stage0 + s * (C::QK_BYTES + C::V_BYTES);
        const uint32_t bf = bar_f0 + 8u * s;
        mbar_wait(bar_e0 + 8u * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(bf, C::QK_BYTES + C::V_BYTES + C::STAT_BYTES);
        load_tile(sq, &tm_q, bf, p.slots_q, ND, h, q0, b);
        load_tile(sq + C::QK_BYTES, &tm_do, bf, p.slots_do, NV, h, q0, b);
        const float* src =
            p.stat + (static_cast<long long>(b) * p.H + h) * p.Sq_pad + q0;
        const uint32_t dst = sStat_u + s * C::STAT_BYTES;
        bulk_load(dst, src, BM * 4, bf);
        bulk_load(dst + BM * 4, src + plane, BM * 4, bf);
      }
    }
    return;
  }
  // ---- the consumers: "V" (warpgroup 1) and "K" (warpgroup 2) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      KV_CONSUMER_REGS));
  const int warp = __shfl_sync(FULL, int(threadIdx.x) / 32 % 4, 0);
  const int lane = threadIdx.x % 32;
  float* ws = p.split > 1 ? p.ws : nullptr;
  mbar_wait(bar_kv, 0);
  const Ring<D, Dv> ring{stage0, sStat, bar_f0, bar_e0};
  if (wg == 1)
    dkdv_v_role<D, Dv>(p, ring, sK, sX, k0, qb, nq, total, warp, lane, b,
                       kvh, part, ws);
  else
    dkdv_k_role<D, Dv>(p, ring, sV, sX, k0, total, warp, lane, b, kvh, part,
                       ws);
}

// dk, dv = the sum of the split's partials in split order, as bf16.
__global__ void __launch_bounds__(256) reduce_kernel(const float* ws,
                                                     __nv_bfloat16* dk,
                                                     __nv_bfloat16* dv,
                                                     long long nk,
                                                     long long nv,
                                                     int split) {
  const long long n = nk + nv;
  for (long long e = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x);
       e < n; e += 4LL * gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(ws + e);
    for (int s = 1; s < split; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(ws + s * n + e);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat16* out = e < nk ? dk + e : dv + (e - nk);
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: it is looked up in the
// driver library the process has already loaded, so nothing links libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A 4-D tensor map over the (width, head, seq, batch) view of a bf16 tensor
// with element extents `ext` and strides `stride` of (head, seq, batch):
// boxes of 64 columns x 64 rows of one head and batch, in the 128-byte
// swizzle, zero fill past the end (past `width` too: a row of 80 reads as
// two boxes).  The outer dims go to TMA in increasing order of stride (a
// dim of size 1 last); `slots` records which TMA coordinate each of head,
// seq and batch became, 2 bits each.
bool make_map(CUtensorMap* map, const void* ptr, int width,
              const long long* ext, const long long* stride, int* slots) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  int order[3] = {0, 1, 2};
  auto before = [&](int a, int b) {
    if ((ext[a] == 1) != (ext[b] == 1)) return ext[b] == 1;
    return stride[a] < stride[b];
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(order[j], order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {cuuint64_t(width), 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  long long prev = 2LL * width;  // bytes spanned by the dims placed so far
  *slots = 0;
  for (int i = 0; i < 3; ++i) {
    const int w = order[i];
    const long long bytes = ext[w] == 1 ? prev : 2 * stride[w];
    dims[i + 1] = cuuint64_t(ext[w]);
    strides[i] = cuuint64_t(bytes);
    box[i + 1] = w == 1 ? cuuint32_t(BM) : 1;
    *slots |= i << (2 * w);
    prev = bytes * ext[w];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (D, Dv) pairs the "wgmma" kernels take: every training head width of the
// port.  The same list as kernels/flash_attention.py WGMMA_WIDTHS and as
// csrc/flash_attention.cu's (a CPU test holds all three equal).
constexpr int WGMMA_WIDTHS[][2] = {
    {64, 64}, {80, 80}, {128, 128}, {256, 256}, {192, 128}};

// bf16, (D, Dv) in WGMMA_WIDTHS, at least one key, 16-byte aligned bases
// and (batch, seq, head) strides of q, k, v, o and dO.
bool takes(const Params& p) {
  bool widths = false;
  for (const auto& w : WGMMA_WIDTHS) widths |= p.D == w[0] && p.Dv == w[1];
  return p.bf16 == 1 && widths && p.Sk > 0 &&
         aligned16(p.q, p.qs0, p.qs1, p.qs2) &&
         aligned16(p.k, p.ks0, p.ks1, p.ks2) &&
         aligned16(p.v, p.vs0, p.vs1, p.vs2) &&
         aligned16(p.o, p.os0, p.os1, p.os2) &&
         aligned16(p.dout, p.gs0, p.gs1, p.gs2);
}

// A setmaxnreg split needs ptxas's register count at entry to be the one
// it assumes (KV_ENTRY_REGS for the dk, dv kernel, DQ_ENTRY_REGS for a dq
// kernel run two blocks an SM): else a consumer's setmaxnreg.inc would
// wait for registers that are not there.  Such a build is refused before
// any launch (checked once per instantiation).
template <int D, int Dv>
cudaError_t check_regs() {
  static std::atomic<bool> ok{false};
  if (ok.load()) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, dkdv_wgmma_kernel<D, Dv>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != KV_ENTRY_REGS) return cudaErrorInvalidKernelImage;
  if constexpr (Cfg<D, Dv>::DQ_ENTRY_REGS > 0) {
    err = cudaFuncGetAttributes(&attr, dq_wgmma_kernel<D, Dv>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs != Cfg<D, Dv>::DQ_ENTRY_REGS)
      return cudaErrorInvalidKernelImage;
  }
  ok.store(true);
  return cudaSuccess;
}

int sq_pad(int Sq) { return (Sq + BM - 1) / BM * BM; }

template <int D, int Dv>
cudaError_t launch(const Params& p, float* stat, int split, float* ws,
                   cudaStream_t stream) {
  using C = Cfg<D, Dv>;
  cudaError_t err = check_regs<D, Dv>();
  if (err != cudaSuccess) return err;
  WgParams w{};
  w.stat = stat;
  w.ws = ws;
  w.dq = static_cast<__nv_bfloat16*>(p.dq);
  w.dk = static_cast<__nv_bfloat16*>(p.dk);
  w.dv = static_cast<__nv_bfloat16*>(p.dv);
  w.nk = static_cast<long long>(p.B) * p.Sk * p.KV * D;
  w.nv = static_cast<long long>(p.B) * p.Sk * p.KV * Dv;
  w.B = p.B;
  w.Sq = p.Sq;
  w.Sk = p.Sk;
  w.H = p.H;
  w.KV = p.KV;
  w.Sq_pad = sq_pad(p.Sq);
  w.split = split;
  w.n_qtiles = w.Sq_pad / BM;
  w.causal = p.causal;
  w.window = p.window;
  w.q_offset = p.q_offset;
  w.softcap = p.softcap;
  w.scale = p.scale;
  const int n_ktiles = (p.Sk + BM - 1) / BM;
  if (w.n_qtiles > 65535 || n_ktiles > 65535) return cudaErrorInvalidValue;
  const long long qe[3] = {p.H, p.Sq, p.B}, qs[3] = {p.qs2, p.qs1, p.qs0};
  const long long gs[3] = {p.gs2, p.gs1, p.gs0};
  const long long ke[3] = {p.KV, p.Sk, p.B}, ks[3] = {p.ks2, p.ks1, p.ks0};
  const long long vs[3] = {p.vs2, p.vs1, p.vs0};
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, D, qe, qs, &w.slots_q) ||
      !make_map(&tk, p.k, D, ke, ks, &w.slots_k) ||
      !make_map(&tv, p.v, Dv, ke, vs, &w.slots_v) ||
      !make_map(&tdo, p.dout, Dv, qe, gs, &w.slots_do))
    return cudaErrorInvalidValue;
  err = set_smem<dq_wgmma_kernel<D, Dv>>(C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = set_smem<dkdv_wgmma_kernel<D, Dv>>(C::KV_SMEM);
  if (err != cudaSuccess) return err;

  const long long rows = static_cast<long long>(p.B) * p.H * w.Sq_pad;
  rowstat_kernel<<<dim3(unsigned((rows + NWARPS - 1) / NWARPS)), NTHREADS, 0,
                   stream>>>(p, stat, w.Sq_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_wgmma_kernel<D, Dv><<<dim3(p.H, p.B, w.n_qtiles), DQ_THREADS,
                           C::DQ_SMEM, stream>>>(tq, tk, tv, tdo, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_wgmma_kernel<D, Dv><<<dim3(p.KV * split, p.B, n_ktiles), KV_THREADS,
                             C::KV_SMEM, stream>>>(tq, tk, tv, tdo, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long groups = (w.nk + w.nv) / 4;
  const long long want = (groups + 255) / 256;
  const unsigned blocks = unsigned(want < 132 * 16 ? want : 132 * 16);
  reduce_kernel<<<blocks, 256, 0, stream>>>(ws, w.dk, w.dv, w.nk, w.nv,
                                            split);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, float* stat, int split, float* ws,
                     cudaStream_t stream) {
  if (p.D == 192) return launch<192, 128>(p, stat, split, ws, stream);
  switch (p.D) {
    case 64: return launch<64, 64>(p, stat, split, ws, stream);
    case 80: return launch<80, 80>(p, stat, split, ws, stream);
    case 128: return launch<128, 128>(p, stat, split, ws, stream);
    default: return launch<256, 256>(p, stat, split, ws, stream);
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// variant: 0 = CUDA-core, 1 = wgmma, as chosen by the wrapper; a variant
// that cannot take the inputs returns cudaErrorInvalidValue and launches
// nothing (never the other variant).  lse: (B, Sq, H) f32 contiguous; dq,
// dk, dv contiguous.  scratch: for "cuda_core" a (B, Sq, H) f32 buffer
// (Dvec), for "wgmma" a (2, B, H, Sq_pad) one, Sq_pad = Sq rounded up to
// 64.  split: "wgmma"'s head split, a divisor of H / KV (1 for
// "cuda_core"); ws: with split > 1 a (split, B Sk KV (D + Dv)) f32
// workspace, else null.  Launches the variant's kernels on `stream` in
// order and returns the launches' cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, float* ws, int dtype, int variant, int split, int B, int Sq,
    int Sk, int H, int KV, int D, int Dv, long long qs0, long long qs1,
    long long qs2, long long ks0, long long ks1, long long ks2, long long vs0,
    long long vs1, long long vs2, long long os0, long long os1, long long os2,
    long long gs0, long long gs1, long long gs2, int causal, int window,
    float softcap, int q_offset, float scale, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || B < 1 || Sq < 1 || Sk < 1 || H > 65535 ||
      B > 65535)
    return int(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   o,      dout,   lse,     scratch, dq,  dk,
                 dv,  dtype, B, Sq,     Sk,     H,       KV,      D,   Dv,
                 qs0, qs1, qs2, ks0,    ks1,    ks2,     vs0,     vs1, vs2,
                 os0, os1, os2, gs0,    gs1,    gs2,     causal,  window,
                 q_offset, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if (split != 1 || ws != nullptr) return int(cudaErrorInvalidValue);
      return int(run(p, s));
    case 1:
      if (!wg::takes(p) || split < 1 || (H / KV) % split != 0 ||
          (split > 1) != (ws != nullptr))
        return int(cudaErrorInvalidValue);
      return int(wg::dispatch(p, scratch, split, ws, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
