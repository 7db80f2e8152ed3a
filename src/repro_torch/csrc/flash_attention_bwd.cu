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
// MQA).  D and Dv independent up to 256; inputs f32 or bf16, f32 math,
// gradients in the inputs' dtype.
//
// What bounds it on the H100: S and dP recomputed and the three products
// are at least 2 (3 D + 2 Dv) operations per live (query, key) pair
// against O(S (D + Dv)) bytes per (batch, head), so at the training shapes
// (S = 1024, D = 64..256) it is bound by operations: at deepseek-v3-671b's
// MLA shape (B = 2, S = 1024, H = KV = 128, D = 192, Dv = 128, causal, bf16)
// the least time is ~0.23 ms at the bf16 tensor cores' 989 TFLOP/s
// (chip_smoke.py's attn_bwd_bound).  This first version does 2 (4 D + 3 Dv)
// (S and dP in both passes) on the CUDA cores in f32 (67 TFLOP/s peak);
// wgmma and TMA are later work.  What the design does about the
// bound: every product reads its operands from shared memory, staged once
// per tile as f32 and read as float4; one side of each dot product is a
// lane's own row (rows padded so that 8 lanes' 16-byte reads hit 8 different
// bank groups), the other a broadcast; P and dS never leave registers
// (they are broadcast by shuffle into the accumulating products); dead
// tiles are skipped from the mask's bounds.
//
// Three kernels on one stream, as the reference has two passes:
//   * dvec_kernel: Dvec = rowsum(dO * o) per (batch, row, head), one warp a
//     row, into an f32 scratch the wrapper allocates.
//   * dq_kernel, grid (q tile of 32 rows, head, batch): loops over the KV
//     tiles of 32 keys the rows can see; lane j holds key j, each warp 8
//     rows; dq for the block's rows accumulates in registers.
//   * dkdv_kernel, grid (KV tile, KV head, batch): loops over the q tiles
//     of 32 rows that can see its keys and over the G heads of the group;
//     lane i holds query row i, each warp KPW keys; dk and dv accumulate in
//     registers.
// No atomics: each output element is written by one thread of one block,
// so a gradient repeats bit for bit.  The C entry refuses inputs it cannot
// take (cudaErrorInvalidValue) before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv alike).
// lse: (B, Sq, H) f32 contiguous; dvec: a (B, Sq, H) f32 scratch; dq, dk,
// dv contiguous.  Launches the three kernels on `stream` in order, or
// returns cudaErrorInvalidValue for inputs they cannot take (and launches
// nothing).  Returns the launches' cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    long long qs0, long long qs1, long long qs2, long long ks0, long long ks1,
    long long ks2, long long vs0, long long vs1, long long vs2, long long os0,
    long long os1, long long os2, long long gs0, long long gs1, long long gs2,
    int causal, int window, float softcap, int q_offset, float scale,
    void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0 ||
      (dtype != 0 && dtype != 1) || B < 1 || Sq < 1 || Sk < 1 || H > 65535 ||
      B > 65535)
    return int(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   o,      dout,   lse,     dvec,   dq,  dk,
                 dv,  dtype, B, Sq,     Sk,     H,       KV,     D,   Dv,
                 qs0, qs1, qs2, ks0,    ks1,    ks2,     vs0,    vs1, vs2,
                 os0, os1, os2, gs0,    gs1,    gs2,     causal, window,
                 q_offset, softcap, scale};
  return int(run(p, static_cast<cudaStream_t>(stream)));
}
