// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// entry point bound through ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd -> _attn_kernel.  Same function: GQA/MQA (query head
// h reads KV head h*KV/H), scores scaled by 1/sqrt(D) with an optional tanh
// soft-cap, causal and sliding-window masks with q_offset, KV padding, an
// online softmax over f32 (acc, m, l) state, dead KV tiles skipped, fully
// masked rows giving exactly 0 (finite NEG_INF = -1e30 and max(l, 1e-30),
// as in the Pallas kernel).  Inputs f32 or bf16, f32 math, output in q's
// dtype.
//
// What bounds it on the H100: at training shapes (S = 1024, D = 256) the
// work is ~4*S*S*D/2 FLOPs per (batch, head) against ~S*D*2 bytes of q and
// out, so it is bound by operations (989 TFLOP/s on bf16 tensor cores).
// Two kernels, chosen in the C entry point from the inputs:
//   * bf16 with D % 16 == 0 and Dv in {32, 64, 128, 256} (the training
//     path): tensor cores through mma.sync (see the tc namespace below).
//   * everything else, f32 included: a CUDA-core kernel in f32.
// Common to both:
//   * The TPU's sequential KV grid dimension becomes a loop inside the
//     block; the grid is (q tile, head, batch).
//   * Q, K and V tiles sit in dynamic shared memory (at D = Dv = 256 they
//     exceed the 48 KB static limit).
// The CUDA-core kernel: shared memory holds the tiles as f32, K rows padded
// by one float so the 32 lanes of a warp, each reading its own key row, hit
// 32 different banks; one lane per key of a 32-key tile, so a row's max and
// sum are warp shuffles and P never leaves registers (it is broadcast by
// shuffle into the P.V product); the (BQ, Dv) accumulator lives in
// registers, each warp owning BQ/4 rows and each lane Dv/32 columns.
// Not done yet: wgmma, TMA loads, and loads overlapped with the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;                // query rows per block
constexpr int BK = 32;                // keys per tile: one per lane
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;     // query rows per warp
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, H, KV, D, Dv;
  // strides in elements of dims 0..2 (batch, seq, head); dim 3 is contiguous
  long long qs0, qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2, os0, os1, os2;
  int causal, window, q_offset;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// NT = number of 32-wide column groups of Dv held per lane (ceil(Dv / 32)).
template <typename T, int NT>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv, DP = p.D + 1;
  float* sQ = smem;                   // BQ x D
  float* sK = sQ + BQ * D;            // BK x (D + 1)
  float* sV = sK + BK * DP;           // BK x Dv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * p.KV / p.H;
  const T* Q = static_cast<const T*>(p.q) + b * p.qs0 + h * p.qs2;
  const T* K = static_cast<const T*>(p.k) + b * p.ks0 + kvh * p.ks2;
  const T* V = static_cast<const T*>(p.v) + b * p.vs0 + kvh * p.vs2;
  T* O = static_cast<T*>(p.o) + b * p.os0 + h * p.os2;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i - r * D, q = q0 + r;
    sQ[i] = q < p.Sq ? to_f32(Q[q * p.qs1 + d]) : 0.f;
  }

  float acc[ROWS][NT];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;
  }

  // KV tiles that can hold a live key for some row of this block.
  const int q_lo = p.q_offset + q0, q_hi = q_lo + BQ - 1;
  int kt_begin = 0, kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = q_hi < 0 ? 0 : min(kt_end, q_hi / BK + 1);
  if (p.window > 0) {
    const int first = q_lo - p.window + 1;  // first key the top row sees
    if (first > 0) kt_begin = first / BK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i - r * D, kk = k0 + r;
      sK[r * DP + d] = kk < p.Sk ? to_f32(K[kk * p.ks1 + d]) : 0.f;
    }
    for (int i = tid; i < BK * Dv; i += NTHREADS) {
      const int r = i / Dv, c = i - r * Dv, kk = k0 + r;
      sV[i] = kk < p.Sk ? to_f32(V[kk * p.vs1 + c]) : 0.f;
    }
    __syncthreads();

    // s[r] = q[row r of this warp] . k[key `lane`]
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = sK + lane * DP;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] += sQ[(r * NWARPS + warp) * D + d] * kd;
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q_lo + r * NWARPS + warp;
      bool live = kpos < p.Sk;
      if (p.causal) live = live && kpos <= qpos;
      if (p.window > 0) live = live && kpos > qpos - p.window;
      float x = s[r] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      x = live ? x : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - m_new);
      const float pr = live ? expf(x - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(pr);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] *= corr;
      s[r] = pr;
    }

    // acc[r][c] += sum_j p[r][j] * v[j][c]; p[r][j] lives in lane j.
    for (int j = 0; j < BK; ++j) {
      float pj[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) pj[r] = __shfl_sync(FULL, s[r], j);
      const float* vrow = sV + j * Dv;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = lane + 32 * t;
        const float vv = c < Dv ? vrow[c] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][t] += pj[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int q = q0 + r * NWARPS + warp;
    if (q >= p.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = lane + 32 * t;
      if (c < Dv) store(O + q * p.os1 + c, acc[r][t] / denom);
    }
  }
}

template <typename T, int NT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(BQ) * p.D + size_t(BK) * (p.D + 1) +
                       size_t(BK) * p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  attn_fwd_kernel<T, NT><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  switch ((p.Dv + 31) / 32) {
    case 1: return launch<T, 1>(p, B, stream);
    case 2: return launch<T, 2>(p, B, stream);
    case 3: return launch<T, 3>(p, B, stream);
    case 4: return launch<T, 4>(p, B, stream);
    case 5: return launch<T, 5>(p, B, stream);
    case 6: return launch<T, 6>(p, B, stream);
    case 7: return launch<T, 7>(p, B, stream);
    case 8: return launch<T, 8>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------
//
// The training path's kernel (gemma-2b: bf16, D = Dv = 256).  Each of the
// four warps owns 16 query rows of a 64-row tile and walks 64-key tiles:
// S = Q K^T on the tensor cores from ldmatrix fragments, the mask and the
// online softmax on S's accumulator fragments (a row lives in the 4 lanes
// of a quad), then P (rounded to bf16, as the operand of a bf16 product)
// times V with V's fragments read transposed by ldmatrix.trans.  O stays in
// registers (Dv/8 fragments of 4 floats per lane).  Rows of shared memory
// are padded by 16 bytes so the 8 rows an ldmatrix reads sit in distinct
// banks.  Loads are 16-byte vectors, not yet overlapped with the products.

namespace tc {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;
constexpr int PAD = 8;  // bf16 elements of row padding

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows x cols bf16 from global (row stride `stride` elements) into shared
// memory (row stride cols + PAD); rows at or past `valid` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int cols, int valid) {
  const int chunks = cols / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += NTHREADS) {
    const int r = c / chunks, j = (c - r * chunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * stride + j);
    *reinterpret_cast<uint4*>(dst + r * (cols + PAD) + j) = v;
  }
}

// NDV = Dv / 8 output fragments per lane.
template <int NDV>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int DV = NDV * 8;
  const int D = p.D, LDK = p.D + PAD;
  constexpr int LDV = DV + PAD;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDK;
  __nv_bfloat16* sV = sK + BK * LDK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h * p.KV / p.H;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.qs0 + h * p.qs2;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.ks0 + kvh * p.ks2;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.vs0 + kvh * p.vs2;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.os0 + h * p.os2;

  load_tile(sQ, Q + q0 * p.qs1, p.qs1, BQ, D, p.Sq - q0);

  float o[NDV][4];
#pragma unroll
  for (int t = 0; t < NDV; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int q_lo = p.q_offset + q0, q_hi = q_lo + BQ - 1;
  int kt_begin = 0, kt_end = (p.Sk + BK - 1) / BK;
  if (p.causal) kt_end = q_hi < 0 ? 0 : min(kt_end, q_hi / BK + 1);
  if (p.window > 0) {
    const int first = q_lo - p.window + 1;
    if (first > 0) kt_begin = first / BK;
  }
  // this lane's two query rows
  const int row0 = warp * 16 + g;
  const int qpos[2] = {q_lo + row0, q_lo + row0 + 8};

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(sK, K + k0 * p.ks1, p.ks1, BK, D, p.Sk - k0);
    load_tile(sV, V + k0 * p.vs1, p.vs1, BK, DV, p.Sk - k0);
    __syncthreads();

    // S (16 x 64 per warp) = Q K^T
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LDK + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        unsigned bk[4];
        ldsm_x4(bk, sK + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * LDK + kk +
                        ((lane >> 3) & 1) * 8);
        mma(s[j], a, bk[0], bk[1]);
        mma(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask, scale, soft-cap; online softmax per row (rows g and g + 8)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
        bool live = kpos < p.Sk;
        if (p.causal) live = live && kpos <= qpos[hr];
        if (p.window > 0) live = live && kpos > qpos[hr] - p.window;
        float x = s[j][e] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        x = live ? x : NEG_INF;
        s[j][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(FULL, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(FULL, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float x = s[j][e];
        const float pr = x == NEG_INF ? 0.f : expf(x - m[hr]);
        s[j][e] = pr;
        sum[hr] += pr;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(FULL, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(FULL, sum[hr], 2);
      l[hr] = l[hr] * corr[hr] + sum[hr];
    }
#pragma unroll
    for (int t = 0; t < NDV; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V, 16 keys at a time
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const unsigned a[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                             pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                             pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int t = 0; t < NDV; t += 2) {
        unsigned bv[4];
        ldsm_x4_trans(bv, sV + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   LDV + t * 8 + (lane >> 4) * 8);
        mma(o[t], a, bv[0], bv[1]);
        mma(o[t + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = q0 + row0 + hr * 8;
    if (q >= p.Sq) continue;
    const float denom = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int t = 0; t < NDV; ++t) {
      const int c = t * 8 + tig * 2;
      O[q * p.os1 + c] = __float2bfloat16_rn(o[t][2 * hr] / denom);
      O[q * p.os1 + c + 1] = __float2bfloat16_rn(o[t][2 * hr + 1] / denom);
    }
  }
}

template <int NDV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t(BQ + BK) * (p.D + PAD) + size_t(BK) * (NDV * 8 + PAD));
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_tc_kernel<NDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  attn_fwd_tc_kernel<NDV><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

// The tensor-core kernel takes bf16 with D a multiple of 16, Dv one of
// 32/64/128/256, and 16-byte aligned rows; anything else goes to the
// CUDA-core kernel above.
cudaError_t try_launch(const Params& p, int B, cudaStream_t stream,
                       bool* taken) {
  *taken = false;
  if (p.D % 16 != 0 || !aligned16(p.q, p.qs0, p.qs1, p.qs2) ||
      !aligned16(p.k, p.ks0, p.ks1, p.ks2) ||
      !aligned16(p.v, p.vs0, p.vs1, p.vs2))
    return cudaSuccess;
  *taken = true;
  switch (p.Dv) {
    case 32: return launch<4>(p, B, stream);
    case 64: return launch<8>(p, B, stream);
    case 128: return launch<16>(p, B, stream);
    case 256: return launch<32>(p, B, stream);
    default: *taken = false; return cudaSuccess;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int KV, int D, int Dv, long long qs0,
    long long qs1, long long qs2, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, long long os0, long long os1,
    long long os2, int causal, int window, float softcap, int q_offset,
    float scale, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0)
    return int(cudaErrorInvalidValue);
  Params p{q,   k,   v,   o,   Sq,  Sk,  H,   KV,     D,      Dv,       qs0,
           qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,    os0,    os1,      os2,
           causal, window, q_offset, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return int(dispatch<float>(p, B, s));
  if (dtype != 1) return int(cudaErrorInvalidValue);
  bool taken = false;
  cudaError_t err = tc::try_launch(p, B, s, &taken);
  return int(taken ? err : dispatch<__nv_bfloat16>(p, B, s));
}
