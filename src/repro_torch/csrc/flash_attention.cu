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
// dtype.  Given an `lse` pointer, both kernels also write each row's
// log-sum-exp, (B, Sq, H) f32: lse = m + log(max(l, 1e-30)) with m the
// row's running max (NEG_INF for a row with no live key) and l its sum,
// as repro/models/flash_vjp.py:_fwd_blocked returns it for the backward
// (csrc/flash_attention_bwd.cu); serving passes none and stores nothing.
//
// What bounds it on the H100: at training shapes (S = 1024, D = 256) the
// work is ~4*S*S*D/2 FLOPs per (batch, head) against ~S*D*2 bytes of q and
// out, so it is bound by operations (989 TFLOP/s on bf16 tensor cores); at
// D = 64 (zamba2-1.2b) the bytes of q, k, v and out bound it.
// Two kernels.  The wrapper picks one (variant() in the Python module) and
// passes it here; the entry point checks that the chosen kernel takes the
// inputs and never substitutes the other:
//   * "wgmma" (namespace wg, the training path): bf16 with (D, Dv) in
//     WGMMA_WIDTHS (D = Dv in {64, 80, 128, 256} and MLA's D = 192 over
//     Dv = 128), 16-byte aligned bases and strides.  TMA loads into an
//     mbarrier ring, a producer warpgroup and one or two consumer
//     warpgroups, wgmma for both products.  Its design note is above the
//     namespace.
//   * "cuda_core": everything else, f32 included: CUDA-core math in f32.
// Common to both:
//   * The TPU's sequential KV grid dimension becomes a loop inside the
//     block; the grid covers (q tile, head, batch).
//   * Q, K and V tiles sit in dynamic shared memory (at D = Dv = 256 they
//     exceed the 48 KB static limit); the shared-memory attribute is set
//     once per kernel and device, not on every launch.
// The CUDA-core kernel: shared memory holds the tiles as f32, K rows padded
// by one float so the 32 lanes of a warp, each reading its own key row, hit
// 32 different banks; one lane per key of a 32-key tile, so a row's max and
// sum are warp shuffles and P never leaves registers (it is broadcast by
// shuffle into the P.V product); the (BQ, Dv) accumulator lives in
// registers, each warp owning BQ/4 rows and each lane Dv/32 columns.

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
  float* lse;  // (B, Sq, H) f32, or null
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
// LSE: whether the block writes each row's log-sum-exp.  A template
// argument, so the kernel serving launches (no lse) is compiled as if the
// store did not exist: with a runtime test instead, ptxas gave the Dv =
// 128 instantiation more registers and MLA's forward ran 12% slower on an
// H100 without writing lse.
template <typename T, int NT, bool LSE>
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
    if constexpr (LSE) {
      if (lane == 0)
        p.lse[(size_t(b) * p.Sq + q) * p.H + h] = m[r] + logf(denom);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = lane + 32 * t;
      if (c < Dv) store(O + q * p.os1 + c, acc[r][t] / denom);
    }
  }
}

template <typename T, int NT, bool LSE>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t(BQ) * p.D + size_t(BK) * (p.D + 1) +
                       size_t(BK) * p.Dv);
  cudaError_t err = set_smem<attn_fwd_kernel<T, NT, LSE>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  attn_fwd_kernel<T, NT, LSE><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  return p.lse != nullptr ? launch<T, NT, true>(p, B, stream)
                          : launch<T, NT, false>(p, B, stream);
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

// 16-byte aligned base and (batch, seq, head) strides of a bf16 tensor.
bool aligned16(const void* ptr, long long s0, long long s1, long long s2) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

// ---------------------------------------------------------------------------
// bf16 on the warpgroup tensor cores (wgmma), TMA loads, warp specialisation
// ---------------------------------------------------------------------------
//
// The training path's kernel (gemma-2b: D = Dv = 256, MQA; zamba2-1.2b:
// D = 64, H = KV = 32; qwen3-4b, granite and internvl2-2b: D = 128;
// deepseek-v3-671b's MLA: D = 192 over Dv = 128; hubert-xlarge: D = 80,
// bidirectional).  A block is one producer warpgroup and NC consumer
// warpgroups of 64 query rows each (BQ = 64 NC rows of one batch and
// head):
//   * The producer's one issuing thread loads Q once (one TMA box per 64
//     columns), then K and V tiles of BK = 64 keys into a ring of STAGES
//     slots, each slot with a "K full", a "V full" and an "empty"
//     mbarrier.  TMA writes each row of a box as 128 bytes in the 128-byte
//     swizzle that wgmma reads, zero-fills rows past Sq and Sk and columns
//     past the row's width, and counts the whole box's bytes into the full
//     barrier, zero-filled ones included (K_BYTES and V_BYTES apart: a K
//     tile is ND boxes, a V tile NV).
//   * Widths: a q or k row is ND = ceil(D / 64) boxes, a v or o row NV =
//     ceil(Dv / 64).  MLA's 192 over 128 is three boxes of Q and K and two
//     of V: S runs 12 k-steps, O is two 64-column groups (64 f32 a lane,
//     as at D = 128), in D = 128's configuration but for a fourth ring
//     slot (209 KB of shared memory: Q 48 KB + 4 x (K 24 + V 16 KB)).
//     hubert's 80 is two boxes,
//     the second zero past column 80: S runs at its own 80 (five k-steps),
//     P V over two full 64-column groups (the second's last 48 columns
//     multiply zeros: 1.6x P V's multiply-adds, as the backward pays), and
//     the epilogue stores columns below Dv only, since in a (B, S, H, 80)
//     output columns 80 to 127 are the next head's.
//   * Each consumer, per KV tile: S = Q K^T as D/16 wgmma.m64n64k16 with
//     both operands K-major in shared memory (a descriptor step of 32 bytes
//     per 16 columns, of one Q or K box per 64 columns); scale and
//     soft-cap; the mask only on tiles that cross the causal diagonal, the
//     window's lower edge or the end of the keys; the online softmax in the
//     log2 domain (log2(e) folded into the scale, exp2f), each row's max
//     reduced over its quad every tile and its sum kept per lane until the
//     end; then O += P V as wgmma.m64n64k16 with P from registers (the S
//     accumulator pairs of n-blocks 2j and 2j+1 are exactly the A fragment
//     of key chunk j, rounded to bf16) and V from shared memory as an
//     MN-major B (the transpose bit), one wgmma per 64 output columns.  O
//     stays in registers: 128 f32 a lane at Dv = 256.
//   * Inside a consumer the tiles are software-pipelined: S of tile it + 1
//     and P V of tile it are issued together, and the softmax of tile
//     it + 1 runs on the CUDA cores while P V of tile it holds the tensor
//     cores; P is packed to bf16 once that P V has completed.  No wgmma
//     sits under a branch the compiler cannot prove warp-uniform (role and
//     warp come through a shuffle from lane 0, the mbarrier poll loop is
//     one asm block, the pipeline's last tile is peeled), else ptxas
//     serialises the wgmma (C7520).
//   * A consumer whose rows see none of a tile's keys still waits for the
//     tile and releases it, so all consumers walk the ring in step.
//   * Grid (head, batch, q tile), the q tile reversed: blocks start in
//     order of their linear index, so under a causal mask the heaviest
//     tiles (whose last rows see every key) start first and the light ones
//     fill in behind.
//   * Consumers per block, measured on an H100 80GB HBM3 at 700 W by graph
//     time.  Under a causal mask the call lasts about as long as its
//     heaviest block: at gemma-2b's shape two consumers (BQ = 128) give
//     128 blocks in one wave whose last q tile carries 32 tile products on
//     one SM.  One consumer (BQ = 64) halves that block and spreads 256
//     blocks over two waves: ~25% faster at gemma-2b's shape, and with
//     three blocks an SM (80 registers at entry, rebalanced to 24 and 136)
//     ~14% faster at zamba2-1.2b's.  Where many waves of blocks run
//     (D = 128 at qwen3-4b's width, gemma-2b at B = 8) two consumers
//     sharing K and V are faster, so D = 128 keeps them (setmaxnreg 40 and
//     232).  At D = 256 one block of 256 threads has 255 registers each.
//   * Shared memory at D = 256: Q 32 KB + 3 x (K 32 KB + V 32 KB) = 224 KB,
//     one block per SM; D = 128 and 80: 32 KB + 3 x 32 KB; MLA: 48 KB + 4
//     x 40 KB; D = 64, three blocks of 8 KB + 4 x 16 KB.
//   * MLA's and hubert's configuration, measured the same way (chip_smoke
//     phase probe_attn: each configuration built from an edited copy of
//     this source, bitwise equal to the shipped one, timed in turns).  At
//     MLA's training shape two consumers with four slots beat three slots
//     by 4% and two slots by 20%; one consumer, at one or two blocks an
//     SM, was 1.6x slower.  At hubert's, three to six slots were alike and
//     two 30% slower; one consumer was 1.2x-1.4x slower.  Padding 80 to
//     128 columns in P V costs little: hubert's heads at D = 80 take 0.041
//     ms against 0.034 at 64 and 0.048 at 128, so a 16-column last group
//     (wgmma.m64n16k16, with V's last box in the 32-byte swizzle) could
//     save at most ~0.005 ms of 0.041.
// Tried on the card and not kept, as no faster at the training shapes:
// the heaviest causal q tiles split over two blocks with a combine (its
// workspace traffic cost more than the shorter critical path gained), two
// consumers taking turns at the tensor cores through named barriers
// (FA3's ping-pong), ex2.approx with the scale folded into an FFMA.
// Not done yet: a TMA store of O, a persistent grid that balances the
// causal tiles over the SMs, tiles of 128 keys (S as wgmma n128: half the
// softmax rounds and barrier waits per key at MLA's width).

namespace wg {

constexpr int BK = 64;          // keys per tile
constexpr int ROW = 128;        // bytes of one swizzled box row: 64 bf16
constexpr float LOG2E = 1.4426950408889634f;

// (D, Dv) pairs the "wgmma" kernel takes: every training head width of the
// port.  The same list as kernels/flash_attention.py WGMMA_WIDTHS and as
// csrc/flash_attention_bwd.cu's (a CPU test holds all three equal).
constexpr int WGMMA_WIDTHS[][2] = {
    {64, 64}, {80, 80}, {128, 128}, {256, 256}, {192, 128}};

template <int D, int Dv>
struct Cfg {
  static constexpr int ND = (D + 63) / 64;   // boxes of a q or k row
  static constexpr int NV = (Dv + 63) / 64;  // boxes of a v or o row
  static constexpr int KD = D / 16;          // k-steps of S over D
  // consumer warpgroups (64 query rows each), blocks per SM and ring
  // slots, chosen by measurement at the port's training shapes (see the
  // note above)
  static constexpr int NC = D == 64 || D == 256 ? 1 : 2;
  static constexpr int BLOCKS = D == 64 ? 3 : 1;
  static constexpr int STAGES = D == 64 || D == 192 ? 4 : 3;
  static constexpr int BQ = 64 * NC;
  static constexpr int THREADS = 128 * (1 + NC);
  // registers each role keeps after setmaxnreg (0: none).  Under the
  // launch bounds ptxas gives every thread ENTRY_REGS, 65536 / (THREADS x
  // BLOCKS) rounded down to a multiple of 8, and 128 x PRODUCER + 128 NC x
  // CONSUMER must equal THREADS x that: 384 x 168 with two consumers (40
  // and 232), 256 x 80 at D = 64 (24 and 136).  At D = 256 one block of
  // 256 threads has 255 each (the most a thread can hold) and needs no
  // rebalancing.  launch() refuses a build whose entry count differs
  // (check_regs).
  static constexpr int ENTRY_REGS = 65536 / (THREADS * BLOCKS) / 8 * 8;
  static constexpr int PRODUCER_REGS =
      ENTRY_REGS >= 248 ? 0 : (NC == 2 ? 40 : 24);
  static constexpr int CONSUMER_REGS =
      PRODUCER_REGS == 0
          ? 0
          : (THREADS * ENTRY_REGS - 128 * PRODUCER_REGS) / (128 * NC);
  static_assert(PRODUCER_REGS == 0 ||
                    (128 * PRODUCER_REGS + 128 * NC * CONSUMER_REGS ==
                         THREADS * ENTRY_REGS &&
                     CONSUMER_REGS % 8 == 0 && CONSUMER_REGS <= 256),
                "the setmaxnreg split must hand out exactly the entry count");
  static constexpr int Q_BYTES = ND * BQ * ROW;  // one box per 64 columns
  static constexpr int K_BYTES = ND * BK * ROW;  // one K tile
  static constexpr int V_BYTES = NV * BK * ROW;  // one V tile
  // + 1024 to align the tiles to the 1024-byte swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  static_assert(SMEM + 8 * (1 + 3 * STAGES) <= 232448,
                "shared memory of one block, its barriers included");
  static_assert(BLOCKS * (SMEM + 8 * (1 + 3 * STAGES) + 1024) <= 233472,
                "BLOCKS blocks fit an SM's shared memory (1 KB each reserved)");
  static_assert(D % 16 == 0 && Dv % 8 == 0, "k-steps of 16, stores of 8");
};

struct WgParams {
  void* o;
  float* lse;  // (B, Sq, H) f32, or null
  long long os0, os1, os2;
  int Sq, Sk, H, KV, n_qtiles;
  int causal, window, q_offset;
  float softcap, scale;
  // TMA coordinate slot (0..2) of head, seq and batch: 2 bits each
  int slots_q, slots_k, slots_v;
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

// Waits until the barrier's phase of parity `parity` has completed.  The
// poll loop is one asm block, so the compiler sees no divergent branch
// around the wgmma that follow.  A wait that never ends (a lost load, a
// miscounted arrival) traps after 2^24 polls, so such a fault surfaces as a
// launch error, not a hung card.
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

// One box (64 columns from `col`, the map's rows from `row`) of one (head,
// batch); `slots` says which TMA coordinate each of head, seq, batch is.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int slots, int col,
                                         int head, int row, int batch) {
  auto at = [&](int i) {
    return (slots & 3) == i ? head : ((slots >> 2) & 3) == i ? row : batch;
  };
  tma_load(dst, map, bar, col, at(0), at(1), at(2));
}

// wgmma shared-memory descriptor of a tile stored as 128-byte rows in the
// 128-byte swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start
// address >> 4, leading and stride byte offsets >> 4, layout 1 (128-byte
// swizzle).  Every operand here is one swizzle atom (64 bf16) wide along
// its contiguous dim, so only the stride offset is read: 1024 bytes from
// one group of 8 rows to the next.  The leading offset gets the same value,
// which is right under either reading of the two fields.
__device__ __forceinline__ unsigned long long desc(uint32_t addr) {
  return static_cast<unsigned long long>((addr >> 4) & 0x3FFF) |
         (static_cast<unsigned long long>(1024 >> 4) << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// pending (groups complete in the order they were committed).
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
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// KV tiles [*kb, *ke) holding a live key for some query position in
// [lo, hi].
__device__ __forceinline__ void kv_tiles(const WgParams& p, int lo, int hi,
                                         int nk, int* kb, int* ke) {
  *kb = 0;
  *ke = nk;
  if (p.causal) *ke = hi < 0 ? 0 : min(nk, hi / BK + 1);
  if (p.window > 0) {
    const int first = lo - p.window + 1;  // first key the top row sees
    if (first > 0) *kb = first / BK;
  }
}

// One consumer warpgroup's state and steps (64 query rows).
template <int D, int Dv>
struct Consumer {
  using C = Cfg<D, Dv>;
  float o[C::NV][32];  // O accumulator: wgmma's m64n64 layout per 64 columns
  float m[2], l[2];  // running max (log2 units) and this lane's row sums
  int qpos[2];       // positions of this lane's rows g and g + 8

  // S = Q K^T for one tile (issued, not waited for).
  __device__ __forceinline__ static void qk(float (&s)[32], uint32_t qa,
                                            uint32_t sk) {
    const unsigned long long dq = desc(qa), dk = desc(sk);
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk)
      wgmma_ss(s, dq + (((kk / 4) * C::BQ * ROW + (kk % 4) * 32) >> 4),
               dk + (((kk / 4) * BK * ROW + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();
  }

  // O += P V for one tile (issued, not waited for).
  __device__ __forceinline__ void pv(const unsigned (&pa)[4][4],
                                     uint32_t sv) {
    const unsigned long long dv = desc(sv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int n = 0; n < C::NV; ++n)
        wgmma_rs(o[n], pa[j], dv + ((n * BK * ROW + j * 16 * ROW) >> 4));
    wgmma_commit();
  }

  // Scores of the tile at key k0 -> P in f32 (in place), the factor that
  // rescales O from the previous max to the new one, and the new (m, l).
  __device__ __forceinline__ void softmax(float (&s)[32], int k0, int pos0,
                                          int tig, const WgParams& p,
                                          float (&corr)[2]) {
    // scale and soft-cap, in log2 units
    if (p.softcap > 0.f) {
      const float mul = p.scale / p.softcap, cap = p.softcap * LOG2E;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * mul) * cap;
    } else {
      const float mul = p.scale * LOG2E;
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= mul;
    }
    // the mask, only where the tile crosses the end of the keys, the
    // causal diagonal or the window's lower edge for some row
    if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > pos0) ||
        (p.window > 0 && k0 <= pos0 + 63 - p.window)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i & 1);
        const int qp = qpos[(i >> 1) & 1];
        bool live = kpos < p.Sk;
        if (p.causal) live = live && kpos <= qp;
        if (p.window > 0) live = live && kpos > qp - p.window;
        if (!live) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF}, base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no live key yet keeps exp2(NEG_INF - 0) = 0
      base[r] = m_new == NEG_INF ? 0.f : m_new;
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - base[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  }

  // P as bf16 A fragments: the S accumulator pairs of n-blocks 2j and
  // 2j + 1 are the A fragment of key chunk j.
  __device__ __forceinline__ static void pack(const float (&s)[32],
                                              unsigned (&pa)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pa[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pa[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pa[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pa[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  }

  __device__ __forceinline__ void rescale(const float (&corr)[2]) {
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[n][i] *= corr[(i >> 1) & 1];
  }
};

template <int D, int Dv>
__global__ void __launch_bounds__(Cfg<D, Dv>::THREADS, Cfg<D, Dv>::BLOCKS)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const WgParams p) {
  using C = Cfg<D, Dv>;
  constexpr int ND = C::ND, NV = C::NV, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // Q full, then per slot: K full, V full, empty
  __shared__ __align__(8) unsigned long long bars[1 + 3 * STAGES];

  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + C::Q_BYTES;  // slot s: K, then V
  const uint32_t bar_q = smem_u32(bars);
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };
  auto slot_k = [&](int it) {
    return sKV + (it % STAGES) * (C::K_BYTES + C::V_BYTES);
  };
  auto slot_v = [&](int it) { return slot_k(it) + C::K_BYTES; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (p.n_qtiles - 1 - int(blockIdx.z)) * C::BQ;
  const int nk = (p.Sk + BK - 1) / BK;
  int kb, ke;
  kv_tiles(p, p.q_offset + q0, p.q_offset + min(q0 + C::BQ, p.Sq) - 1, nk, &kb,
           &ke);
  const int n_tiles = max(ke - kb, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 4 * C::NC);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup and warp indices through a shuffle from lane 0, so the
  // compiler knows them to be warp-uniform (as CUTLASS does): branches on
  // them are not divergent paths around the wgmma
  const int wg = __shfl_sync(FULL, int(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    if constexpr (C::PRODUCER_REGS > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KV);
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll 1
      for (int j = 0; j < ND; ++j)
        load_box(sQ + j * C::BQ * ROW, &tm_q, bar_q, p.slots_q, 64 * j, h, q0,
                 b);
#pragma unroll 1
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES, k0 = (kb + it) * BK;
        mbar_wait(bar_e(s), ((it / STAGES) & 1) ^ 1);
        const uint32_t sk = slot_k(it);
        mbar_expect_tx(bar_k(s), C::K_BYTES);
#pragma unroll 1
        for (int j = 0; j < ND; ++j)
          load_box(sk + j * BK * ROW, &tm_k, bar_k(s), p.slots_k, 64 * j, kvh,
                   k0, b);
        const uint32_t sv = slot_v(it);
        mbar_expect_tx(bar_v(s), C::V_BYTES);
#pragma unroll 1
        for (int j = 0; j < NV; ++j)
          load_box(sv + j * BK * ROW, &tm_v, bar_v(s), p.slots_v, 64 * j, kvh,
                   k0, b);
      }
    }
  } else {
    // ---- consumers ----
    if constexpr (C::CONSUMER_REGS > 0)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::CONSUMER_REGS));
    const int c = wg - 1;
    const int warp = __shfl_sync(FULL, int(threadIdx.x) / 32 % 4, 0);
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;
    const int row0 = q0 + 64 * c;  // this consumer's first query row
    const int pos0 = p.q_offset + row0;
    const uint32_t qa = sQ + c * 64 * ROW;
    int cb = 0, ce = 0;
    if (row0 < p.Sq)
      kv_tiles(p, pos0, p.q_offset + min(row0 + 64, p.Sq) - 1, nk, &cb, &ce);
    // this consumer's live tiles are [lo, hi) of the block's n_tiles
    const int lo = min(max(cb - kb, 0), n_tiles);
    const int hi = max(min(ce - kb, n_tiles), lo);
    auto wait_k = [&](int it) { mbar_wait(bar_k(it % STAGES), (it / STAGES) & 1); };
    auto wait_v = [&](int it) { mbar_wait(bar_v(it % STAGES), (it / STAGES) & 1); };
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(bar_e(it % STAGES));
    };

    Consumer<D, Dv> st;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) st.o[n][i] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;
    st.qpos[0] = pos0 + warp * 16 + g;
    st.qpos[1] = st.qpos[0] + 8;

    mbar_wait(bar_q, 0);
    int it = 0;
    for (; it < lo; ++it) {  // tiles no row of this consumer sees
      wait_k(it);
      wait_v(it);
      release(it);
    }
    if (it < hi) {
      // Software pipeline: tile it's P V runs on the tensor cores while
      // the softmax of tile it + 1 runs beside it; P is packed to bf16
      // once P V of the tile before has completed.
      float s[32];
      unsigned pa[4][4];
      float corr[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wait_k(it);
      wgmma_fence();
      Consumer<D, Dv>::qk(s, qa, slot_k(it));
      wgmma_wait<0>();
      fence_regs(s);
      st.softmax(s, (kb + it) * BK, pos0, tig, p, corr);
      Consumer<D, Dv>::pack(s, pa);
      for (; it + 1 < hi; ++it) {
        wait_k(it + 1);
        wait_v(it);
        wgmma_fence();
        Consumer<D, Dv>::qk(s, qa, slot_k(it + 1));
        st.pv(pa, slot_v(it));
        wgmma_wait<1>();  // S of tile it + 1; P V of tile it may run on
        fence_regs(s);
        st.softmax(s, (kb + it + 1) * BK, pos0, tig, p, corr);
        wgmma_wait<0>();
#pragma unroll
        for (int n = 0; n < NV; ++n) fence_regs(st.o[n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_regs(pa[j]);
        release(it);
        st.rescale(corr);
        Consumer<D, Dv>::pack(s, pa);
      }
      // the last live tile: P V alone
      wait_v(it);
      wgmma_fence();
      st.pv(pa, slot_v(it));
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < NV; ++n) fence_regs(st.o[n]);
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(pa[j]);
      release(it);
      ++it;
    }
    for (; it < n_tiles; ++it) {
      wait_k(it);
      wait_v(it);
      release(it);
    }

    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.os0 +
                       h * p.os2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = st.l[r];
      l += __shfl_xor_sync(FULL, l, 1);
      l += __shfl_xor_sync(FULL, l, 2);
      const int row = row0 + warp * 16 + g + 8 * r;
      if (row >= p.Sq) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      // m is in log2 units; a row with no live key keeps NEG_INF as is
      if (p.lse != nullptr && tig == 0)
        p.lse[(size_t(b) * p.Sq + row) * p.H + h] =
            (st.m[r] == NEG_INF ? NEG_INF : st.m[r] * (1.f / LOG2E)) +
            logf(fmaxf(l, 1e-30f));
      // columns up to Dv only: at Dv = 80 the second group's columns 80
      // to 127 are the padding's zeros, and in a (B, S, H, 80) output the
      // next head's place
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (64 * n + 8 * j < Dv)
            *reinterpret_cast<__nv_bfloat162*>(O + row * p.os1 + 64 * n +
                                               8 * j + 2 * tig) =
                __floats2bfloat162_rn(st.o[n][4 * j + 2 * r] * inv,
                                      st.o[n][4 * j + 2 * r + 1] * inv);
    }
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
// boxes of 64 columns x `rows` rows of one head and batch, in the 128-byte
// swizzle, zero fill past the end (past `width` too: a row of 80 reads as
// two boxes).  The three outer dims go to TMA in
// increasing order of stride (a dim of size 1 last, with the stride that
// follows the one before it, as it is never stepped); `slots` records which
// TMA coordinate each of head, seq and batch became, 2 bits each.
bool make_map(CUtensorMap* map, const void* ptr, int width,
              const long long* ext, const long long* stride, int rows,
              int* slots) {
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
    box[i + 1] = w == 1 ? cuuint32_t(rows) : 1;
    *slots |= i << (2 * w);
    prev = bytes * ext[w];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 (checked by the entry), (D, Dv) in WGMMA_WIDTHS, at least one key,
// 16-byte aligned bases and (batch, seq, head) strides of q, k, v and o.
bool takes(const Params& p) {
  bool width = false;
  for (const auto& w : WGMMA_WIDTHS) width |= p.D == w[0] && p.Dv == w[1];
  return width && p.Sk > 0 && aligned16(p.q, p.qs0, p.qs1, p.qs2) &&
         aligned16(p.k, p.ks0, p.ks1, p.ks2) &&
         aligned16(p.v, p.vs0, p.vs1, p.vs2) &&
         aligned16(p.o, p.os0, p.os1, p.os2);
}

// setmaxnreg only moves registers between the warpgroups of a block: a
// consumer's setmaxnreg.inc waits until the producer has released enough of
// the block's own registers.  If ptxas gave the kernel another count than
// ENTRY_REGS, the split does not add up and the consumers would wait until
// the barrier poll traps, so such a build is refused before any launch.
// Checked once per instantiation (the count is the binary's, the same on
// every device).
template <int D, int Dv>
cudaError_t check_regs() {
  if constexpr (Cfg<D, Dv>::PRODUCER_REGS == 0) {
    return cudaSuccess;
  } else {
    static std::atomic<bool> ok{false};
    if (ok.load()) return cudaSuccess;
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, attn_fwd_wgmma_kernel<D, Dv>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs != Cfg<D, Dv>::ENTRY_REGS)
      return cudaErrorInvalidKernelImage;
    ok.store(true);
    return cudaSuccess;
  }
}

template <int D, int Dv>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<D, Dv>;
  cudaError_t err = check_regs<D, Dv>();
  if (err != cudaSuccess) return err;
  WgParams w{p.o,     p.lse,  p.os0,  p.os1,      p.os2,  p.Sq,   p.Sk,
             p.H,     p.KV,   (p.Sq + C::BQ - 1) / C::BQ, p.causal,
             p.window,
             p.q_offset, p.softcap, p.scale, 0, 0, 0};
  if (B > 65535 || w.n_qtiles > 65535) return cudaErrorInvalidValue;
  const long long qe[3] = {p.H, p.Sq, B}, qs[3] = {p.qs2, p.qs1, p.qs0};
  const long long ke[3] = {p.KV, p.Sk, B}, ks[3] = {p.ks2, p.ks1, p.ks0};
  const long long vs[3] = {p.vs2, p.vs1, p.vs0};
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, D, qe, qs, C::BQ, &w.slots_q) ||
      !make_map(&tk, p.k, D, ke, ks, BK, &w.slots_k) ||
      !make_map(&tv, p.v, Dv, ke, vs, BK, &w.slots_v))
    return cudaErrorInvalidValue;
  err = set_smem<attn_fwd_wgmma_kernel<D, Dv>>(C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B, w.n_qtiles);
  attn_fwd_wgmma_kernel<D, Dv><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, w);
  return cudaGetLastError();
}

// One instantiation per pair of WGMMA_WIDTHS (takes() has checked it).
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  switch (p.D) {
    case 64: return launch<64, 64>(p, B, stream);
    case 80: return launch<80, 80>(p, B, stream);
    case 128: return launch<128, 128>(p, B, stream);
    case 192: return launch<192, 128>(p, B, stream);
    default: return launch<256, 256>(p, B, stream);
  }
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = CUDA-core, 1 = wgmma, as
// chosen by the wrapper; a variant that cannot take the inputs returns
// cudaErrorInvalidValue and launches nothing.  `lse` is null or a
// contiguous (B, Sq, H) f32 buffer.  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype,
    int variant, int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    long long qs0, long long qs1, long long qs2, long long ks0, long long ks1,
    long long ks2, long long vs0, long long vs1, long long vs2, long long os0,
    long long os1, long long os2, int causal, int window, float softcap,
    int q_offset, float scale, void* stream) {
  if (D < 1 || D > 256 || Dv < 1 || Dv > 256 || KV < 1 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Params p{q,   k,   v,   o,   lse, Sq,  Sk,  H,   KV,     D,      Dv,     qs0,
           qs1, qs2, ks0, ks1, ks2, vs0, vs1, vs2,    os0,    os1,      os2,
           causal, window, q_offset, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      return int(dtype == 0 ? dispatch<float>(p, B, s)
                            : dispatch<__nv_bfloat16>(p, B, s));
    case 1:
      if (dtype != 1 || !wg::takes(p)) return int(cudaErrorInvalidValue);
      return int(wg::dispatch(p, B, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}
