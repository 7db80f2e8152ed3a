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
// (f32) the bytes take ~5-20x longer than the arithmetic.  Little's law at
// ~1 us of HBM latency asks for ~25 KB in flight on every SM.
//
// Two variants behind one C entry; the wrapper's variant() picks one from
// the inputs' layout and the entry launches it or refuses the inputs
// (cudaErrorInvalidValue, before any launch).  Nothing falls back.
//
// "bulk" (16-byte aligned x, g and scale, row strides and d a multiple of
// 16 bytes, rows up to BULK_MAX_WARPS * 32 * BULK_MAX_PPL packs):
//   * x and g are read from HBM once, by Hopper's 1-D bulk copy
//     (cp.async.bulk ... mbarrier::complete_tx::bytes) into a ring of
//     BULK_STAGES shared-memory stages of about BULK_STAGE_BYTES each (at
//     least one row a row group), one mbarrier and one expect_tx count a
//     stage.  Warp 0 starts the copies (one copy a tensor for contiguous
//     rows, one a row otherwise: MLA's kv_norm slice is read in place),
//     every thread computes, and a stage is refilled once the block has
//     finished with it.  The row is read from shared memory for its two
//     sums and again for dx, stored with 16-byte stores.
//   * A persistent grid: BULK_BLOCKS_PER_SM blocks on each of the WAVE
//     SMs at most, in clusters of BULK_CLUSTER; each block takes a
//     contiguous run of rows, no block more than one row more than
//     another.  A row is "lanes" threads, one 16-byte pack of x a lane
//     (d / 8 lanes in bf16, d / 4 in f32; sub-warp rows in a power of two
//     of lanes, so at d = 128 bf16 two rows share a warp with no idle
//     lane), or BULK_PPL packs a lane over whole warps once the row passes
//     a warp.  The row's sums: fixed-order shuffles, then, where a row
//     spans warps, the warps' sums in warp order behind one named barrier
//     for the row's group of warps.
//   * scale is loaded once a block, into registers, with vector loads.
//   * dscale without atomics: each thread keeps the f32 sum of its columns
//     over every row it visits, in row order, in registers; the block sums
//     its row groups in group order; the blocks of a cluster sum the
//     block rows in rank order over distributed shared memory, each rank a
//     slice of the columns, into one f32 row a cluster of the workspace.
//   * The constants are measured ones (chip_smoke.py's probe_rms_bwd, on an
//     H100 80GB HBM3 at 700 W): 2 stages of 24 KB against 3-4 of 16-32 KB
//     (qwen3-4b's q-norm 2x1024x32x128 ~15% faster, the d = 2048 norms
//     within noise), clusters of 2 against 1, 4 and 8 (~1-3 us faster: 1
//     doubles the workspace, 4 and 8 were slower at every training
//     shape), 2 blocks an SM against 1 and 3, BULK_PPL 2 against 1 and 4,
//     256 threads against 128 and 512, warp 0 issuing against a producer
//     warp of its own.
// "direct" (every other input: a misaligned base or stride, d not a
// multiple of 16 bytes, rows too wide for a stage): the first version.  A
// warp per row for d <= DIRECT_WARP_ROW_MAX_D (8 row groups a block), the
// whole block of 256 threads per row above, at most DIRECT_MAX_BLOCKS
// blocks; every thread loads its elements itself (16-byte loads where
// aligned, scalar otherwise) and reads the row twice (the second time from
// L1/L2); each block writes one f32 partial dscale row to the workspace.
//
// Both variants end with one launch that sums the workspace's rows column
// by column: SUM_CHUNKS fixed runs of rows, each in row order, then the
// runs in order, SUM_COLS columns a block.  It is a programmatic dependent
// launch: "bulk" lets it be scheduled at its start, and it waits for the
// dx kernel's end (griddepcontrol.wait), which hides its launch (~1 us).
// The grid and every summation order depend on (rows, d, dtype) alone, so
// the same inputs give the same bits on every run.  Products are rounded
// one at a time in the plain version's order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARP = 32;
constexpr int WAVE = 132;                 // SMs of an H100 SXM
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int SMEM_MAX = 227 * 1024;
// variant codes (kernels/rmsnorm_bwd.py VARIANTS)
constexpr int VARIANT_DIRECT = 0;
constexpr int VARIANT_BULK = 1;

// "bulk" (kernels/rmsnorm_bwd.py carries the same numbers; a CPU test
// parses them)
constexpr int BULK_THREADS = 256;         // threads a block, at most
constexpr int BULK_PPL = 2;               // 16-byte packs a lane past a warp
constexpr int BULK_MAX_WARPS = 8;         // warps a row, at most
constexpr int BULK_MAX_PPL = 4;           // packs a lane, at most
constexpr int BULK_STAGES = 2;            // ring stages
constexpr int BULK_STAGE_BYTES = 24576;   // x and g bytes a stage, at least a row group
constexpr int BULK_BLOCKS_PER_SM = 2;
constexpr int BULK_CLUSTER = 2;           // blocks a cluster
constexpr int BULK_DATA_OFFSET = 128;     // the stages start past the mbarriers
// "direct"
constexpr int DIRECT_THREADS = 256;
constexpr int DIRECT_WARP_ROW_MAX_D = 1024;   // above this, one block per row
constexpr int DIRECT_MAX_BLOCKS = 528;        // 4 per SM
// the column sums of the workspace
constexpr int SUM_COLS = 32;
constexpr int SUM_CHUNKS = 16;

constexpr int DIRECT_WARPS = DIRECT_THREADS / WARP;
static_assert(8 * BULK_STAGES <= BULK_DATA_OFFSET,
              "the ring's mbarriers fit ahead of the stages");
// a "bulk" block is BULK_THREADS threads, or one row of up to
// BULK_MAX_WARPS warps where a row needs more
constexpr int BULK_MAX_THREADS = BULK_THREADS > BULK_MAX_WARPS * WARP
                                     ? BULK_THREADS
                                     : BULK_MAX_WARPS * WARP;

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

// Butterfly over the `width` lanes of a lane's segment (a power of two up
// to the warp): at every step lanes i and i^off add the same two values, so
// all lanes of a segment end with the same sum.
__device__ __forceinline__ float seg_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  return seg_sum(v, WARP);
}

// One element of the second pass: returns dx and adds (g * x) * r to the
// column's accumulator.
template <typename TX>
__device__ __forceinline__ TX dx_one(float xv, float gv, float s, float r,
                                     float r3, float dot, float* acc) {
  const float gs = __fmul_rn(gv, s);
  *acc = __fadd_rn(*acc, __fmul_rn(__fmul_rn(gv, xv), r));
  return from_f32<TX>(
      __fsub_rn(__fmul_rn(r, gs), __fmul_rn(__fmul_rn(xv, r3), dot)));
}

// ---------------------------------------------------------------------------
// The plans.  The wrapper's plan() mirrors both; repro_rmsnorm_bwd_plan
// exports them so the card can hold the two against each other.
// ---------------------------------------------------------------------------

struct Plan {
  long long grid;
  int threads, lanes, rows_per_stage, stages, cluster;
  long long ws_rows, smem;
  int ppl, groups, rpg, warps;   // "bulk" only
};

int direct_plan(long long rows, int d, Plan* p) {
  if (rows < 1 || d < 1) return int(cudaErrorInvalidValue);
  const int lanes = d <= DIRECT_WARP_ROW_MAX_D ? WARP : DIRECT_THREADS;
  const int groups = DIRECT_THREADS / lanes;
  long long blocks = (rows + groups - 1) / groups;
  if (blocks > DIRECT_MAX_BLOCKS) blocks = DIRECT_MAX_BLOCKS;
  *p = Plan{blocks, DIRECT_THREADS, lanes, 0, 0, 1, blocks,
            4LL * groups * d, 1, groups, 0, 0};
  return p->smem > SMEM_MAX ? int(cudaErrorInvalidValue) : 0;
}

int bulk_plan(long long rows, int d, int elt, Plan* p) {
  const int V = 16 / elt;
  if (rows < 1 || d < 1 || d % V) return int(cudaErrorInvalidValue);
  const int packs = d / V;
  int lanes = 1, ppl = 1;
  if (packs <= WARP) {
    while (lanes < packs) lanes *= 2;
  } else {
    ppl = BULK_PPL;
    while (packs > WARP * BULK_MAX_WARPS * ppl) ppl *= 2;
    if (ppl > BULK_MAX_PPL) return int(cudaErrorInvalidValue);
    lanes = WARP * ((packs + WARP * ppl - 1) / (WARP * ppl));
  }
  int groups = BULK_THREADS / lanes;
  if (groups < 1) groups = 1;
  const long long row_bytes = 2LL * d * elt;            // x and g
  long long rpg = BULK_STAGE_BYTES / (groups * row_bytes);
  if (rpg < 1) rpg = 1;
  const int rps = int(groups * rpg);
  const int warps = (lanes + WARP - 1) / WARP;
  const long long smem = BULK_DATA_OFFSET + BULK_STAGES * rps * row_bytes +
                         8LL * rps * warps;
  long long blocks = (rows + rps - 1) / rps;
  if (blocks > (long long)WAVE * BULK_BLOCKS_PER_SM)
    blocks = (long long)WAVE * BULK_BLOCKS_PER_SM;
  blocks = (blocks + BULK_CLUSTER - 1) / BULK_CLUSTER * BULK_CLUSTER;
  *p = Plan{blocks, groups * lanes, lanes, rps, BULK_STAGES, BULK_CLUSTER,
            blocks / BULK_CLUSTER, smem, ppl, groups, int(rpg), warps};
  return smem > SMEM_MAX ? int(cudaErrorInvalidValue) : 0;
}

// ---------------------------------------------------------------------------
// "bulk"
// ---------------------------------------------------------------------------

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

// Waits until the barrier's phase of parity `parity` has completed.  A wait
// that never ends (a lost copy, a wrong byte count) traps after 2^24 polls,
// so such a fault surfaces as a launch error, not a hung card.
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

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// n rows of `row_bytes` from `src` (row stride `stride` bytes) into
// consecutive rows at `dst`, started by the lanes of one warp: one copy when
// the rows are contiguous, one a row otherwise.
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          long long stride, int n,
                                          long long row_bytes, uint32_t bar,
                                          int lane) {
  if (stride == row_bytes) {
    if (lane == 0) bulk_copy(dst, src, uint32_t(n * row_bytes), bar);
  } else {
    for (int i = lane; i < n; i += WARP)
      bulk_copy(dst + uint32_t(i * row_bytes), src + i * stride,
                uint32_t(row_bytes), bar);
  }
}

// V values of scale from a 16-byte aligned run (V * sizeof(TS) = 8, 16 or
// 32 bytes) with vector loads.
template <typename TS, int V>
__device__ __forceinline__ void load_scale(const TS* p, float (&out)[V]) {
  constexpr int BYTES = V * int(sizeof(TS));
  if constexpr (BYTES % 16 == 0) {
    uint4 raw[BYTES / 16];
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const TS* v = reinterpret_cast<const TS*>(raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(v[j]);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const TS* v = reinterpret_cast<const TS*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(v[j]);
  }
}

struct BulkArgs {
  int lanes, groups, rpg, warps;
};

// PPL packs a lane (1, 2 or 4).  Shared memory: BULK_STAGES mbarriers, then
// from BULK_DATA_OFFSET the stages (rows_per_stage rows of x, then as many
// of g), then the row sums of warps ([rows_per_stage][warps][2] f32).
template <typename TX, typename TS, int PPL>
__global__ void __launch_bounds__(BULK_MAX_THREADS)
    rmsnorm_bwd_bulk(const TX* __restrict__ x, long long sx,
                     const TX* __restrict__ g, long long sg,
                     const TS* __restrict__ scale, TX* __restrict__ dx,
                     float* __restrict__ ws, long long rows, int d,
                     float eps, BulkArgs a) {
  constexpr int V = Pack<TX>::N;
  constexpr int S = BULK_STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = a.lanes, G = a.groups, W = a.warps;
  const int rps = G * a.rpg;
  const int grp = threadIdx.x / L, t = threadIdx.x % L;
  const int lane = threadIdx.x % WARP, wig = t / WARP;
  const int packs = d / V;
  const long long row_b = static_cast<long long>(d) * sizeof(TX);
  const long long stage_b = 2LL * rps * row_b;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* data = smem + BULK_DATA_OFFSET;
  float* part = reinterpret_cast<float*>(data + S * stage_b);

  // this block's rows: a contiguous run, one more row for the first
  // rows % gridDim.x blocks
  const long long nb = gridDim.x, b = blockIdx.x;
  const long long base = rows / nb, extra = rows % nb;
  const long long r0 = b * base + (b < extra ? b : extra);
  const long long nr = base + (b < extra ? 1 : 0);
  const long long nst = (nr + rps - 1) / rps;

  float sc[PPL][V], acc[PPL][V];
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int p = t + k * L;
#pragma unroll
    for (int j = 0; j < V; ++j) sc[k][j] = acc[k][j] = 0.f;
    if (p < packs) load_scale<TS, V>(scale + p * V, sc[k]);
  }

  // the column sums may be scheduled now: they wait for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint64_t* full = bars;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one warp: stage j's rows of x and g into slot j % S
  auto fill = [&](long long j) {
    const int s = static_cast<int>(j % S);
    const long long first = r0 + j * rps;
    const int n = static_cast<int>(min(static_cast<long long>(rps),
                                       r0 + nr - first));
    const uint32_t bar = smem_u32(full + s);
    const uint32_t xs = smem_u32(data + s * stage_b);
    if (lane == 0) mbar_expect_tx(bar, static_cast<unsigned>(2 * n * row_b));
    __syncwarp();
    copy_rows(xs, reinterpret_cast<const char*>(x + first * sx),
              sx * static_cast<long long>(sizeof(TX)), n, row_b, bar, lane);
    copy_rows(xs + uint32_t(rps * row_b),
              reinterpret_cast<const char*>(g + first * sg),
              sg * static_cast<long long>(sizeof(TX)), n, row_b, bar, lane);
  };

  // stage j, once it has landed: dx of its rows, their dscale terms
  auto compute = [&](long long j) {
    const int s = static_cast<int>(j % S);
    mbar_wait(smem_u32(full + s), static_cast<unsigned>((j / S) & 1));
    const long long first = r0 + j * rps;
    const int n = static_cast<int>(min(static_cast<long long>(rps),
                                       r0 + nr - first));
    const unsigned char* xs = data + s * stage_b;
    const unsigned char* gs = xs + rps * row_b;
    for (int k = 0; k < a.rpg; ++k) {
      const int i = grp + k * G;           // the row within the stage
      const bool live = i < n;             // the same for the whole group
      const Pack<TX>* xr = reinterpret_cast<const Pack<TX>*>(xs + i * row_b);
      const Pack<TX>* gr = reinterpret_cast<const Pack<TX>*>(gs + i * row_b);
      float ss = 0.f, dt = 0.f;
      if (live) {
#pragma unroll
        for (int q = 0; q < PPL; ++q) {
          const int p = t + q * L;
          if (p < packs) {
            const Pack<TX> xp = xr[p], gp = gr[p];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float xv = to_f32(xp.v[e]);
              ss = __fmaf_rn(xv, xv, ss);
              dt = __fmaf_rn(__fmul_rn(to_f32(gp.v[e]), sc[q][e]), xv, dt);
            }
          }
        }
      }
      // every lane shuffles, live row or not: sub-warp groups share a warp
      ss = seg_sum(ss, L < WARP ? L : WARP);
      dt = seg_sum(dt, L < WARP ? L : WARP);
      if (W > 1) {
        float* slot = part + 2 * i * W;
        if (lane == 0) {
          slot[2 * wig] = ss;
          slot[2 * wig + 1] = dt;
        }
        named_barrier(1 + grp, L);
        ss = slot[0];
        dt = slot[1];
        for (int w = 1; w < W; ++w) {
          ss = __fadd_rn(ss, slot[2 * w]);
          dt = __fadd_rn(dt, slot[2 * w + 1]);
        }
      }
      if (!live) continue;
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      const float r3 = __fmul_rn(__fmul_rn(r, r), r);
      const float dot = dt / static_cast<float>(d);
      Pack<TX>* out = reinterpret_cast<Pack<TX>*>(dx + (first + i) * d);
#pragma unroll
      for (int q = 0; q < PPL; ++q) {
        const int p = t + q * L;
        if (p < packs) {
          const Pack<TX> xp = xr[p], gp = gr[p];
          Pack<TX> o;
#pragma unroll
          for (int e = 0; e < V; ++e)
            o.v[e] = dx_one<TX>(to_f32(xp.v[e]), to_f32(gp.v[e]), sc[q][e],
                                r, r3, dot, &acc[q][e]);
          out[p] = o;
        }
      }
    }
  };

  // warp 0 computes too, and refills a slot once the block is done with it
  if (threadIdx.x < WARP)
    for (long long j = 0; j < nst && j < S; ++j) fill(j);
  for (long long j = 0; j < nst; ++j) {
    compute(j);
    __syncthreads();
    if (threadIdx.x < WARP && j + S < nst) fill(j + S);
  }

  // dscale: the block's groups in group order, in the (now idle) stages
  float* red = reinterpret_cast<float*>(data);
#pragma unroll
  for (int q = 0; q < PPL; ++q) {
    const int p = t + q * L;
    if (p < packs) {
      float4* dst = reinterpret_cast<float4*>(red + grp * d + p * V);
#pragma unroll
      for (int e = 0; e < V; e += 4)
        dst[e / 4] = make_float4(acc[q][e], acc[q][e + 1], acc[q][e + 2],
                                 acc[q][e + 3]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float v = red[c];
    for (int q = 1; q < G; ++q) v = __fadd_rn(v, red[q * d + c]);
    red[c] = v;
  }
  // then the cluster's blocks in rank order, each rank a slice of columns
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunk = (d + C - 1) / C;
  const int hi = min(d, (rank + 1) * chunk);
  float* row = ws + static_cast<long long>(blockIdx.x / C) * d;
  for (int c = rank * chunk + threadIdx.x; c < hi; c += blockDim.x) {
    float v = cluster.map_shared_rank(red, 0)[c];
    for (int q = 1; q < C; ++q)
      v = __fadd_rn(v, cluster.map_shared_rank(red, q)[c]);
    row[c] = v;
  }
  cluster.sync();                          // no block leaves while read
}

// ---------------------------------------------------------------------------
// "direct"
// ---------------------------------------------------------------------------

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
        o.v[j] = dx_one<TX>(to_f32(xp.v[j]), to_f32(gp.v[j]),
                            to_f32(scale[c]), r, r3, dot, mine + c);
      }
      ov[i] = o;
    }
  } else {
    for (int c = t; c < d; c += nt)
      dr[c] = dx_one<TX>(to_f32(xr[c]), to_f32(gr[c]), to_f32(scale[c]), r,
                         r3, dot, mine + c);
  }
}

// TPR threads per row: WARP (8 row groups a block) or DIRECT_THREADS (one).
template <typename TX, typename TS, bool VEC, int TPR>
__global__ void __launch_bounds__(DIRECT_THREADS)
    rmsnorm_bwd_direct(const TX* __restrict__ x, long long sx,
                       const TX* __restrict__ g, long long sg,
                       const TS* __restrict__ scale, TX* __restrict__ dx,
                       float* __restrict__ partial, long long rows, int d,
                       float eps) {
  constexpr int G = DIRECT_THREADS / TPR;
  extern __shared__ float acc[];          // [G][d]
  __shared__ float part[2][DIRECT_WARPS];
  __shared__ float total[2];
  const int grp = threadIdx.x / TPR, t = threadIdx.x % TPR;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  for (int i = threadIdx.x; i < G * d; i += DIRECT_THREADS) acc[i] = 0.f;
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
    if constexpr (TPR == DIRECT_THREADS) {
      if (lane == 0) {
        part[0][warp] = ss;
        part[1][warp] = dt;
      }
      __syncthreads();
      if (warp == 0) {
        const float a = warp_sum(lane < DIRECT_WARPS ? part[0][lane] : 0.f);
        const float b = warp_sum(lane < DIRECT_WARPS ? part[1][lane] : 0.f);
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
  for (int c = threadIdx.x; c < d; c += DIRECT_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) s = __fadd_rn(s, acc[k * d + c]);
    partial[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

// ---------------------------------------------------------------------------
// dscale[c]: the workspace's n rows in SUM_CHUNKS fixed runs, each summed in
// row order, then the runs in order; cast once.  SUM_COLS columns a block.
// ---------------------------------------------------------------------------
template <typename TS>
__global__ void __launch_bounds__(SUM_COLS* SUM_CHUNKS)
    rmsnorm_bwd_dscale(const float* __restrict__ ws, long long n, int d,
                       TS* __restrict__ dscale) {
  __shared__ float part[SUM_CHUNKS][SUM_COLS];
  // launched as a programmatic dependent of the dx kernel: wait until that
  // grid has finished and its workspace rows are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int col = threadIdx.x % SUM_COLS, k = threadIdx.x / SUM_COLS;
  const int c = blockIdx.x * SUM_COLS + col;
  const long long per = (n + SUM_CHUNKS - 1) / SUM_CHUNKS;
  const long long lo = k * per, hi = min(n, lo + per);
  float s = 0.f;
  if (c < d) {
#pragma unroll 4
    for (long long r = lo; r < hi; ++r) s = __fadd_rn(s, ws[r * d + c]);
  }
  part[k][col] = s;
  __syncthreads();
  if (k == 0 && c < d) {
    float v = part[0][col];
#pragma unroll
    for (int q = 1; q < SUM_CHUNKS; ++q) v = __fadd_rn(v, part[q][col]);
    dscale[c] = from_f32<TS>(v);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Raises `kernel`'s dynamic shared memory limit, `allowed` (one per
// kernel: the caller's static), to `smem` the first time a launch needs
// more (host time on every call otherwise).
template <typename K>
int allow_smem(K kernel, long long smem, long long& allowed) {
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    allowed = smem;
  }
  return 0;
}

template <typename TX, typename TS, int PPL>
int launch_bulk(const TX* x, long long sx, const TX* g, long long sg,
                const TS* s, TX* dx, float* ws, long long rows, int d,
                float eps, const Plan& p, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_bulk<TX, TS, PPL>;
  static long long allowed = SMEM_DEFAULT;
  const int err = allow_smem(kernel, p.smem, allowed);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const BulkArgs a{p.lanes, p.groups, p.rpg, p.warps};
  return int(cudaLaunchKernelEx(&cfg, kernel, x, sx, g, sg, s, dx, ws, rows,
                                d, eps, a));
}

template <typename TX, typename TS, bool VEC, int TPR>
int launch_direct(const TX* x, long long sx, const TX* g, long long sg,
                  const TS* s, TX* dx, float* ws, long long rows, int d,
                  float eps, const Plan& p, cudaStream_t stream) {
  auto kernel = rmsnorm_bwd_direct<TX, TS, VEC, TPR>;
  static long long allowed = SMEM_DEFAULT;
  const int err = allow_smem(kernel, p.smem, allowed);
  if (err != 0) return err;
  kernel<<<static_cast<unsigned>(p.grid), DIRECT_THREADS, p.smem, stream>>>(
      x, sx, g, sg, s, dx, ws, rows, d, eps);
  return int(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TX, typename TS>
int launch(const void* xp, long long sx, const void* gp, long long sg,
           const void* sp, void* dxp, float* ws, long long ws_rows,
           void* dsp, long long rows, int d, int variant, float eps,
           cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xp);
  const TX* g = static_cast<const TX*>(gp);
  const TS* s = static_cast<const TS*>(sp);
  TX* dx = static_cast<TX*>(dxp);
  constexpr int V = Pack<TX>::N;
  Plan p;
  int err;
  if (variant == VARIANT_BULK) {
    // takes: 16-byte aligned x, g, scale and dx, row strides a multiple of
    // 16 bytes, a plan (d a multiple of 16 bytes, the row not too wide)
    err = bulk_plan(rows, d, int(sizeof(TX)), &p);
    if (err != 0 || sx % V || sg % V || !aligned16(xp) || !aligned16(gp) ||
        !aligned16(sp) || !aligned16(dxp) || ws_rows < p.ws_rows)
      return int(cudaErrorInvalidValue);
    if (p.ppl == 1)
      err = launch_bulk<TX, TS, 1>(x, sx, g, sg, s, dx, ws, rows, d, eps, p,
                                   stream);
    else if (p.ppl == 2)
      err = launch_bulk<TX, TS, 2>(x, sx, g, sg, s, dx, ws, rows, d, eps, p,
                                   stream);
    else
      err = launch_bulk<TX, TS, 4>(x, sx, g, sg, s, dx, ws, rows, d, eps, p,
                                   stream);
  } else if (variant == VARIANT_DIRECT) {
    err = direct_plan(rows, d, &p);
    if (err != 0 || ws_rows < p.ws_rows) return int(cudaErrorInvalidValue);
    const bool vec = d % V == 0 && sx % V == 0 && sg % V == 0 &&
                     aligned16(xp) && aligned16(gp);
    if (p.lanes == WARP)
      err = vec ? launch_direct<TX, TS, true, WARP>(x, sx, g, sg, s, dx, ws,
                                                    rows, d, eps, p, stream)
                : launch_direct<TX, TS, false, WARP>(x, sx, g, sg, s, dx, ws,
                                                     rows, d, eps, p, stream);
    else
      err = vec ? launch_direct<TX, TS, true, DIRECT_THREADS>(
                      x, sx, g, sg, s, dx, ws, rows, d, eps, p, stream)
                : launch_direct<TX, TS, false, DIRECT_THREADS>(
                      x, sx, g, sg, s, dx, ws, rows, d, eps, p, stream);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  // a programmatic dependent launch: scheduled while the dx kernel runs,
  // it waits for that kernel's end inside (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + SUM_COLS - 1) / SUM_COLS);
  cfg.blockDim = dim3(SUM_COLS * SUM_CHUNKS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, rmsnorm_bwd_dscale<TS>,
                                static_cast<const float*>(ws), p.ws_rows, d,
                                static_cast<TS*>(dsp)));
}

int elt_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

// The plan of `variant` (0 "direct", 1 "bulk") for rows x d of x_dtype
// (0 = float32, 1 = bfloat16) into out[8]: grid, threads, lanes a row,
// rows a stage, stages, cluster, workspace rows, dynamic shared memory
// bytes.  Returns cudaErrorInvalidValue where the variant cannot take the
// shape, else 0.
extern "C" int repro_rmsnorm_bwd_plan(long long rows, int d, int x_dtype,
                                      int variant, long long* out) {
  Plan p;
  const int elt = elt_size(x_dtype);
  if (elt == 0) return int(cudaErrorInvalidValue);
  const int err = variant == VARIANT_BULK     ? bulk_plan(rows, d, elt, &p)
                  : variant == VARIANT_DIRECT ? direct_plan(rows, d, &p)
                                              : int(cudaErrorInvalidValue);
  if (err != 0) return err;
  const long long fields[8] = {p.grid,    p.threads,        p.lanes,
                               p.rows_per_stage, p.stages,  p.cluster,
                               p.ws_rows, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}

// x: (rows, d) of x_dtype, row stride sx elements, unit stride inside a
// row; g likewise (stride sg), in x_dtype; scale: (d,) contiguous, of
// s_dtype; dx: (rows, d) contiguous, of x_dtype; ws: (ws_rows, d) float32
// workspace, at least the variant's plan's rows; dscale: (d,) of s_dtype.
// Dtype codes: 0 = float32, 1 = bfloat16; variant: 0 "direct", 1 "bulk".
// Two launches on the stream; returns cudaErrorInvalidValue before any
// launch for inputs the variant cannot take, else the first failing
// launch's cudaError_t, or 0.
extern "C" int repro_rmsnorm_bwd(const void* x, long long sx, const void* g,
                                 long long sg, const void* scale, void* dx,
                                 float* ws, long long ws_rows, void* dscale,
                                 long long rows, int d, int x_dtype,
                                 int s_dtype, int variant, float eps,
                                 void* stream) {
  if (rows < 1 || d < 1 || sx < d || sg < d)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, sx, g, sg, scale, dx, ws, ws_rows, dscale,
                                rows, d, variant, eps, st);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, sx, g, sg, scale, dx, ws, ws_rows,
                                        dscale, rows, d, variant, eps, st);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, sx, g, sg, scale, dx, ws, ws_rows,
                                        dscale, rows, d, variant, eps, st);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, sx, g, sg, scale, dx, ws,
                                                ws_rows, dscale, rows, d,
                                                variant, eps, st);
  return int(cudaErrorInvalidValue);
}
