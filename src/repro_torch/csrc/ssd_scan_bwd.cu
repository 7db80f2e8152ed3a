// The backward of the Mamba2 SSD chunk scan ("6-bwd") for Hopper (sm_90a),
// CUDA C++ with a plain C entry point bound through ctypes
// (repro_torch/kernels/ssd_scan_bwd.py).
//
// Replaces no TPU kernel: the reference differentiates the scan through its
// custom VJP repro/kernels/ops.py:_ssd_bwd, which runs jax.vjp through the
// pure-jnp ref.ssd_scan.  This is the exact gradient of the port's plain
// scan (kernels/ref.py:ssd_scan; ref.ssd_scan_bwd is this kernel's plain
// version): from x (B,S,H,P), dt (B,S,H), A (H,), Bm, Cm (B,S,G,N) and the
// cotangents gy (B,S,H,P) and gfin (B,H,P,N) or none, it writes dx, ddt,
// dA, dBm and dCm, all f32.  Per (batch, head, chunk of L tokens), with
// acum the inclusive prefix sum of a = dt A over the chunk, e = exp(acum),
// f_s = exp(acum[L-1] - acum[s]) dt_s, CB = C.B^T and decay[l,s] =
// exp(acum[l] - acum[s]) for s <= l:
//   the state's gradient   local_c = sum_l e_l gy_l (x) C_l, and over
//                          chunks in reverse dS_out(c-1) = exp(acum_c[L-1])
//                          dS_out(c) + local_c, dS_out(last) = gfin;
//   dW[l,s] = gy_l.x_s (s <= l), dCB = dW decay dt_s;
//   dx_s  = dt_s sum_l CB decay gy_l + f_s dS_out B_s;
//   dC_l  = sum_s dCB B_s + e_l S_prev^T gy_l;
//   dB_s  = sum_l dCB C_l + f_s dS_out^T x_s   (both summed over the
//                                               group's heads);
//   ddt_s = sum_l dW CB decay + exp(acum[L-1] - acum[s]) r_s + A da_s,
//   r_s = x_s.(dS_out B_s), and dA = sum dt da, with da_j the gradient of
//   a_j, the reverse cumsum of acum's gradient taken in its stable form
//   (no sum of terms that cancel):
//   da_j = sum_{l>=j} gy_l.y_off_l + sum_{l>=j, s<j} dW W[l,s]
//          + sum_{s<j} f_s r_s + exp(acum[L-1]) <dS_out, S_prev>.
// No exp of a positive difference is formed (s <= l only; acum never
// rises), so the gradient stays finite where the reference's is NaN (a
// chunk whose dt |A| sum passes 88).  Tokens past the sequence take dt =
// 0 (and zero x, B, C, gy), head h reads group h / (H/G).
//
// What bounds it on the H100: per (batch, head, chunk) ~L*L*P (dW and the
// weights times gy, causal halves) + ~6 L*P*N (the chunk's own state,
// local, S_prev.C, dS_out.B, and the two state terms of dB, dC) multiply-
// adds, plus ~1.5 L*L*N per group, against ~L*(4P + 4N) floats moved: it
// is bound by operations, ~85% of them the L*P*N products.  Every product
// runs on the tensor cores (wgmma.m64n64k8 tf32) in split TF32, as kernel
// 6 (ssd_scan.cu) does: one TF32 pass keeps ~3 decimal digits and misses
// the plain version's 1e-4 (tests/test_torch_ssd_bwd.py emulates pass 8's
// dB state term both ways), so each f32 operand is split into hi =
// tf32(a) and lo = tf32(a - hi) and every k-step is lo.hi + hi.lo, then +
// hi.hi: three TF32 products, against a bound of 3x the f32 work at 495
// TFLOP/s.  The tensor cores truncate as they accumulate, so every 32-deep
// K slice starts from zero and is added to the running sum with f32 adds
// (pass 8's K reaches a group's heads x P = 3072 at mamba2-780m's shape).
// The two carries over chunks, the sums over heads and head blocks, and
// the serial sums of acum and dA are elementwise and bound by bytes.
//
// Design: ten passes on one stream, each parallel over (batch, head or
// group, chunk) except the two serial carries, which are elementwise, and
// the dA sum:
//   1 acum   a warp per (batch, head, chunk): acum, e and f into `vec`;
//   2 cb     per (chunk, row tile, group, batch): C.B^T, causal tiles;
//   3 state  per (chunk, P tile, N tile, job, head, batch): the chunk's own
//            state x^T (f B) into `st` (job 0), local_c gy^T (e C) into
//            `ds` (job 1): kernel 6's pass B;
//   4 carry  per (4 P*N elements, head, batch): st becomes each chunk's
//            incoming state S_prev (forward), ds each chunk's dS_out
//            (reverse);
//   5 dcb    per (chunk, head, batch): C.S_prev^T per P tile, whose row
//            dots with gy give da's gy.y_off term; then dW = gy.x^T per
//            column tile of 64 into dCB (`dcb`) and dW W into the ring's
//            shared memory, whose exclusive row prefix sums and column
//            sums give the stable pair term of da, into `vec`;
//   6 dcbsum per element: dCB summed over the group's heads in head order
//            (`dcbg`; skipped when each group has one head);
//   7 dx     per (chunk, head, batch), per P tile: u = B.dS_out^T, then
//            gi = (CB decay)^T gy with the weights formed from CB as they
//            are split; dx, and per token r_s, the f r prefix of da, ddt,
//            and dt da into `vec`;
//   8 dbc    per (chunk, N tile, job, head block, group, batch): dC (job
//            0) and dB (job 1), each one product over K = the chunk's
//            tokens (the intra term, first head block only) then the
//            block's heads, P at a time (the state terms; the A operand
//            e_l gy_l or f_s x_s scaled per head as it is split), into
//            `part`: min(H/G, HSPLIT) head blocks, so a group of 48 heads
//            fills the card and a group of 3 still runs;
//   9 dbcsum per element: dC and dB, `part` summed in head-block order;
//  10 dasum  per head: dA, dt da summed over (batch, chunk) in order per
//            token, then over the tokens in order.
// Products (passes 2, 3, 5, 7, 8) follow kernel 6's: two warpgroups a
// block, each owning 64 x 64 output tiles; wgmma takes tf32 A and B only
// K-major from shared memory, so every operand goes through a split pass:
// the K dimension is staged raw in slices of 32 by cp.async (16-byte
// copies where the rows allow, else 4-byte; zero past the ragged edges)
// into a ring of 2; the block splits each slice once into hi and lo tiles,
// K-major in the 128-byte swizzle that wgmma reads, transposing the
// MN-major operands on the way.  A slot is refilled as soon as its split
// is published, so the next two slices' copies are in flight meanwhile.
// Per slice a warpgroup runs 12 wgmma (4 k-steps x 3 products);
// warpgroups whose rows lie past the sequence, or whose slice is all zero
// (above the diagonal), skip theirs.  Output tiles leave
// through shared memory as whole rows.  ~101 KB of shared memory a block:
// two blocks an SM.  No pass uses TMA: every operand is split through
// registers after its copy, and each block's slices are small strided
// boxes that cp.async, issued by all threads, covers as well.
// Deterministic: no atomics; every sum runs in a fixed order.
// The wrapper allocates the scratch (`vec` 5*B*H*nc*L, `cb` B*nc*G*L*Lr
// with Lr = L rounded up to 4, `st` and `ds` B*nc*H*P*N, `dcb`
// B*nc*H*L*Lr, `dcbg` B*nc*G*L*Lr or none, `part` 2*hs*B*nc*G*L*N); the
// kernel allocates nothing.
// The loader, the split, slice_mma and store_tile are kernel 6's, in
// ssd_tf32.cuh.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "ssd_tf32.cuh"

namespace {

using namespace ssd_tf32;

constexpr int MAX_DEVICES = 64;
constexpr int LMAX = 128;          // largest chunk
constexpr int NMAX = 256;          // largest d_state (kernel 6's)
constexpr int WT = 64;             // a warpgroup's output tile is WT x WT
constexpr int NT = 128;            // N tile of the states (pass 3)
constexpr int EXT_FLOATS = 5 * LMAX + NTHREADS;       // per-token vectors
constexpr size_t SMEM_BYTES = TILES_BYTES + EXT_FLOATS * 4;
constexpr int QT_LD = WT + 1;      // pass 5's dW W tile pitch
static_assert(LMAX * QT_LD <= RING * RAW_FLOATS, "pass 5's tile");
constexpr int CARRY_PER_BLOCK = NTHREADS * 4;         // pass 4 elements
constexpr int CU = 8;              // chunks a carry loads ahead of its sums
constexpr int ACUM_WARPS = 8;      // pass 1: a warp per (b, h, chunk)
constexpr int HSPLIT = 8;          // head blocks of pass 8's state terms
constexpr int VEC_ACUM = 0, VEC_E = 1, VEC_F = 2, VEC_DA = 3,
              VEC_DTDA = 4;        // the vectors of `vec`, (B, H, nc, L) each

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* gy;
  const float* gfin;               // or null: a dropped final state
  float* dx;
  float* ddt;
  float* dA;
  float* dB;
  float* dC;
  float* vec;                      // 5 x (B, H, nc, L)
  float* cb;                       // (B, nc, G, L, Lr)
  float* st;                       // (B, nc, H, P, N)
  float* ds;                       // (B, nc, H, P, N)
  float* dcb;                      // (B, nc, H, L, Lr)
  float* dcbg;                     // (B, nc, G, L, Lr), or dcb when H == G
  float* part;                     // (2, hs, B, nc, G, L, N)
  int Bsz, S, H, P, G, N, L, Lr, nc, rep, hs;
  size_t V;                        // B * H * nc * L
};

// ---- indexing ----------------------------------------------------------------

__device__ __forceinline__ size_t xi(const Params& p, int b, int t, int h,
                                     int q) {
  return ((size_t(b) * p.S + t) * p.H + h) * p.P + q;
}
__device__ __forceinline__ size_t bci(const Params& p, int b, int t, int g,
                                      int n) {
  return ((size_t(b) * p.S + t) * p.G + g) * p.N + n;
}
__device__ __forceinline__ size_t veci(const Params& p, int b, int h, int c) {
  return ((size_t(b) * p.H + h) * p.nc + c) * p.L;
}
// (b, c, h) of `st` and `ds`: a chunk's heads lie together, so the state
// terms of pass 8 read (head, P) rows at one stride
__device__ __forceinline__ size_t pni(const Params& p, int b, int c, int h) {
  return ((size_t(b) * p.nc + c) * p.H + h) * size_t(p.P) * p.N;
}
__device__ __forceinline__ size_t lli(const Params& p, int b, int c, int k,
                                      int K) {
  return ((size_t(b) * p.nc + c) * K + k) * size_t(p.L) * p.Lr;
}

__device__ __forceinline__ int chunk_len(const Params& p, int c) {
  return min(p.L, p.S - c * p.L);
}

// 16-byte copies allowed: base 16-byte aligned, rows ld floats apart.
__device__ __forceinline__ bool vec_ok(const float* base, size_t ld) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && ld % 4 == 0;
}

// ---- shared memory of the product passes ------------------------------------

// The split tiles and the ring, then the per-token vectors of a pass.
struct Smem : Tiles {
  float* ext;                      // EXT_FLOATS
};

__device__ __forceinline__ Smem carve(char* base) {
  const Tiles t = carve_tiles(base);
  return Smem{t, t.end()};
}

// The ring: a raw slot is free once its slice is split, before that
// slice's wgmma, so RING slots keep RING slices in flight.  ring_start
// queues slices 0 .. RING - 1 (issue(k, raw) copies slice k into raw);
// ring_wait(k) waits for slice k and returns it; after the split of slice
// k is published, ring_refill(k) queues slice k + RING into its slot.
// Each queue commits one copy group, empty past the last slice.  Called
// by the whole block.
template <class Issue>
__device__ __forceinline__ void ring_start(const Smem& sm, int nk,
                                           Issue issue) {
  for (int k = 0; k < RING; ++k) {
    if (k < nk) issue(k, sm.raw(k));
    cp_async_commit();
  }
}

__device__ __forceinline__ const float* ring_wait(const Smem& sm, int k) {
  cp_async_wait<RING - 1>();
  __syncthreads();
  return sm.raw(k);
}

template <class Issue>
__device__ __forceinline__ void ring_refill(const Smem& sm, int k, int nk,
                                            Issue issue) {
  if (k + RING < nk) issue(k + RING, sm.raw(k));
  cp_async_commit();
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// out[row0] += part[0] and out[row0 + 8] += part[1] (rows below vrows),
// each summed over the row's quad of lanes first, in a fixed order.
// Called by whole warps.
__device__ __forceinline__ void quad_add(float (&part)[2], float* out,
                                         int row0, int vrows) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 1);
    part[j] += __shfl_xor_sync(0xffffffffu, part[j], 2);
  }
  if ((threadIdx.x & 3) == 0) {
    if (row0 < vrows) out[row0] += part[0];
    if (row0 + 8 < vrows) out[row0 + 8] += part[1];
  }
}

// ---- pass 1: acum, e = exp(acum), f = exp(acum[L-1] - acum) dt ----------------

__global__ void __launch_bounds__(ACUM_WARPS * 32)
bwd_acum_kernel(const Params p) {
  __shared__ float sdt[ACUM_WARPS][LMAX];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t idx = size_t(blockIdx.x) * ACUM_WARPS + warp;
  if (idx >= size_t(p.Bsz) * p.H * p.nc) return;     // the whole warp
  const int c = idx % p.nc, h = (idx / p.nc) % p.H,
            b = idx / (size_t(p.nc) * p.H);
  const int Lv = chunk_len(p, c), t0 = c * p.L;
  float* d = sdt[warp];
  for (int l = lane; l < LMAX; l += 32)
    d[l] = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
  __syncwarp();
  // every lane runs the sum over all tokens in order, product and sum
  // rounded apart, as the plain version (dt = 0 past Lv keeps it); lane j
  // keeps acum[s] for s = j (mod 32)
  const float A = p.A[h];
  float acc = 0.f, mine[LMAX / 32];
#pragma unroll
  for (int s = 0; s < LMAX; ++s) {
    acc = __fadd_rn(acc, __fmul_rn(d[s], A));
    if (lane == s % 32) mine[s / 32] = acc;
  }
  const size_t v0 = veci(p, b, h, c);
#pragma unroll
  for (int i = 0; i < LMAX / 32; ++i) {
    const int l = lane + 32 * i;
    if (l >= p.L) break;
    p.vec[VEC_ACUM * p.V + v0 + l] = mine[i];
    p.vec[VEC_E * p.V + v0 + l] = expf(mine[i]);
    p.vec[VEC_F * p.V + v0 + l] = expf(acc - mine[i]) * d[l];
  }
}

// ---- pass 2: CB = C.B^T per (chunk, row tile, group, batch) -----------------

__global__ void __launch_bounds__(NTHREADS, 2) bwd_cb_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int nlt = (p.L + WT - 1) / WT;
  const int c = blockIdx.x / nlt, l0 = (blockIdx.x % nlt) * WT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.L, Lv = chunk_len(p, c);
  if (l0 >= Lv) return;                  // rows past the sequence: unread
  const int wg = threadIdx.x / 128;      // output columns s of WT wg ..
  const bool active = WT * wg <= l0 + WT - 1 && WT * wg < Lv;
  const size_t ldg = size_t(p.G) * p.N;
  const float* gC = p.Cm + bci(p, b, t0 + l0, g, 0);
  const float* gB = p.Bm + bci(p, b, t0, g, 0);
  const bool vec = vec_ok(gC, ldg) && vec_ok(gB, ldg);
  const int brows = min(Lv, l0 + WT);    // B rows s <= the tile's last row
  const int nk = (p.N + KS - 1) / KS;
  auto issue = [&](int k, float* raw) {
    const int k0 = k * KS;
    load_tile(raw, gC + k0, ldg, WT, KS, Lv - l0, p.N - k0, vec);
    load_tile(raw + WT * KS, gB + k0, ldg, LMAX, KS, brows, p.N - k0, vec);
  };
  float tot[32];
  zero(tot);
  ring_start(sm, nk, issue);
  for (int k = 0; k < nk; ++k) {
    split_rows(sm, ring_wait(sm, k), 0, WT + LMAX);
    publish();
    ring_refill(sm, k, nk, issue);
    if (active) slice_mma(tot, sm, 0, WT + WT * wg);
  }
  float* out = p.cb + lli(p, b, c, g, p.G) + size_t(l0) * p.Lr;
  store_tile<WT, LMAX>(tot, sm, 0, WT * wg, out, p.Lr, Lv - l0, p.L,
                       vec_ok(out, p.Lr));
}

// ---- pass 3: the chunk's own state (job 0) and local_c (job 1) ---------------

__global__ void __launch_bounds__(NTHREADS, 2)
bwd_state_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ntl = (p.N + NT - 1) / NT, ptl = (p.P + WT - 1) / WT;
  const int job = blockIdx.x & 1, i = blockIdx.x >> 1;
  const int nt = i % ntl, pt = (i / ntl) % ptl, c = i / (ntl * ptl);
  const int h = blockIdx.y, b = blockIdx.z, g = h / p.rep;
  const int t0 = c * p.L, Lv = chunk_len(p, c);
  const int p0 = pt * WT, n0 = nt * NT;
  const int wg = threadIdx.x / 128;      // output columns n of WT wg ..
  const bool active = n0 + WT * wg < p.N;
  // job 0: st = x^T (f B); job 1: ds = gy^T (e C)
  const size_t ldr = size_t(p.H) * p.P, ldk = size_t(p.G) * p.N;
  const float* gR = (job ? p.gy : p.x) + xi(p, b, t0, h, p0);
  const float* gK = (job ? p.Cm : p.Bm) + bci(p, b, t0, g, n0);
  const bool vr = vec_ok(gR, ldr), vk = vec_ok(gK, ldk);
  const int nk = (Lv + KS - 1) / KS;
  auto issue = [&](int k, float* raw) {
    const int k0 = k * KS;
    load_tile(raw, gR + k0 * ldr, ldr, KS, WT, Lv - k0, p.P - p0, vr);
    load_tile(raw + KS * WT, gK + k0 * ldk, ldk, KS, NT, Lv - k0, p.N - n0,
              vk);
  };
  ring_start(sm, nk, issue);
  float* scale = sm.ext;                 // f or e, published by the ring
  const float* sv = p.vec + (job ? VEC_E : VEC_F) * p.V + veci(p, b, h, c);
  for (int l = threadIdx.x; l < LMAX; l += NTHREADS)
    scale[l] = l < Lv ? sv[l] : 0.f;
  float tot[32];
  zero(tot);
  for (int k = 0; k < nk; ++k) {
    const float* raw = ring_wait(sm, k);
    split_cols<false>(sm, raw, WT, 0, nullptr);                   // rows^T
    split_cols<true>(sm, raw + KS * WT, NT, WT, scale + k * KS);  // (s K)^T
    publish();
    ring_refill(sm, k, nk, issue);
    if (active) slice_mma(tot, sm, 0, WT + WT * wg);
  }
  float* out = (job ? p.ds : p.st) + pni(p, b, c, h) + size_t(p0) * p.N + n0;
  store_tile<WT, NT>(tot, sm, 0, WT * wg, out, p.N, p.P - p0, p.N - n0,
                     vec_ok(out, p.N));
}

// ---- pass 4: the two carries over chunks, elementwise --------------------------

__device__ __forceinline__ void ld4(const float* s, bool vec, int ne,
                                    float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(s);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < ne ? s[j] : 0.f;
  }
}

__device__ __forceinline__ void st4(float* d, bool vec, int ne,
                                    const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < ne; ++j) d[j] = v[j];
  }
}

__global__ void __launch_bounds__(NTHREADS) bwd_carry_kernel(const Params p) {
  const size_t PN = size_t(p.P) * p.N, CS = size_t(p.H) * PN;  // chunk stride
  const size_t e0 = (size_t(blockIdx.x) * NTHREADS + threadIdx.x) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e0 >= PN) return;
  const int ne = PN - e0 < 4 ? int(PN - e0) : 4;
  const float* ex = p.vec + VEC_E * p.V + veci(p, b, h, 0) + p.L - 1;
  float* st = p.st + pni(p, b, 0, h) + e0;
  float* ds = p.ds + pni(p, b, 0, h) + e0;
  const bool vec = ne == 4 && vec_ok(st, CS) && vec_ok(ds, CS);
  // forward: st[c] becomes the state entering chunk c; CU chunks are
  // loaded ahead of their sums, so their loads overlap
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < p.nc; c0 += CU) {
    const int n = min(CU, p.nc - c0);
    float d[CU][4];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (u < n) ld4(st + (c0 + u) * CS, vec, ne, d[u]);
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (u >= n) break;
      st4(st + (c0 + u) * CS, vec, ne, carry);
      const float dec = ex[size_t(c0 + u) * p.L];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        carry[j] = __fadd_rn(__fmul_rn(carry[j], dec), d[u][j]);
    }
  }
  // reverse: ds[c] becomes the gradient of the state leaving chunk c
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.gfin) {
    const float* gf = p.gfin + (size_t(b) * p.H + h) * PN + e0;
    ld4(gf, ne == 4 && vec_ok(gf, 4), ne, g);
  }
  for (int c1 = p.nc; c1 > 0; c1 -= CU) {
    const int n = min(CU, c1);           // chunks c1 - 1 down to c1 - n
    float d[CU][4];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (u < n) ld4(ds + (c1 - 1 - u) * CS, vec, ne, d[u]);
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (u >= n) break;
      const int c = c1 - 1 - u;
      st4(ds + c * CS, vec, ne, g);
      const float dec = ex[size_t(c) * p.L];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        g[j] = __fadd_rn(__fmul_rn(g[j], dec), d[u][j]);
    }
  }
}

// ---- pass 5: dCB, and da but for the f r prefix, per (chunk, head, batch) ------

__global__ void __launch_bounds__(NTHREADS, 2) bwd_dcb_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  float* sac = sm.ext;                   // acum
  float* sdt = sac + LMAX;               // dt, 0 past Lv
  float* so = sdt + LMAX;                // sum_q gy_l[q] (S_prev C_l)[q]
  float* pair = so + LMAX;               // the pair term of da
  float* rowtot = pair + LMAX;           // a column tile's row sums of dW W
  float* red = rowtot + LMAX;            // NTHREADS
  float* qt = sm.raw0;                   // (LMAX, QT_LD): a column tile of
                                         // dW W, in the ring after its product
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / p.rep;
  const int L = p.L, Lv = chunk_len(p, c), t0 = c * L;
  const int wg = threadIdx.x / 128;      // output rows l of WT wg ..
  const bool live = WT * wg < Lv;
  const float* ac = p.vec + VEC_ACUM * p.V + veci(p, b, h, c);
  for (int l = threadIdx.x; l < LMAX; l += NTHREADS) {
    sac[l] = l < L ? ac[l] : 0.f;
    sdt[l] = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    so[l] = pair[l] = 0.f;
  }
  __syncthreads();
  const size_t ldx = size_t(p.H) * p.P, ldbc = size_t(p.G) * p.N;
  const float* gy = p.gy + xi(p, b, t0, h, 0);
  const float* gx = p.x + xi(p, b, t0, h, 0);

  // so_l = sum_q gy_l[q] (C_l . S_prev^T)[q], the product per P tile;
  // kc = exp(acum[L-1]) <dS_out, S_prev> (both zero in the first chunk,
  // whose incoming state is zero)
  float kc = 0.f;
  if (c > 0) {
    const float* sp = p.st + pni(p, b, c, h);
    const float* dso = p.ds + pni(p, b, c, h);
    const float* gC = p.Cm + bci(p, b, t0, g, 0);
    const bool vc = vec_ok(gC, ldbc), vs = vec_ok(sp, p.N);
    const int nk = (p.N + KS - 1) / KS;
    for (int p0 = 0; p0 < p.P; p0 += WT) {
      auto issue = [&](int k, float* raw) {
        const int k0 = k * KS;
        load_tile(raw, gC + k0, ldbc, LMAX, KS, Lv, p.N - k0, vc);
        load_tile(raw + LMAX * KS, sp + size_t(p0) * p.N + k0, p.N, WT, KS,
                  p.P - p0, p.N - k0, vs);
      };
      float tot[32];
      zero(tot);
      ring_start(sm, nk, issue);
      for (int k = 0; k < nk; ++k) {
        split_rows(sm, ring_wait(sm, k), 0, LMAX + WT);
        publish();
        ring_refill(sm, k, nk, issue);
        if (live) slice_mma(tot, sm, WT * wg, LMAX);
      }
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int l = WT * wg + acc_row(i), q = p0 + acc_col(i);
        if (l < Lv && q < p.P)
          part[(i >> 1) & 1] += gy[size_t(l) * ldx + q] * tot[i];
      }
      quad_add(part, so, WT * wg + acc_row(0), Lv);
    }
    const size_t PN = size_t(p.P) * p.N;
    float s = 0.f;
    for (size_t e = threadIdx.x; e < PN; e += NTHREADS) s += dso[e] * sp[e];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int w = NTHREADS / 2; w > 0; w /= 2) {
      if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    kc = expf(sac[L - 1]) * red[0];
  }

  // dW = gy.x^T per column tile [s0, s0 + WT): dCB = dW decay dt into
  // `dcb` (zero above the diagonal and past the sequence), dW W = dCB CB
  // into qt; the pair term sum_{l>=j, s<j} dW W[l, s] of da gathers, per
  // tile, its exclusive row prefixes (columns j of the tile) and its row
  // sums (columns past it)
  const float* cb = p.cb + lli(p, b, c, g, p.G);
  float* dcb = p.dcb + lli(p, b, c, h, p.H);
  const bool vx = vec_ok(gy, ldx) && vec_ok(gx, ldx);
  const int nk = (p.P + KS - 1) / KS;
  for (int s0 = 0; s0 < Lv; s0 += WT) {
    auto issue = [&](int k, float* raw) {
      const int k0 = k * KS;
      load_tile(raw, gy + k0, ldx, LMAX, KS, Lv, p.P - k0, vx);
      load_tile(raw + LMAX * KS, gx + size_t(s0) * ldx + k0, ldx, WT, KS,
                Lv - s0, p.P - k0, vx);
    };
    const bool active = live && WT * wg + WT > s0;
    float tot[32];
    zero(tot);
    ring_start(sm, nk, issue);
    for (int k = 0; k < nk; ++k) {
      split_rows(sm, ring_wait(sm, k), 0, LMAX + WT);
      publish();
      ring_refill(sm, k, nk, issue);
      if (active) slice_mma(tot, sm, WT * wg, LMAX);
    }
    // the ring is idle: every copy has landed and been split
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int l = WT * wg + acc_row(i), j = acc_col(i), s = s0 + j;
      float v = 0.f, w = 0.f;
      if (s <= l && l < Lv) {
        const float d = tot[i] * expf(sac[l] - sac[s]);
        v = d * sdt[s];
        w = d * cb[size_t(l) * p.Lr + s] * sdt[s];
      }
      tot[i] = v;
      qt[l * QT_LD + j] = w;
    }
    store_tile<LMAX, WT>(tot, sm, WT * wg, 0, dcb + s0, p.Lr, L, L - s0,
                         vec_ok(dcb, p.Lr));
    const int n = min(WT, Lv - s0);
    if (threadIdx.x < Lv) {
      const int l = threadIdx.x;
      float* row = qt + l * QT_LD;
      float run = 0.f;
      for (int j = 0; j < n; ++j) {
        const float v = row[j];
        row[j] = run;
        run += v;
      }
      rowtot[l] = run;
    }
    __syncthreads();
    if (threadIdx.x < Lv) {
      const int j = threadIdx.x;
      float t = 0.f;
      if (j >= s0 + WT) {
        for (int l = j; l < Lv; ++l) t += rowtot[l];
      } else if (j >= s0) {
        for (int l = j; l < Lv; ++l) t += qt[l * QT_LD + j - s0];
      }
      pair[j] += t;
    }
    __syncthreads();                     // qt and rowtot are rewritten next
  }

  float* da = p.vec + VEC_DA * p.V + veci(p, b, h, c);
  const float* ex = p.vec + VEC_E * p.V + veci(p, b, h, c);
  for (int l = threadIdx.x; l < Lv; l += NTHREADS) so[l] *= ex[l];
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += NTHREADS) {
    float o = 0.f;
    for (int l = j; l < Lv; ++l) o += so[l];
    da[j] = j < Lv ? pair[j] + o + kc : 0.f;
  }
}

// ---- pass 6: dCB summed over the group's heads -------------------------------

__global__ void __launch_bounds__(NTHREADS) bwd_dcbsum_kernel(const Params p) {
  const size_t LL = size_t(p.L) * p.Lr;
  const size_t idx = size_t(blockIdx.x) * NTHREADS + threadIdx.x;
  if (idx >= size_t(p.Bsz) * p.nc * p.G * LL) return;
  const size_t e = idx % LL, bcg = idx / LL;
  const int g = bcg % p.G;
  const size_t bc = bcg / p.G;
  const float* src = p.dcb + (bc * p.H + size_t(g) * p.rep) * LL + e;
  float s = 0.f;
  for (int r = 0; r < p.rep; ++r) s += src[r * LL];
  p.dcbg[idx] = s;
}

// ---- pass 7: dx, ddt and dt da per (chunk, head, batch) ------------------------

__global__ void __launch_bounds__(NTHREADS, 2) bwd_dx_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  float* sac = sm.ext;                   // acum
  float* sdt = sac + LMAX;               // dt, 0 past Lv
  float* sf = sdt + LMAX;                // f
  float* zs = sf + LMAX;                 // sum_q x_s[q] gi[s][q]
  float* rs = zs + LMAX;                 // r_s = sum_q x_s[q] u[s][q]
  float* fr = rs + LMAX;                 // f_s r_s
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / p.rep;
  const int L = p.L, Lv = chunk_len(p, c), t0 = c * L;
  const int wg = threadIdx.x / 128;      // output rows s of WT wg ..
  const bool live = WT * wg < Lv;
  const size_t v0 = veci(p, b, h, c);
  for (int l = threadIdx.x; l < LMAX; l += NTHREADS) {
    sac[l] = l < L ? p.vec[VEC_ACUM * p.V + v0 + l] : 0.f;
    sdt[l] = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    sf[l] = l < L ? p.vec[VEC_F * p.V + v0 + l] : 0.f;
    zs[l] = rs[l] = 0.f;
  }
  __syncthreads();
  const size_t ldx = size_t(p.H) * p.P, ldbc = size_t(p.G) * p.N;
  const float* cb = p.cb + lli(p, b, c, g, p.G);
  const float* dso = p.ds + pni(p, b, c, h);
  const float* gB = p.Bm + bci(p, b, t0, g, 0);
  const float* gy = p.gy + xi(p, b, t0, h, 0);
  const float* gx = p.x + xi(p, b, t0, h, 0);
  float* gdx = p.dx + xi(p, b, t0, h, 0);
  const bool vb = vec_ok(gB, ldbc), vs = vec_ok(dso, p.N),
             vcb = vec_ok(cb, p.Lr), vy = vec_ok(gy, ldx);
  // K slices: first u = B.dS_out^T over N, then gi = (CB decay)^T gy over
  // the chunk's tokens
  const int n1 = (p.N + KS - 1) / KS, nk = n1 + (Lv + KS - 1) / KS;
  for (int p0 = 0; p0 < p.P; p0 += WT) {
    auto issue = [&](int k, float* raw) {
      if (k < n1) {
        const int k0 = k * KS;
        load_tile(raw, gB + k0, ldbc, LMAX, KS, Lv, p.N - k0, vb);
        load_tile(raw + LMAX * KS, dso + size_t(p0) * p.N + k0, p.N, WT, KS,
                  p.P - p0, p.N - k0, vs);
      } else {
        const int k0 = (k - n1) * KS;
        load_tile(raw, cb + size_t(k0) * p.Lr, p.Lr, KS, LMAX, Lv - k0, Lv,
                  vcb);
        load_tile(raw + KS * LMAX, gy + size_t(k0) * ldx + p0, ldx, KS, WT,
                  Lv - k0, p.P - p0, vy);
      }
    };
    float gi[32], u[32];
    zero(gi);
    zero(u);
    ring_start(sm, nk, issue);
    for (int k = 0; k < nk; ++k) {
      const float* raw = ring_wait(sm, k);
      const int k0 = (k - n1) * KS;
      if (k < n1) {
        split_rows(sm, raw, 0, LMAX + WT);                 // B, dS_out
      } else {
        // the weights A[s][l] = CB[l][s] exp(acum[l] - acum[s]) for s <= l,
        // else 0, from the MN-major slice of CB rows l
        for (int i = threadIdx.x; i < LMAX * (KS / 4); i += NTHREADS) {
          const int s = i % LMAX, cq = i / LMAX;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = k0 + 4 * cq + j;
            v[j] = s <= l ? raw[(4 * cq + j) * LMAX + s] *
                                expf(sac[l] - sac[s])
                          : 0.f;
          }
          put4(sm, s, cq, v);
        }
        split_cols<false>(sm, raw + KS * LMAX, WT, LMAX, nullptr);  // gy^T
      }
      publish();
      ring_refill(sm, k, nk, issue);
      if (!live) continue;
      if (k < n1) slice_mma(u, sm, WT * wg, LMAX);
      else if (k0 + KS > WT * wg) slice_mma(gi, sm, WT * wg, LMAX);
    }
    float zp[2] = {0.f, 0.f}, rp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = WT * wg + acc_row(i), q = p0 + acc_col(i);
      float d = 0.f;
      if (s < Lv && q < p.P) {
        const float xv = gx[size_t(s) * ldx + q];
        d = gi[i] * sdt[s] + u[i] * sf[s];
        zp[(i >> 1) & 1] += xv * gi[i];
        rp[(i >> 1) & 1] += xv * u[i];
      }
      gi[i] = d;
    }
    quad_add(zp, zs, WT * wg + acc_row(0), Lv);
    quad_add(rp, rs, WT * wg + acc_row(0), Lv);
    store_tile<LMAX, WT>(gi, sm, WT * wg, 0, gdx + p0, ldx, Lv, p.P - p0,
                         vec_ok(gdx + p0, ldx));
  }
  // ddt_j = z_j + exp(acum[L-1] - acum[j]) r_j + A da_j, da_j pass 5's
  // plus the f r prefix sum_{s<j} f_s r_s; dt_j da_j for dA
  __syncthreads();
  for (int s = threadIdx.x; s < LMAX; s += NTHREADS)
    fr[s] = s < Lv ? sf[s] * rs[s] : 0.f;
  __syncthreads();
  if (threadIdx.x < Lv) {
    const int j = threadIdx.x;
    float pre = 0.f;
    for (int s = 0; s < j; ++s) pre += fr[s];
    const float da = p.vec[VEC_DA * p.V + v0 + j] + pre;
    p.ddt[(size_t(b) * p.S + t0 + j) * p.H + h] =
        zs[j] + expf(sac[L - 1] - sac[j]) * rs[j] + p.A[h] * da;
    p.vec[VEC_DTDA * p.V + v0 + j] = sdt[j] * da;
  }
}

// ---- pass 8: dC (job 0) and dB (job 1) per (chunk, N tile, job, head block,
// group, batch): the state terms' K split over hs blocks of the group's
// heads, each block's tile into `part`; the first block adds the intra term

__global__ void __launch_bounds__(NTHREADS, 2) bwd_dbc_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ntl = (p.N + WT - 1) / WT;
  const int q = blockIdx.x % p.hs, job = (blockIdx.x / p.hs) & 1;
  const int i = blockIdx.x / (2 * p.hs);
  const int n0 = i % ntl * WT, c = i / ntl;
  const int g = blockIdx.y, b = blockIdx.z;
  const int L = p.L, Lv = chunk_len(p, c), t0 = c * L;
  const int wg = threadIdx.x / 128;      // output rows of WT wg ..
  const bool live = WT * wg < Lv;
  // this block's heads [h0, h1) of the group's, each K = P at a time
  const int hb = (p.rep + p.hs - 1) / p.hs;
  const int h0 = g * p.rep + min(p.rep, q * hb),
            h1 = g * p.rep + min(p.rep, (q + 1) * hb);
  const int nq = (p.P + KS - 1) / KS;
  const int nI = q == 0 ? (Lv + KS - 1) / KS : 0;       // intra slices
  const int nk = nI + (job == 0 && c == 0 ? 0 : (h1 - h0) * nq);
  const size_t ldx = size_t(p.H) * p.P, ldbc = size_t(p.G) * p.N;
  const float* dcb = p.dcbg + lli(p, b, c, g, p.G);
  // dC_l = sum_{s<=l} dCB[l][s] B_s + sum_h e_l S_prev^T gy_l;
  // dB_s = sum_{l>=s} dCB[l][s] C_l + sum_h f_s dS_out^T x_s
  const float* gK = (job ? p.Cm : p.Bm) + bci(p, b, t0, g, n0);
  const float* gA = (job ? p.x : p.gy) + xi(p, b, t0, 0, 0);
  const float* gS = (job ? p.ds : p.st) + pni(p, b, c, 0) + n0;
  const bool vd = vec_ok(dcb, p.Lr), vk = vec_ok(gK, ldbc),
             vs = vec_ok(gS, p.N);
  auto issue = [&](int k, float* raw) {
    if (k < nI) {
      const int k0 = k * KS;
      if (job == 0)                      // dCB rows l, K = s
        load_tile(raw, dcb + k0, p.Lr, LMAX, KS, Lv, Lv - k0, vd);
      else                               // dCB rows l = K, columns s
        load_tile(raw, dcb + size_t(k0) * p.Lr, p.Lr, KS, LMAX, Lv - k0, Lv,
                  vd);
      load_tile(raw + LMAX * KS, gK + size_t(k0) * ldbc, ldbc, KS, WT,
                Lv - k0, p.N - n0, vk);
    } else {
      const int j = k - nI, h = h0 + j / nq, q0 = j % nq * KS;
      const float* a = gA + size_t(h) * p.P + q0;
      load_tile(raw, a, ldx, LMAX, KS, Lv, p.P - q0, vec_ok(a, ldx));
      load_tile(raw + LMAX * KS, gS + (size_t(h) * p.P + q0) * p.N, p.N, KS,
                WT, p.P - q0, p.N - n0, vs);
    }
  };
  float tot[32];
  zero(tot);
  ring_start(sm, nk, issue);
  for (int k = 0; k < nk; ++k) {
    const float* raw = ring_wait(sm, k);
    if (k < nI && job == 1) {
      split_cols<false>(sm, raw, LMAX, 0, nullptr);         // dCB^T
    } else if (k < nI) {
      split_rows(sm, raw, 0, LMAX);                         // dCB
    } else {                                                // e gy or f x
      const int h = h0 + (k - nI) / nq;
      split_rows<true>(sm, raw, 0, LMAX,
                       p.vec + (job ? VEC_F : VEC_E) * p.V +
                           veci(p, b, h, c),
                       Lv);
    }
    split_cols<false>(sm, raw + LMAX * KS, WT, LMAX, nullptr);
    publish();
    ring_refill(sm, k, nk, issue);
    if (!live) continue;
    // dCB[l][s] is zero for s > l: dC's rows l read s <= l, dB's rows s
    // read l >= s
    if (k < nI && (job == 0 ? k * KS > WT * wg + WT - 1
                            : k * KS + KS <= WT * wg))
      continue;
    slice_mma(tot, sm, WT * wg, LMAX);
  }
  float* out = p.part +
               ((((size_t(job) * p.hs + q) * p.Bsz + b) * p.nc + c) * p.G + g) *
                   L * p.N + n0;
  store_tile<LMAX, WT>(tot, sm, WT * wg, 0, out, p.N, Lv, p.N - n0,
                       vec_ok(out, p.N));
}

// ---- pass 9: dC and dB, the head blocks' tiles summed in block order --------

__global__ void __launch_bounds__(NTHREADS) bwd_dbcsum_kernel(const Params p) {
  const size_t M = size_t(p.Bsz) * p.nc * p.G * p.L * p.N;  // one block's
  const size_t idx = size_t(blockIdx.x) * NTHREADS + threadIdx.x;
  if (idx >= 2 * M) return;
  const int job = idx / M;
  const size_t e = idx % M;
  const int n = e % p.N, l = (e / p.N) % p.L;
  const size_t bcg = e / (size_t(p.N) * p.L);
  const int g = bcg % p.G, c = (bcg / p.G) % p.nc, b = bcg / (size_t(p.G) * p.nc);
  if (c * p.L + l >= p.S) return;
  const float* src = p.part + size_t(job) * p.hs * M + e;
  float s = 0.f;
  for (int q = 0; q < p.hs; ++q) s += src[q * M];
  (job ? p.dB : p.dC)[bci(p, b, c * p.L + l, g, n)] = s;
}

// ---- pass 10: dA per head ---------------------------------------------------

__global__ void __launch_bounds__(LMAX) bwd_dasum_kernel(const Params p) {
  __shared__ float red[LMAX];
  const int h = blockIdx.x, j = threadIdx.x;
  float acc = 0.f;                       // sum of dt da over (b, c), in order
  for (int b = 0; b < p.Bsz; ++b)
    for (int c = 0; c < p.nc; ++c)
      if (j < chunk_len(p, c))
        acc += p.vec[VEC_DTDA * p.V + veci(p, b, h, c) + j];
  red[j] = acc;
  __syncthreads();
  if (j == 0) {
    float s = 0.f;
    for (int t = 0; t < LMAX; ++t) s += red[t];
    p.dA[h] = s;
  }
}

// Raises a product pass's dynamic shared-memory limit once per device.
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

unsigned blocks(size_t n, int per) { return unsigned((n + per - 1) / per); }

}  // namespace

// All tensors float32 and contiguous: x, gy, dx (B,S,H,P); dt, ddt (B,S,H);
// A, dA (H,); Bm, Cm, dB, dC (B,S,G,N); gfin (B,H,P,N) or null; scratch vec
// (5,B,H,nc,L), cb (B,nc,G,L,Lr), st and ds (B,nc,H,P,N), dcb
// (B,nc,H,L,Lr), dcbg (B,nc,G,L,Lr), or null when H == G, part
// (2,hs,B,nc,G,L,N) with hs = min(H/G, HSPLIT), with nc = ceil(S/L) and Lr
// = L rounded up to a multiple of 4.  L is the chunk length (min(chunk,
// S)).  Takes every shape kernel 6's entry takes.  Launches the passes on
// `stream` and returns the first cudaError_t.
extern "C" int repro_ssd_scan_bwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, const float* gy,
                                  const float* gfin, float* dx, float* ddt,
                                  float* dA, float* dB, float* dC, float* vec,
                                  float* cb, float* st, float* ds, float* dcb,
                                  float* dcbg, float* part, int B, int S,
                                  int H, int P, int G, int N, int L,
                                  void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || L < 1 || L > LMAX || B > 65535 || H > 65535 ||
      G > 65535 || (H != G && dcbg == nullptr) || part == nullptr)
    return int(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const int rep = H / G, hs = rep < HSPLIT ? rep : HSPLIT;
  Params p{x,   dt,  A,   Bm,           Cm,   gy, gfin, dx, ddt,
           dA,  dB,  dC,  vec,          cb,   st, ds,   dcb,
           H == G ? dcb : dcbg,         part, B,  S,    H,  P,
           G,   N,   L,   (L + 3) / 4 * 4,    nc, rep,  hs,
           size_t(B) * H * nc * L};
  cudaError_t err;
  if ((err = set_smem<bwd_cb_kernel>()) != cudaSuccess ||
      (err = set_smem<bwd_state_kernel>()) != cudaSuccess ||
      (err = set_smem<bwd_dcb_kernel>()) != cudaSuccess ||
      (err = set_smem<bwd_dx_kernel>()) != cudaSuccess ||
      (err = set_smem<bwd_dbc_kernel>()) != cudaSuccess)
    return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int lt = (L + WT - 1) / WT, ptl = (P + WT - 1) / WT,
            ntl = (N + NT - 1) / NT, ntw = (N + WT - 1) / WT;
  const size_t PN = size_t(P) * N;
  bwd_acum_kernel<<<blocks(size_t(B) * H * nc, ACUM_WARPS), ACUM_WARPS * 32,
                    0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_cb_kernel<<<dim3(nc * lt, G, B), NTHREADS, SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_state_kernel<<<dim3(nc * ptl * ntl * 2, H, B), NTHREADS, SMEM_BYTES,
                     s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_carry_kernel<<<dim3(blocks(PN, CARRY_PER_BLOCK), H, B), NTHREADS, 0,
                     s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dcb_kernel<<<dim3(nc, H, B), NTHREADS, SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (H != G) {
    bwd_dcbsum_kernel<<<blocks(size_t(B) * nc * G * L * p.Lr, NTHREADS),
                        NTHREADS, 0, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  bwd_dx_kernel<<<dim3(nc, H, B), NTHREADS, SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dbc_kernel<<<dim3(nc * ntw * 2 * hs, G, B), NTHREADS, SMEM_BYTES,
                   s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dbcsum_kernel<<<blocks(2 * size_t(B) * nc * G * L * N, NTHREADS),
                      NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dasum_kernel<<<H, LMAX, 0, s>>>(p);
  return int(cudaGetLastError());
}
