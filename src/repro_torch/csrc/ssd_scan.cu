// Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point bound through ctypes (repro_torch/kernels/ssd_scan.py).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan_fwd ->
// _ssd_kernel.  Same function, in f32: for each (batch, head) the sequence
// is cut into chunks of L tokens, and per chunk
//   intra-chunk  y[l]  = sum_{s<=l} (C[l].B[s]) exp(acum[l]-acum[s]) dt[s] x[s]
//   inter-chunk  y[l] += exp(acum[l]) (C[l] . S_prev)
//   state        S     = exp(acum[L-1]) S + sum_s exp(acum[L-1]-acum[s]) dt[s]
//                                                  x[s] B[s]^T       (P, N)
// with acum the inclusive prefix sum of dt*A over the chunk, tokens past
// the sequence given dt = 0 (and zero x, B, C), head h reading B/C group
// h / (H/G).  Returns y (B,S,H,P) and the final state (B,H,P,N).
//
// What bounds it on the H100: per (batch, head, chunk) the least work is
// ~L*L*N/2 (C.B^T, once per group) + 2*L*N*P (C.S_prev, state) + L*L*P/2
// (the weights times x) multiply-adds against ~L*(2P+2N) floats moved, so
// it is bound by operations.  One TF32 tensor-core pass does not hold the
// plain version's 1e-4 (tests/test_torch_ssd.py pins that); split TF32
// does: each f32 operand is split into hi = tf32(a) and lo = tf32(a - hi),
// rounded as cvt.rna.tf32 rounds, and every product is lo.hi + hi.lo, then
// + hi.hi, on the tensor cores: three TF32 products, against a bound of 3x
// the f32 work at 495 TFLOP/s.  The tensor cores truncate as they
// accumulate, so every K slice of 32 starts from zero and is added to the
// running sum with f32 adds: with one accumulator over the whole chunk the
// truncation error grew with the sum and crossed the tolerance at
// mamba2's shape for some seeds.  The state carry between chunks is bound
// by bytes.
//
// Design: the TPU grid's sequential chunk axis carried the (P, N) state in
// VMEM.  Only that carry is sequential, so the scan is four passes on one
// stream, three of them parallel over (batch, head, chunk):
//   A  per (chunk, 64-row tile, group, batch): CB = C.B^T (L x L, the
//      causal half) into scratch `cb`: once per group, not per head.
//   B  per (chunk, N tile, P tile, head, batch): the chunk's own state
//      dS_c = x^T (B * f), f[s] = exp(acum[L-1]-acum[s]) dt[s], into
//      scratch `st`, and acum[L-1] into scratch `at`.
//   C  per (P*N tile, head, batch), serial over chunks, elementwise:
//      S_c = exp(at_c) S_{c-1} + dS_c (multiply, then add, as the plain
//      version), writing each chunk's incoming state over dS_c in place
//      and the last into `fin`.
//   D  per (chunk, P tile, head, batch): y = exp(acum) * (C.S_prev^T)
//      + W.x, W = CB * exp(acum[l]-acum[s]) * dt[s] masked to s <= l.
// Passes B and D each compute their chunk's acum from dt, in token order,
// product and sum rounded separately (no FMA contraction), as the plain
// version takes it: acum reaches ~-100 within a chunk at mamba2's init,
// where one ulp of acum is ~1e-5 of the decay.  No exp of a positive
// difference is ever formed (s <= l only; acum never rises).
// Products (passes A, B, D): wgmma.m64n64k8 tf32, two warpgroups a block,
// each owning a 64 x 64 output tile.  wgmma takes tf32 A and B only
// K-major from shared memory, so every operand goes through a split pass:
// the K dimension (N for C.B^T and C.S_prev^T, tokens for W.x and the
// state) is staged raw in slices of 32 by cp.async (16-byte copies where
// the rows allow, else 4-byte; zero past the ragged edges) into a ring of
// 2; the block splits each slice once into hi and lo tiles, K-major in the
// 128-byte swizzle that wgmma reads, transposing the MN-major operands (x
// in W.x; x and B in the state) on the way, scaling B by f (pass B) and
// forming W from CB (pass D, one exp per element at or below the
// diagonal).  The next slice's copy is in flight meanwhile.  Per slice a
// warpgroup runs 12 wgmma (4 k-steps x 3 products).  Warpgroups whose rows
// or columns lie past the sequence, or above the diagonal, skip theirs.
// Output tiles leave through shared memory as whole rows.  ~98 KB of
// shared memory a block: two blocks an SM.  The loader, the split,
// slice_mma and store_tile are in ssd_tf32.cuh, shared with 6-bwd.
// Deterministic: no atomics; every sum runs in a fixed order.
// The wrapper allocates the scratch (`cb` B*nc*G*L*Lr floats with Lr = L
// rounded up to 4, `st` B*H*nc*P*N, `at` B*H*nc); the kernel allocates
// nothing.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "ssd_tf32.cuh"

namespace {

using namespace ssd_tf32;

constexpr int MAX_DEVICES = 64;
constexpr int LMAX = 128;          // largest chunk
constexpr int NMAX = 256;          // largest d_state
constexpr int PT = 64;             // P tile (passes B, D)
constexpr int NT = 128;            // N tile (pass B)
constexpr int LT = 64;             // row tile of C.B^T (pass A)
constexpr size_t SMEM_BYTES = TILES_BYTES + 2 * LMAX * 4;
constexpr int CARRY_PER_BLOCK = NTHREADS * 4;         // pass C elements

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* fin;
  float* cb;                       // (B, nc, G, L, Lr)
  float* st;                       // (B, H, nc, P, N)
  float* at;                       // (B, H, nc)
  int S, H, P, G, N, L, Lr, nc;
  bool vx, vbc, vst, vcb, vy;      // 16-byte copies allowed
};

// Shared memory of the three product passes: the split tiles and the
// ring (ssd_tf32.cuh), then dt and acum.
struct Smem : Tiles {
  float* dt;
  float* ac;
};

__device__ __forceinline__ Smem carve(char* base) {
  const Tiles t = carve_tiles(base);
  return Smem{t, t.end(), t.end() + LMAX};
}

// Waits until at most RING - 2 copy groups are pending: slice k is in.
__device__ __forceinline__ void cp_async_wait_slice() {
  cp_async_wait<RING - 2>();
}

// The chunk's dt (zero past the sequence) into sm.dt and its inclusive
// prefix sum of dt*A into sm.ac, over all LMAX entries (dt = 0 past L keeps
// the sum).  Ends with a barrier.
__device__ __forceinline__ void chunk_acum(const Params& p, const Smem& sm,
                                           int b, int h, int t0, int Lv) {
  for (int s = threadIdx.x; s < LMAX; s += NTHREADS)
    sm.dt[s] = s < Lv ? p.dt[(size_t(b) * p.S + t0 + s) * p.H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    // one warp, every lane running the sum over all tokens in order from
    // broadcast reads; lane j keeps acum[s] for s = j (mod 32)
    const int lane = threadIdx.x;
    const float A = p.A[h];
    float acc = 0.f, mine[LMAX / 32];
#pragma unroll
    for (int s = 0; s < LMAX; ++s) {
      acc = __fadd_rn(acc, __fmul_rn(sm.dt[s], A));
      if (lane == s % 32) mine[s / 32] = acc;
    }
#pragma unroll
    for (int i = 0; i < LMAX / 32; ++i) sm.ac[lane + 32 * i] = mine[i];
  }
  __syncthreads();
}

// ---- pass A: CB = C.B^T per (chunk, row tile, group, batch) ---------------

__global__ void __launch_bounds__(NTHREADS, 2) ssd_cb_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int nlt = (p.L + LT - 1) / LT;
  const int c = blockIdx.x / nlt, l0 = (blockIdx.x % nlt) * LT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  if (l0 >= Lv) return;                  // rows past the sequence: unread
  const int wg = threadIdx.x / 128;      // output columns s of 64 wg ..
  const bool active = 64 * wg <= l0 + LT - 1 && 64 * wg < Lv;
  const size_t ldg = size_t(p.G) * p.N;
  const float* gC = p.Cm + ((size_t(b) * p.S + t0 + l0) * p.G + g) * p.N;
  const float* gB = p.Bm + ((size_t(b) * p.S + t0) * p.G + g) * p.N;
  const int brows = min(Lv, l0 + LT);    // B rows s <= the tile's last row
  const int nk = (p.N + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    const int k0 = k * KS;
    if (k < nk) {
      load_tile(raw, gC + k0, ldg, LT, KS, Lv - l0, p.N - k0, p.vbc);
      load_tile(raw + LT * KS, gB + k0, ldg, LMAX, KS, brows, p.N - k0,
                p.vbc);
    }
    cp_async_commit();
  };

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < RING - 1; ++k) issue(k);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    split_rows(sm, sm.raw(k), 0, LT + LMAX);
    publish();
    if (active) slice_mma(tot, sm, 0, LT + 64 * wg);
  }
  float* out = p.cb + ((size_t(b) * p.nc + c) * p.G + g) * p.L * p.Lr +
               size_t(l0) * p.Lr;
  store_tile<LT, LMAX>(tot, sm, 0, 64 * wg, out, p.Lr, Lv - l0, p.L, p.vcb);
}

// ---- pass B: dS_c = x^T (B * f) per (chunk, N tile, P tile, head, batch) --

__global__ void __launch_bounds__(NTHREADS, 2)
ssd_state_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ntl = (p.N + NT - 1) / NT, ptl = (p.P + PT - 1) / PT;
  const int nt = blockIdx.x % ntl, pt = (blockIdx.x / ntl) % ptl;
  const int c = blockIdx.x / (ntl * ptl);
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  const int p0 = pt * PT, n0 = nt * NT;
  const int wg = threadIdx.x / 128;      // output columns n of 64 wg ..
  const bool active = n0 + 64 * wg < p.N;
  const float* gX = p.x + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  const float* gB = p.Bm + ((size_t(b) * p.S + t0) * p.G + g) * p.N + n0;
  const int nk = (Lv + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    const int k0 = k * KS;
    if (k < nk) {
      load_tile(raw, gX + size_t(k0) * p.H * p.P, size_t(p.H) * p.P, KS, PT,
                Lv - k0, p.P - p0, p.vx);
      load_tile(raw + KS * PT, gB + size_t(k0) * p.G * p.N,
                size_t(p.G) * p.N, KS, NT, Lv - k0, p.N - n0, p.vbc);
    }
    cp_async_commit();
  };

  for (int k = 0; k < RING - 1; ++k) issue(k);
  chunk_acum(p, sm, b, h, t0, Lv);
  const float atot = sm.ac[LMAX - 1];
  // f[s] = exp(acum[L-1] - acum[s]) dt[s], in place of dt (read only here)
  for (int s = threadIdx.x; s < LMAX; s += NTHREADS)
    sm.dt[s] = expf(atot - sm.ac[s]) * sm.dt[s];
  if (threadIdx.x == 0 && nt == 0 && pt == 0)
    p.at[(size_t(b) * p.H + h) * p.nc + c] = atot;

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    const float* raw = sm.raw(k);
    split_cols<false>(sm, raw, PT, 0, nullptr);                 // x^T
    split_cols<true>(sm, raw + KS * PT, NT, PT, sm.dt + k * KS);  // (B f)^T
    publish();
    if (active) slice_mma(tot, sm, 0, PT + 64 * wg);
  }
  float* out =
      p.st + (((size_t(b) * p.H + h) * p.nc + c) * p.P + p0) * p.N + n0;
  store_tile<PT, NT>(tot, sm, 0, 64 * wg, out, p.N, p.P - p0, p.N - n0,
                     p.vst);
}

// ---- pass C: the state carry across chunks, elementwise --------------------

__global__ void __launch_bounds__(NTHREADS)
ssd_carry_kernel(const Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t PN = size_t(p.P) * p.N;
  const size_t e0 = (size_t(blockIdx.x) * NTHREADS + threadIdx.x) * 4;
  if (e0 >= PN) return;
  const float* at = p.at + (size_t(b) * p.H + h) * p.nc;
  float* st = p.st + (size_t(b) * p.H + h) * p.nc * PN + e0;
  float* fin = p.fin + (size_t(b) * p.H + h) * PN + e0;
  const int ne = PN - e0 < 4 ? int(PN - e0) : 4;
  const bool vec = p.vst && ne == 4;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  constexpr int CU = 8;                  // chunks loaded ahead of the sums
  for (int c0 = 0; c0 < p.nc; c0 += CU) {
    float d[CU][4], decay[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (c0 + u >= p.nc) break;
      const float* sc = st + size_t(c0 + u) * PN;
      decay[u] = expf(at[c0 + u]);
      if (vec) {
        const float4 v = *reinterpret_cast<const float4*>(sc);
        d[u][0] = v.x; d[u][1] = v.y; d[u][2] = v.z; d[u][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) d[u][j] = j < ne ? sc[j] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (c0 + u >= p.nc) break;
      float* sc = st + size_t(c0 + u) * PN;
      if (vec) {
        *reinterpret_cast<float4*>(sc) =
            make_float4(carry[0], carry[1], carry[2], carry[3]);
      } else {
        for (int j = 0; j < ne; ++j) sc[j] = carry[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        carry[j] = __fadd_rn(__fmul_rn(carry[j], decay[u]), d[u][j]);
    }
  }
  for (int j = 0; j < ne; ++j) fin[j] = carry[j];
}

// ---- pass D: y = exp(acum) (C.S_prev^T) + W.x per (chunk, P tile, head) ---

__global__ void __launch_bounds__(NTHREADS, 2) ssd_y_kernel(const Params p) {
  extern __shared__ char smem_raw[];
  const Smem sm = carve(smem_raw);
  const int ptl = (p.P + PT - 1) / PT;
  const int pt = blockIdx.x % ptl, c = blockIdx.x / ptl;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int t0 = c * p.L, Lv = min(p.L, p.S - t0);
  const int p0 = pt * PT;
  const int wg = threadIdx.x / 128;      // output rows l of 64 wg ..
  const bool live = 64 * wg < Lv;
  const size_t ldbc = size_t(p.G) * p.N;
  const float* gC = p.Cm + ((size_t(b) * p.S + t0) * p.G + g) * p.N;
  const float* gS =
      p.st + (((size_t(b) * p.H + h) * p.nc + c) * p.P + p0) * p.N;
  const float* gW = p.cb + ((size_t(b) * p.nc + c) * p.G + g) * p.L * p.Lr;
  const float* gX = p.x + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  // K slices: first C.S_prev^T over N (none for the first chunk, whose
  // incoming state is zero), then W.x over the chunk's tokens
  const int n1 = c > 0 ? (p.N + KS - 1) / KS : 0;
  const int nk = n1 + (Lv + KS - 1) / KS;

  auto issue = [&](int k) {             // slice k, or an empty group
    float* raw = sm.raw(k);
    if (k >= nk) {
    } else if (k < n1) {
      const int k0 = k * KS;
      load_tile(raw, gC + k0, ldbc, LMAX, KS, Lv, p.N - k0, p.vbc);
      load_tile(raw + LMAX * KS, gS + k0, p.N, PT, KS, p.P - p0, p.N - k0,
                p.vst);
    } else {
      // CB rows from the first warpgroup that reads this slice
      const int k0 = (k - n1) * KS, r0 = k0 / 64 * 64;
      load_tile(raw + r0 * KS, gW + size_t(r0) * p.Lr + k0, p.Lr, LMAX - r0,
                KS, Lv - r0, Lv - k0, p.vcb);
      load_tile(raw + LMAX * KS, gX + size_t(k0) * p.H * p.P,
                size_t(p.H) * p.P, KS, PT, Lv - k0, p.P - p0, p.vx);
    }
    cp_async_commit();
  };

  for (int k = 0; k < RING - 1; ++k) issue(k);
  chunk_acum(p, sm, b, h, t0, Lv);

  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tot[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait_slice();
    __syncthreads();
    issue(k + RING - 1);
    const float* raw = sm.raw(k);
    if (k < n1) {
      split_rows(sm, raw, 0, LMAX + PT);                 // C, S_prev
      publish();
      if (live) slice_mma(tot, sm, 64 * wg, LMAX);
      continue;
    }
    const int k0 = (k - n1) * KS;
    if (k == n1 && n1 > 0) {             // the inter-chunk term's decay
#pragma unroll
      for (int i = 0; i < 32; ++i) tot[i] *= expf(sm.ac[64 * wg + acc_row(i)]);
    }
    // the weights: W[l][s] = CB[l][s] exp(acum[l]-acum[s]) dt[s] for s <= l,
    // else 0, from the first row of the first warpgroup that reads this
    // slice
    const int r0 = k0 / 64 * 64;
    for (int i = threadIdx.x; i < (LMAX - r0) * (KS / 4); i += NTHREADS) {
      const int l = r0 + i / (KS / 4), cq = i % (KS / 4);
      const float4 q =
          *reinterpret_cast<const float4*>(raw + l * KS + cq * 4);
      float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + cq * 4 + j;
        v[j] = s <= l ? v[j] * expf(sm.ac[l] - sm.ac[s]) * sm.dt[s] : 0.f;
      }
      put4(sm, l, cq, v);
    }
    split_cols<false>(sm, raw + LMAX * KS, PT, LMAX, nullptr);  // x^T
    publish();
    if (live && k0 <= 64 * wg + 63) slice_mma(tot, sm, 64 * wg, LMAX);
  }
  float* out = p.y + ((size_t(b) * p.S + t0) * p.H + h) * p.P + p0;
  store_tile<LMAX, PT>(tot, sm, 64 * wg, 0, out, size_t(p.H) * p.P, Lv,
                       p.P - p0, p.vy);
}

// Raises a kernel's dynamic shared-memory limit once per device.
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

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// All tensors float32 and contiguous: x, y (B,S,H,P); dt (B,S,H); A (H,);
// Bm, Cm (B,S,G,N); fin (B,H,P,N); scratch cb (B,nc,G,L,Lr), st
// (B,H,nc,P,N), at (B,H,nc) with nc = ceil(S/L) and Lr = L rounded up to a
// multiple of 4.  L is the chunk length (min(chunk, S)).  Launches the four
// passes on `stream` and returns the first cudaError_t.
extern "C" int repro_ssd_scan_fwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, float* y, float* fin,
                                  float* cb, float* st, float* at, int B,
                                  int S, int H, int P, int G, int N, int L,
                                  void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || L < 1 || L > LMAX || B > 65535 || H > 65535 || G > 65535)
    return int(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fin, cb, st, at, S, H, P, G, N, L,
           (L + 3) / 4 * 4, (S + L - 1) / L, false, false, false, false,
           false};
  p.vx = P % 4 == 0 && aligned16(x);
  p.vbc = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  p.vst = N % 4 == 0 && aligned16(st);
  p.vcb = aligned16(cb);
  p.vy = P % 4 == 0 && aligned16(y);
  cudaError_t err;
  if ((err = set_smem<ssd_cb_kernel>()) != cudaSuccess ||
      (err = set_smem<ssd_state_kernel>()) != cudaSuccess ||
      (err = set_smem<ssd_y_kernel>()) != cudaSuccess)
    return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ptl = (P + PT - 1) / PT, ntl = (N + NT - 1) / NT;
  ssd_cb_kernel<<<dim3(p.nc * ((L + LT - 1) / LT), G, B), NTHREADS,
                  SMEM_BYTES, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_state_kernel<<<dim3(p.nc * ntl * ptl, H, B), NTHREADS, SMEM_BYTES,
                     s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t PN = size_t(P) * N;
  ssd_carry_kernel<<<dim3(unsigned((PN + CARRY_PER_BLOCK - 1) /
                                   CARRY_PER_BLOCK), H, B),
                     NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  ssd_y_kernel<<<dim3(p.nc * ptl, H, B), NTHREADS, SMEM_BYTES, s>>>(p);
  return int(cudaGetLastError());
}
