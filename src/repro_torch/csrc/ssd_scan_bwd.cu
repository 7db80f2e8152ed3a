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
// is bound by operations.  This first version runs every product on the
// f32 CUDA cores (a 64 x 64 output tile per block of 256 threads, 4 x 4
// outputs a thread, K slices of 16 staged in shared memory), so it holds
// the plain version's numbers to f32 summation order; split-TF32 wgmma,
// as the forward's, is later work.
//
// Design: ten passes on one stream, each parallel over (batch, head or
// group, chunk) except the two serial carries, which are elementwise:
//   1 acum   per (batch, head, chunk): acum, e and f into `vec`;
//   2 cb     per (chunk, tile pair, group, batch): C.B^T, causal tiles;
//   3 state  per (chunk, P tile, N tile, head, batch), two jobs: the
//            chunk's own state into `st`, local_c into `ds`;
//   4 carry  per (P*N element, head, batch): st becomes each chunk's
//            incoming state S_prev (forward), ds each chunk's dS_out
//            (reverse);
//   5 dcb    per (chunk, head, batch): dW by causal tile pairs into dCB
//            (`dcb`) and dW W into shared memory, whose exclusive row
//            prefix sums and column sums give the stable pair term of
//            da; gy.y_off and <dS_out, S_prev> give the rest but the
//            f r prefix, into `vec`;
//   6 dcbsum per element: dCB summed over the group's heads in head order
//            (`dcbg`; skipped when each group has one head);
//   7 dx     per (chunk, token tile, head, batch): dx, and per token r_s
//            and ddt's direct terms into `vec`;
//   8 dbc    per (chunk, row tile, N tile, group, head block, batch), two
//            jobs: dC and dB, each one product over K = the chunk's tokens
//            (intra, first head block only) then the block's heads times P
//            (state terms), into `part` (HSPLIT head blocks, so a group of
//            48 heads fills the card);
//   9 dbcsum per element: dC and dB, `part` summed in head-block order;
//  10 dt     per head, serial over (batch, chunk): the f r prefix, ddt,
//            and dA summed in (batch, chunk, token) order.
// Deterministic: no atomics; every sum runs in a fixed order.
// The wrapper allocates the scratch (`vec` 6*B*H*nc*L, `cb` B*nc*G*L*L,
// `st` and `ds` B*H*nc*P*N, `dcb` B*nc*H*L*L, `dcbg` B*nc*G*L*L or none,
// `part` 2*hs*B*nc*G*L*N); the kernel allocates nothing.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int LMAX = 128;          // largest chunk
constexpr int NTHREADS = 256;      // every pass but acum and dt
constexpr int TM = 64;             // output tile rows
constexpr int TN = 64;             // output tile columns
constexpr int TK = 16;             // K slice
constexpr int LD = TM + 1;         // staged slice pitch: no bank conflicts
constexpr int CU = 8;               // chunks a carry loads ahead of its sums
constexpr int HSPLIT = 4;          // head blocks of pass 8's state terms
constexpr int VEC_ACUM = 0, VEC_E = 1, VEC_F = 2, VEC_DA = 3, VEC_DDT = 4,
              VEC_R = 5;           // the vectors of `vec`, (B, H, nc, L) each

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
  float* vec;                      // 6 x (B, H, nc, L)
  float* cb;                       // (B, nc, G, L, L)
  float* st;                       // (B, H, nc, P, N)
  float* ds;                       // (B, H, nc, P, N)
  float* dcb;                      // (B, nc, H, L, L)
  float* dcbg;                     // (B, nc, G, L, L), or dcb when H == G
  float* part;                     // (2, hs, B, nc, G, L, N)
  int Bsz, S, H, P, G, N, L, nc, rep, hs;
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
__device__ __forceinline__ size_t pni(const Params& p, int b, int h, int c) {
  return ((size_t(b) * p.H + h) * p.nc + c) * size_t(p.P) * p.N;
}
__device__ __forceinline__ size_t lli(const Params& p, int b, int c, int k,
                                      int K) {
  return ((size_t(b) * p.nc + c) * K + k) * size_t(p.L) * p.L;
}

__device__ __forceinline__ int chunk_len(const Params& p, int c) {
  return min(p.L, p.S - c * p.L);
}

// ---- the tile product on the CUDA cores -------------------------------------

// Shared memory of one product: a K slice of each operand, k-major.
struct Stage {
  float a[TK * LD];
  float b[TK * LD];
};

// acc[i][j] += sum_{k0 <= k < k1} A(i, k) B(k, j) for the thread's rows
// ty + 16 i and columns tx + 16 j of a TM x TN tile (ty = thread / 16, tx
// = thread % 16).  fa(i, k) and fb(k, j) read device memory and give 0
// outside the operands.  AK / BK: the operand is contiguous along k, so
// consecutive threads stage consecutive k; else consecutive i (j).  The
// k order of every sum is fixed.  Called by the whole block.
template <bool AK, bool BK, class FA, class FB>
__device__ __forceinline__ void product(float (&acc)[4][4], Stage& sm, int k0,
                                        int k1, FA fa, FB fb) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int kb = k0; kb < k1; kb += TK) {
    for (int e = threadIdx.x; e < TK * TM; e += NTHREADS) {
      const int kk = AK ? e % TK : e / TM, i = AK ? e / TK : e % TM;
      sm.a[kk * LD + i] = kb + kk < k1 ? fa(i, kb + kk) : 0.f;
    }
    for (int e = threadIdx.x; e < TK * TN; e += NTHREADS) {
      const int kk = BK ? e % TK : e / TN, j = BK ? e / TK : e % TN;
      sm.b[kk * LD + j] = kb + kk < k1 ? fb(kb + kk, j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[kk * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ int row_of(int i) {
  return threadIdx.x / 16 + 16 * i;
}
__device__ __forceinline__ int col_of(int j) {
  return threadIdx.x % 16 + 16 * j;
}

// out[r] += sum over the tile's columns of part[i] (the thread's sum over
// its own columns of row row_of(i)), in column-thread order: a fixed order.
// red holds TM * 16 floats.  Called by the whole block.
__device__ __forceinline__ void row_sums(const float (&part)[4], float* red,
                                         float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) red[row_of(i) * 16 + threadIdx.x % 16] = part[i];
  __syncthreads();
  if (threadIdx.x < TM) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[threadIdx.x * 16 + t];
    out[threadIdx.x] += s;
  }
  __syncthreads();
}

// ---- pass 1: acum, e = exp(acum), f = exp(acum[L-1] - acum) dt ----------------

__global__ void __launch_bounds__(128) bwd_acum_kernel(const Params p) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= size_t(p.Bsz) * p.H * p.nc) return;
  const int c = idx % p.nc, h = (idx / p.nc) % p.H,
            b = idx / (size_t(p.nc) * p.H);
  const int Lv = chunk_len(p, c), t0 = c * p.L;
  const float A = p.A[h];
  float* ac = p.vec + VEC_ACUM * p.V + veci(p, b, h, c);
  float* ex = p.vec + VEC_E * p.V + veci(p, b, h, c);
  float* fx = p.vec + VEC_F * p.V + veci(p, b, h, c);
  // in token order, product and sum rounded apart, as the plain version
  float acc = 0.f;
  for (int l = 0; l < p.L; ++l) {
    const float d = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    acc = __fadd_rn(acc, __fmul_rn(d, A));
    ac[l] = acc;
  }
  for (int l = 0; l < p.L; ++l) {
    const float d = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    ex[l] = expf(ac[l]);
    fx[l] = expf(acc - ac[l]) * d;
  }
}

// ---- pass 2: CB = C.B^T per (chunk, tile pair, group, batch) -----------------

__global__ void __launch_bounds__(NTHREADS) bwd_cb_kernel(const Params p) {
  __shared__ Stage sm;
  const int lt = (p.L + TM - 1) / TM;
  const int c = blockIdx.x / (lt * lt), li = (blockIdx.x / lt) % lt,
            si = blockIdx.x % lt;
  const int g = blockIdx.y, b = blockIdx.z;
  const int Lv = chunk_len(p, c), t0 = c * p.L;
  const int l0 = li * TM, s0 = si * TN;
  if (si > li || l0 >= Lv) return;       // above the diagonal, or unread
  float acc[4][4];
  zero(acc);
  product<true, true>(
      acc, sm, 0, p.N,
      [&](int i, int k) {
        return l0 + i < Lv ? p.Cm[bci(p, b, t0 + l0 + i, g, k)] : 0.f;
      },
      [&](int k, int j) {
        return s0 + j < Lv ? p.Bm[bci(p, b, t0 + s0 + j, g, k)] : 0.f;
      });
  float* out = p.cb + lli(p, b, c, g, p.G);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = l0 + row_of(i), s = s0 + col_of(j);
      if (l < p.L && s < p.L) out[size_t(l) * p.L + s] = acc[i][j];
    }
}

// ---- pass 3: the chunk's own state (job 0) and local_c (job 1) ---------------

__global__ void __launch_bounds__(NTHREADS) bwd_state_kernel(const Params p) {
  __shared__ Stage sm;
  __shared__ float scale[LMAX];
  const int ptl = (p.P + TM - 1) / TM, ntl = (p.N + TN - 1) / TN;
  const int c = blockIdx.x / (ptl * ntl), p0 = (blockIdx.x / ntl) % ptl * TM,
            n0 = blockIdx.x % ntl * TN;
  const int h = blockIdx.y, b = blockIdx.z >> 1, job = blockIdx.z & 1;
  const int g = h / p.rep;
  const int Lv = chunk_len(p, c), t0 = c * p.L;
  // job 0: st = sum_s x_s (x) f_s B_s; job 1: ds = sum_l e_l gy_l (x) C_l
  const float* rows = job ? p.gy : p.x;
  const float* cols = job ? p.Cm : p.Bm;
  const float* sv = p.vec + (job ? VEC_E : VEC_F) * p.V + veci(p, b, h, c);
  for (int l = threadIdx.x; l < p.L; l += NTHREADS) scale[l] = sv[l];
  __syncthreads();
  float acc[4][4];
  zero(acc);
  product<false, false>(
      acc, sm, 0, Lv,
      [&](int i, int k) {
        return p0 + i < p.P ? rows[xi(p, b, t0 + k, h, p0 + i)] : 0.f;
      },
      [&](int k, int j) {
        return n0 + j < p.N ? scale[k] * cols[bci(p, b, t0 + k, g, n0 + j)]
                            : 0.f;
      });
  float* out = (job ? p.ds : p.st) + pni(p, b, h, c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = p0 + row_of(i), n = n0 + col_of(j);
      if (q < p.P && n < p.N) out[size_t(q) * p.N + n] = acc[i][j];
    }
}

// ---- pass 4: the two carries over chunks, elementwise --------------------------

__global__ void __launch_bounds__(NTHREADS) bwd_carry_kernel(const Params p) {
  const size_t PN = size_t(p.P) * p.N;
  const size_t e = size_t(blockIdx.x) * NTHREADS + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const float* ex = p.vec + VEC_E * p.V + veci(p, b, h, 0) + p.L - 1;
  float* st = p.st + pni(p, b, h, 0) + e;
  float* ds = p.ds + pni(p, b, h, 0) + e;
  // forward: st[c] becomes the state entering chunk c; CU chunks are
  // loaded ahead of their sums, so their loads overlap
  float carry = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += CU) {
    const int n = min(CU, p.nc - c0);
    float d[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (u < n) d[u] = st[(c0 + u) * PN];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (u >= n) break;
      st[(c0 + u) * PN] = carry;
      carry = __fadd_rn(__fmul_rn(carry, ex[size_t(c0 + u) * p.L]), d[u]);
    }
  }
  // reverse: ds[c] becomes the gradient of the state leaving chunk c
  float g = p.gfin ? p.gfin[(size_t(b) * p.H + h) * PN + e] : 0.f;
  for (int c1 = p.nc; c1 > 0; c1 -= CU) {
    const int n = min(CU, c1);           // chunks c1 - 1 down to c1 - n
    float d[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (u < n) d[u] = ds[(c1 - 1 - u) * PN];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (u >= n) break;
      const int c = c1 - 1 - u;
      ds[c * PN] = g;
      g = __fadd_rn(__fmul_rn(g, ex[size_t(c) * p.L]), d[u]);
    }
  }
}

// ---- pass 5: dCB, and da but for the f r prefix, per (chunk, head, batch) ------

// Dynamic shared memory of pass 5 at chunk length L (floats).
__host__ __device__ constexpr size_t dcb_smem_floats(int L) {
  return size_t(L) * (L + 1) + sizeof(Stage) / 4 + 3 * LMAX + TM * 16 +
         NTHREADS;
}

__global__ void __launch_bounds__(NTHREADS) bwd_dcb_kernel(const Params p) {
  extern __shared__ float dyn[];
  const int L = p.L, LQ = L + 1;
  float* q = dyn;                                      // (L, L + 1): dW W
  Stage& sm = *reinterpret_cast<Stage*>(q + size_t(L) * LQ);
  float* sac = q + size_t(L) * LQ + sizeof(Stage) / 4; // acum
  float* sdt = sac + LMAX;                             // dt, 0 past Lv
  float* so = sdt + LMAX;                              // sum_p gy.(S_prev C)
  float* red = so + LMAX;                              // TM * 16
  float* red2 = red + TM * 16;                         // NTHREADS
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / p.rep;
  const int Lv = chunk_len(p, c), t0 = c * L;
  const int lt = (L + TM - 1) / TM;
  const float* ac = p.vec + VEC_ACUM * p.V + veci(p, b, h, c);
  for (int l = threadIdx.x; l < LMAX; l += NTHREADS) {
    sac[l] = l < L ? ac[l] : 0.f;
    sdt[l] = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    so[l] = 0.f;
  }
  for (int i = threadIdx.x; i < L * LQ; i += NTHREADS) q[i] = 0.f;
  __syncthreads();

  // dW = gy.x^T on the causal tile pairs
  const float* cb = p.cb + lli(p, b, c, g, p.G);
  float* dcb = p.dcb + lli(p, b, c, h, p.H);
  for (int li = 0; li < lt; ++li) {
    const int l0 = li * TM;
    if (l0 >= Lv) break;
    for (int si = 0; si <= li; ++si) {
      const int s0 = si * TN;
      float acc[4][4];
      zero(acc);
      product<true, true>(
          acc, sm, 0, p.P,
          [&](int i, int k) {
            return l0 + i < Lv ? p.gy[xi(p, b, t0 + l0 + i, h, k)] : 0.f;
          },
          [&](int k, int j) {
            return s0 + j < Lv ? p.x[xi(p, b, t0 + s0 + j, h, k)] : 0.f;
          });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = l0 + row_of(i), s = s0 + col_of(j);
          if (l >= L || s >= L) continue;
          float v = 0.f;
          if (s <= l && l < Lv) {
            const float d = acc[i][j] * expf(sac[l] - sac[s]);
            v = d * sdt[s];
            q[l * LQ + s] = d * cb[size_t(l) * L + s] * sdt[s];
          }
          dcb[size_t(l) * L + s] = v;
        }
    }
  }
  __syncthreads();                       // q is read across threads below

  // so_l = sum_p gy_l[p] (S_prev C_l)[p]; kc = exp(acum[L-1]) <dS_out, S_prev>
  // (both zero in the first chunk, whose incoming state is zero)
  float kc = 0.f;
  if (c > 0) {
    const float* sp = p.st + pni(p, b, h, c);
    const float* dso = p.ds + pni(p, b, h, c);
    const int ptl = (p.P + TN - 1) / TN;
    for (int li = 0; li < lt; ++li) {
      const int l0 = li * TM;
      if (l0 >= Lv) break;
      for (int pt = 0; pt < ptl; ++pt) {
        const int p0 = pt * TN;
        float acc[4][4];
        zero(acc);
        product<true, true>(
            acc, sm, 0, p.N,
            [&](int i, int k) {
              return l0 + i < Lv ? p.Cm[bci(p, b, t0 + l0 + i, g, k)] : 0.f;
            },
            [&](int k, int j) {
              return p0 + j < p.P ? sp[size_t(p0 + j) * p.N + k] : 0.f;
            });
        float part[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          part[i] = 0.f;
          const int l = l0 + row_of(i);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qq = p0 + col_of(j);
            if (l < Lv && qq < p.P)
              part[i] += p.gy[xi(p, b, t0 + l, h, qq)] * acc[i][j];
          }
        }
        row_sums(part, red, so + l0);
      }
    }
    const size_t PN = size_t(p.P) * p.N;
    float s = 0.f;
    for (size_t e = threadIdx.x; e < PN; e += NTHREADS) s += dso[e] * sp[e];
    red2[threadIdx.x] = s;
    __syncthreads();
    for (int w = NTHREADS / 2; w > 0; w /= 2) {
      if (threadIdx.x < w) red2[threadIdx.x] += red2[threadIdx.x + w];
      __syncthreads();
    }
    kc = expf(sac[L - 1]) * red2[0];
  }

  // the pair term sum_{l>=j, s<j} q[l, s]: exclusive row prefixes in place,
  // then column sums over l >= j
  if (threadIdx.x < Lv) {
    const int l = threadIdx.x;
    float run = 0.f;
    for (int s = 0; s <= l; ++s) {
      const float v = q[l * LQ + s];
      q[l * LQ + s] = run;
      run += v;
    }
  }
  __syncthreads();
  float* da = p.vec + VEC_DA * p.V + veci(p, b, h, c);
  const float* ex = p.vec + VEC_E * p.V + veci(p, b, h, c);
  for (int j = threadIdx.x; j < L; j += NTHREADS) {
    float t = 0.f, o = 0.f;
    for (int l = j; l < Lv; ++l) {
      t += q[l * LQ + j];
      o += ex[l] * so[l];
    }
    da[j] = j < Lv ? t + o + kc : 0.f;
  }
}

// ---- pass 6: dCB summed over the group's heads -------------------------------

__global__ void __launch_bounds__(NTHREADS) bwd_dcbsum_kernel(const Params p) {
  const size_t LL = size_t(p.L) * p.L;
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

// ---- pass 7: dx, r and ddt's direct terms per (chunk, token tile, head) --------

__global__ void __launch_bounds__(NTHREADS) bwd_dx_kernel(const Params p) {
  __shared__ Stage sm;
  __shared__ float sac[LMAX], sdt[LMAX], sf[LMAX], red[TM * 16], zs[TM],
      rs[TM];
  const int lt = (p.L + TM - 1) / TM;
  const int c = blockIdx.x / lt, s0 = blockIdx.x % lt * TM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / p.rep;
  const int L = p.L, Lv = chunk_len(p, c), t0 = c * L;
  if (s0 >= Lv) return;
  const size_t v0 = veci(p, b, h, c);
  for (int l = threadIdx.x; l < LMAX; l += NTHREADS) {
    sac[l] = l < L ? p.vec[VEC_ACUM * p.V + v0 + l] : 0.f;
    sdt[l] = l < Lv ? p.dt[(size_t(b) * p.S + t0 + l) * p.H + h] : 0.f;
    sf[l] = l < L ? p.vec[VEC_F * p.V + v0 + l] : 0.f;
  }
  if (threadIdx.x < TM) zs[threadIdx.x] = rs[threadIdx.x] = 0.f;
  __syncthreads();
  const float* cb = p.cb + lli(p, b, c, g, p.G);
  const float* dso = p.ds + pni(p, b, h, c);
  const int ptl = (p.P + TN - 1) / TN;
  for (int pt = 0; pt < ptl; ++pt) {
    const int p0 = pt * TN;
    // gi[s][q] = sum_{l>=s} CB[l][s] decay[l][s] gy_l[q]
    float gi[4][4], u[4][4];
    zero(gi);
    product<false, false>(
        gi, sm, s0, Lv,
        [&](int i, int k) {
          const int s = s0 + i;
          return s <= k ? cb[size_t(k) * L + s] * expf(sac[k] - sac[s]) : 0.f;
        },
        [&](int k, int j) {
          return p0 + j < p.P ? p.gy[xi(p, b, t0 + k, h, p0 + j)] : 0.f;
        });
    // u[s][q] = sum_n B_s[n] dS_out[q][n]
    zero(u);
    product<true, true>(
        u, sm, 0, p.N,
        [&](int i, int k) {
          return s0 + i < Lv ? p.Bm[bci(p, b, t0 + s0 + i, g, k)] : 0.f;
        },
        [&](int k, int j) {
          return p0 + j < p.P ? dso[size_t(p0 + j) * p.N + k] : 0.f;
        });
    float pz[4], pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pz[i] = pr[i] = 0.f;
      const int s = s0 + row_of(i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qq = p0 + col_of(j);
        if (s >= Lv || qq >= p.P) continue;
        const size_t o = xi(p, b, t0 + s, h, qq);
        const float xv = p.x[o];
        p.dx[o] = gi[i][j] * sdt[s] + u[i][j] * sf[s];
        pz[i] += xv * gi[i][j];
        pr[i] += xv * u[i][j];
      }
    }
    row_sums(pz, red, zs);
    row_sums(pr, red, rs);
  }
  if (threadIdx.x < TM && s0 + threadIdx.x < Lv) {
    const int s = s0 + threadIdx.x;
    p.vec[VEC_R * p.V + v0 + s] = rs[threadIdx.x];
    p.vec[VEC_DDT * p.V + v0 + s] =
        zs[threadIdx.x] + expf(sac[L - 1] - sac[s]) * rs[threadIdx.x];
  }
}

// ---- pass 8: dC (job 0) and dB (job 1) per (chunk, row tile, N tile, group
// and head block): the state terms' K split over hs blocks of the group's
// heads, each block's tile into `part`; the first block adds the intra term

__global__ void __launch_bounds__(NTHREADS) bwd_dbc_kernel(const Params p) {
  __shared__ Stage sm;
  const int lt = (p.L + TM - 1) / TM, ntl = (p.N + TN - 1) / TN;
  const int c = blockIdx.x / (lt * ntl), r0 = (blockIdx.x / ntl) % lt * TM,
            n0 = blockIdx.x % ntl * TN;
  const int g = blockIdx.y / p.hs, q = blockIdx.y % p.hs;
  const int b = blockIdx.z >> 1, job = blockIdx.z & 1;
  const int L = p.L, Lv = chunk_len(p, c), t0 = c * L;
  if (r0 >= Lv) return;
  const float* dcb = p.dcbg + lli(p, b, c, g, p.G);
  // this block's heads [h0, h1) of the group's, as K = (head, q) pairs
  const int hb = (p.rep + p.hs - 1) / p.hs;
  const int h0 = g * p.rep + min(p.rep, q * hb),
            h1 = g * p.rep + min(p.rep, (q + 1) * hb);
  const int KS = (h1 - h0) * p.P;
  float acc[4][4];
  zero(acc);
  if (job == 0) {
    // dC_l = sum_{s<=l} dCB[l][s] B_s + sum_h e_l S_prev^T gy_l
    if (q == 0)
      product<true, false>(
          acc, sm, 0, min(r0 + TM, Lv),
          [&](int i, int k) {
            const int l = r0 + i;
            return k <= l && l < Lv ? dcb[size_t(l) * L + k] : 0.f;
          },
          [&](int k, int j) {
            return n0 + j < p.N ? p.Bm[bci(p, b, t0 + k, g, n0 + j)] : 0.f;
          });
    if (c > 0)
      product<true, false>(
          acc, sm, 0, KS,
          [&](int i, int k) {
            const int l = r0 + i, h = h0 + k / p.P;
            return l < Lv ? p.vec[VEC_E * p.V + veci(p, b, h, c) + l] *
                                p.gy[xi(p, b, t0 + l, h, k % p.P)]
                          : 0.f;
          },
          [&](int k, int j) {
            const int h = h0 + k / p.P;
            return n0 + j < p.N ? p.st[pni(p, b, h, c) +
                                       size_t(k % p.P) * p.N + n0 + j]
                                : 0.f;
          });
  } else {
    // dB_s = sum_{l>=s} dCB[l][s] C_l + sum_h f_s dS_out^T x_s
    if (q == 0)
      product<false, false>(
          acc, sm, r0, Lv,
          [&](int i, int k) {
            const int s = r0 + i;
            return s <= k ? dcb[size_t(k) * L + s] : 0.f;
          },
          [&](int k, int j) {
            return n0 + j < p.N ? p.Cm[bci(p, b, t0 + k, g, n0 + j)] : 0.f;
          });
    product<true, false>(
        acc, sm, 0, KS,
        [&](int i, int k) {
          const int s = r0 + i, h = h0 + k / p.P;
          return s < Lv ? p.vec[VEC_F * p.V + veci(p, b, h, c) + s] *
                              p.x[xi(p, b, t0 + s, h, k % p.P)]
                        : 0.f;
        },
        [&](int k, int j) {
          const int h = h0 + k / p.P;
          return n0 + j < p.N
                     ? p.ds[pni(p, b, h, c) + size_t(k % p.P) * p.N + n0 + j]
                     : 0.f;
        });
  }
  float* out = p.part +
               ((((size_t(job) * p.hs + q) * p.Bsz + b) * p.nc + c) * p.G + g) *
                   L * p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + row_of(i), n = n0 + col_of(j);
      if (r < Lv && n < p.N) out[size_t(r) * p.N + n] = acc[i][j];
    }
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

// ---- pass 10: the f r prefix, ddt and dA per head -------------------------------

__global__ void __launch_bounds__(LMAX) bwd_dt_kernel(const Params p) {
  __shared__ float fr[LMAX], red[LMAX];
  const int h = blockIdx.x, j = threadIdx.x;
  const float A = p.A[h];
  float acc = 0.f;                       // sum of dt da over (b, c), in order
  for (int b = 0; b < p.Bsz; ++b)
    for (int c = 0; c < p.nc; ++c) {
      const int Lv = chunk_len(p, c), t0 = c * p.L;
      const size_t v0 = veci(p, b, h, c);
      fr[j] = j < Lv ? p.vec[VEC_F * p.V + v0 + j] * p.vec[VEC_R * p.V + v0 + j]
                     : 0.f;
      __syncthreads();
      if (j < Lv) {
        float pre = 0.f;
        for (int s = 0; s < j; ++s) pre += fr[s];
        const float da = p.vec[VEC_DA * p.V + v0 + j] + pre;
        const size_t o = (size_t(b) * p.S + t0 + j) * p.H + h;
        p.ddt[o] = p.vec[VEC_DDT * p.V + v0 + j] + A * da;
        acc += p.dt[o] * da;
      }
      __syncthreads();
    }
  red[j] = acc;
  __syncthreads();
  if (j == 0) {
    float s = 0.f;
    for (int t = 0; t < LMAX; ++t) s += red[t];
    p.dA[h] = s;
  }
}

// Raises pass 5's dynamic shared-memory limit once per device.
cudaError_t set_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(bwd_dcb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(4 * dcb_smem_floats(LMAX)));
  if (err == cudaSuccess) done[dev].store(true);
  return err;
}

unsigned blocks(size_t n, int per) { return unsigned((n + per - 1) / per); }

}  // namespace

// All tensors float32 and contiguous: x, gy, dx (B,S,H,P); dt, ddt (B,S,H);
// A, dA (H,); Bm, Cm, dB, dC (B,S,G,N); gfin (B,H,P,N) or null; scratch vec
// (6,B,H,nc,L), cb (B,nc,G,L,L), st and ds (B,H,nc,P,N), dcb (B,nc,H,L,L),
// dcbg (B,nc,G,L,L), or null when H == G, part (2,hs,B,nc,G,L,N) with hs
// = min(H/G, HSPLIT), with nc = ceil(S/L).  L is the chunk length (min(chunk,
// S)).  Launches the passes on `stream` and returns the first cudaError_t.
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
      L < 1 || L > LMAX || B > 32767 || H > 65535 || G > 16383 ||
      (H != G && dcbg == nullptr) || part == nullptr)
    return int(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  const int rep = H / G, hs = rep < HSPLIT ? rep : HSPLIT;
  Params p{x,  dt,  A,  Bm, Cm, gy, gfin, dx,  ddt, dA, dB, dC, vec, cb, st,
           ds, dcb, H == G ? dcb : dcbg, part, B, S, H, P, G, N, L, nc, rep,
           hs, size_t(B) * H * nc * L};
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return int(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const int lt = (L + TM - 1) / TM, ptl = (P + TM - 1) / TM,
            ntl = (N + TN - 1) / TN;
  const size_t PN = size_t(P) * N;
  bwd_acum_kernel<<<blocks(size_t(B) * H * nc, 128), 128, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_cb_kernel<<<dim3(nc * lt * lt, G, B), NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_state_kernel<<<dim3(nc * ptl * ntl, H, 2 * B), NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_carry_kernel<<<dim3(blocks(PN, NTHREADS), H, B), NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dcb_kernel<<<dim3(nc, H, B), NTHREADS, 4 * dcb_smem_floats(L), s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (H != G) {
    bwd_dcbsum_kernel<<<blocks(size_t(B) * nc * G * L * L, NTHREADS),
                        NTHREADS, 0, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  bwd_dx_kernel<<<dim3(nc * lt, H, B), NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dbc_kernel<<<dim3(nc * lt * ntl, G * hs, 2 * B), NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dbcsum_kernel<<<blocks(2 * size_t(B) * nc * G * L * N, NTHREADS),
                      NTHREADS, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  bwd_dt_kernel<<<H, LMAX, 0, s>>>(p);
  return int(cudaGetLastError());
}
