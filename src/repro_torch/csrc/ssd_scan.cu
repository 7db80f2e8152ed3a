// Mamba2 SSD chunk scan for Hopper (sm_90a), CUDA C++ with a plain C entry
// point bound through ctypes (repro_torch/kernels/ssd_scan.py).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py: ssd_scan_fwd ->
// _ssd_kernel.  Same function, in f32 throughout: for each (batch, head)
// the sequence is cut into chunks of L tokens, and per chunk
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
// (the weights times x) multiply-adds in f32 against ~L*(2P+2N) floats
// moved, so it is bound by f32 operations (67 TFLOP/s on the CUDA cores;
// TF32 tensor cores would not hold the reference's 1e-4).  This kernel
// does L*L*N + 2*L*N*P + L*L*P of them per (head, chunk).
// Design:
//   * The TPU grid (batch, head, chunk) carries the (P, N) state across its
//     sequential chunk axis in VMEM.  Here one block per (P tile, head,
//     batch) walks the chunks in a loop and keeps the state in shared
//     memory; rows p of the state are independent, so P tiles are exact
//     parallelism.
//   * Shared memory (at L = N = 128: B and C of a chunk would take 64 KB
//     each, the (L, L) weights another 64 KB): B and C are staged in
//     d_state slices of NS = 32.  Per slice every thread accumulates its
//     8x8 register tile of C.B^T and its 8x4 tile of C.S_prev (sharing the
//     C fragment), then the slice's state columns are updated.  The weights
//     are written once per chunk into shared memory for the (L,L)x(L,P)
//     product.  ~167 KB at N = 128, one block per SM.
//   * No inf anywhere: exp(acum[l]-acum[s]) is computed only for s <= l
//     (and l < L); the prefix sum is taken in f32 by one thread, in token
//     order, without FMA contraction, as the plain version takes it.
//   * Deterministic: no atomics; every sum runs in a fixed order.
// Not done yet: tensor cores (3xTF32 or split products to keep f32
// accuracy), C.B^T shared by the heads of a group (G = 1 at mamba2: all
// heads of a (batch, chunk) share it), more than one block per SM.

#include <cuda_runtime.h>

namespace {

constexpr int LMAX = 128;          // largest chunk the block holds
constexpr int NMAX = 256;          // largest d_state
constexpr int PT = 64;             // state rows (head_dim) per block
constexpr int NS = 32;             // d_state slice staged at a time
constexpr int TY = 16;
constexpr int TX = 16;
constexpr int NTHREADS = TY * TX;
constexpr int RL = LMAX / TY;      // rows l per thread (C.B^T, y)
constexpr int RS = LMAX / TX;      // cols s per thread (C.B^T)
constexpr int RP = PT / TX;        // cols p per thread (y)
constexpr int SP = PT / TY;        // state rows p per thread
constexpr int SN = NS / TX;        // state cols n per thread (per slice)
constexpr int LDSL = NS + 1;       // padded row of a B / C slice
constexpr int LDW = LMAX + 1;      // padded row of the weights

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* fin;
  int S, H, P, G, N, L, nc;
  int NP;                          // N rounded up to a multiple of NS
};

size_t smem_floats(int NP) {
  return size_t(LMAX) * PT                 // sX
         + size_t(LMAX) * LDW              // sW
         + 2 * size_t(LMAX) * LDSL         // sC, sB
         + size_t(PT) * (NP + 1)           // sS
         + 3 * size_t(LMAX);               // sDt, sAc, sF
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_scan_kernel(const Params p) {
  extern __shared__ float smem[];
  const int LDS = p.NP + 1;                // padded row of the state
  float* sX = smem;                        // [LMAX][PT]
  float* sW = sX + LMAX * PT;              // [LMAX][LDW]
  float* sC = sW + LMAX * LDW;             // [LMAX][LDSL]
  float* sB = sC + LMAX * LDSL;            // [LMAX][LDSL]
  float* sS = sB + LMAX * LDSL;            // [PT][LDS]
  float* sDt = sS + PT * LDS;              // [LMAX]
  float* sAc = sDt + LMAX;                 // [LMAX]
  float* sF = sAc + LMAX;                  // [LMAX]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int L = p.L;
  const float A = p.A[h];

  for (int i = tid; i < PT * LDS; i += NTHREADS) sS[i] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const int t0 = c * L;
    // dt and the x tile of this chunk; tokens past S read as zero
    for (int i = tid; i < LMAX; i += NTHREADS) {
      const int tok = t0 + i;
      sDt[i] = (i < L && tok < p.S)
                   ? p.dt[(size_t(b) * p.S + tok) * p.H + h] : 0.f;
    }
    for (int i = tid; i < LMAX * PT; i += NTHREADS) {
      const int s = i / PT, pp = i % PT, tok = t0 + s;
      sX[i] = (s < L && tok < p.S && p0 + pp < p.P)
                  ? p.x[((size_t(b) * p.S + tok) * p.H + h) * p.P + p0 + pp]
                  : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                        // inclusive prefix sum of dt*A
      // product and sum rounded separately (no FMA contraction): the
      // plain version's dt*A then sequential cumsum, to the bit.  acum
      // reaches ~-100 within a chunk at mamba2's init, where one ulp of
      // acum is ~1e-5 of exp(acum[l]-acum[s]).
      float acc = 0.f;
      for (int s = 0; s < L; ++s) {
        acc = __fadd_rn(acc, __fmul_rn(sDt[s], A));
        sAc[s] = acc;
      }
      for (int s = L; s < LMAX; ++s) sAc[s] = acc;
    }
    __syncthreads();
    const float atot = sAc[L - 1];
    for (int s = tid; s < LMAX; s += NTHREADS)
      sF[s] = s < L ? expf(atot - sAc[s]) * sDt[s] : 0.f;

    float cb[RL][RS], yo[RL][RP];
#pragma unroll
    for (int i = 0; i < RL; ++i) {
#pragma unroll
      for (int j = 0; j < RS; ++j) cb[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j) yo[i][j] = 0.f;
    }

    for (int n0 = 0; n0 < p.NP; n0 += NS) {
      for (int i = tid; i < LMAX * NS; i += NTHREADS) {
        const int s = i / NS, n = i % NS, tok = t0 + s;
        const bool ok = s < L && tok < p.S && n0 + n < p.N;
        const size_t off = ((size_t(b) * p.S + tok) * p.G + g) * p.N + n0 + n;
        sC[s * LDSL + n] = ok ? p.Cm[off] : 0.f;
        sB[s * LDSL + n] = ok ? p.Bm[off] : 0.f;
      }
      __syncthreads();
      // C.B^T and C.S_prev^T over this slice
#pragma unroll 2
      for (int n = 0; n < NS; ++n) {
        float cv[RL], bv[RS], sv[RP];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = sC[(ty + TY * i) * LDSL + n];
#pragma unroll
        for (int j = 0; j < RS; ++j) bv[j] = sB[(tx + TX * j) * LDSL + n];
#pragma unroll
        for (int j = 0; j < RP; ++j) sv[j] = sS[(tx + TX * j) * LDS + n0 + n];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
#pragma unroll
          for (int j = 0; j < RS; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
#pragma unroll
          for (int j = 0; j < RP; ++j) yo[i][j] = fmaf(cv[i], sv[j], yo[i][j]);
        }
      }
      __syncthreads();
      // state columns of this slice: S = exp(atot) S + x^T (B * f)
      for (int i = tid; i < LMAX * NS; i += NTHREADS)
        sB[(i / NS) * LDSL + i % NS] *= sF[i / NS];
      __syncthreads();
      float st[SP][SN];
#pragma unroll
      for (int i = 0; i < SP; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) st[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        float xv[SP], bv[SN];
#pragma unroll
        for (int i = 0; i < SP; ++i) xv[i] = sX[s * PT + ty + TY * i];
#pragma unroll
        for (int j = 0; j < SN; ++j) bv[j] = sB[s * LDSL + tx + TX * j];
#pragma unroll
        for (int i = 0; i < SP; ++i)
#pragma unroll
          for (int j = 0; j < SN; ++j) st[i][j] = fmaf(xv[i], bv[j], st[i][j]);
      }
      const float eA = expf(atot);
#pragma unroll
      for (int i = 0; i < SP; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) {
          float* dst = &sS[(ty + TY * i) * LDS + n0 + tx + TX * j];
          *dst = *dst * eA + st[i][j];
        }
      __syncthreads();
    }

    // inter-chunk term, then the masked weights: exp only where s <= l < L
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int l = ty + TY * i;
      const float el = l < L ? expf(sAc[l]) : 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j) yo[i][j] *= el;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int s = tx + TX * j;
        float w = 0.f;
        if (l < L && s <= l) w = cb[i][j] * expf(sAc[l] - sAc[s]) * sDt[s];
        sW[l * LDW + s] = w;
      }
    }
    __syncthreads();
    // intra-chunk term: y += W x
    for (int s = 0; s < L; ++s) {
      float wv[RL], xv[RP];
#pragma unroll
      for (int i = 0; i < RL; ++i) wv[i] = sW[(ty + TY * i) * LDW + s];
#pragma unroll
      for (int j = 0; j < RP; ++j) xv[j] = sX[s * PT + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) yo[i][j] = fmaf(wv[i], xv[j], yo[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int l = ty + TY * i, tok = t0 + l;
      if (l >= L || tok >= p.S) continue;
#pragma unroll
      for (int j = 0; j < RP; ++j) {
        const int pp = p0 + tx + TX * j;
        if (pp < p.P)
          p.y[((size_t(b) * p.S + tok) * p.H + h) * p.P + pp] = yo[i][j];
      }
    }
    __syncthreads();                       // before the next chunk restages
  }

  for (int i = tid; i < PT * p.N; i += NTHREADS) {
    const int pp = i / p.N, n = i % p.N;
    if (p0 + pp < p.P)
      p.fin[((size_t(b) * p.H + h) * p.P + p0 + pp) * p.N + n] =
          sS[pp * LDS + n];
  }
}

}  // namespace

// All tensors float32 and contiguous: x, y (B,S,H,P); dt (B,S,H); A (H,);
// Bm, Cm (B,S,G,N); fin (B,H,P,N).  L is the chunk length (min(chunk, S)).
// Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan_fwd(const float* x, const float* dt,
                                  const float* A, const float* Bm,
                                  const float* Cm, float* y, float* fin,
                                  int B, int S, int H, int P, int G, int N,
                                  int L, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 1 ||
      N > NMAX || L < 1 || L > LMAX)
    return int(cudaErrorInvalidValue);
  Params p{x, dt, A, Bm, Cm, y, fin, S, H, P, G, N, L, (S + L - 1) / L,
           (N + NS - 1) / NS * NS};
  const size_t smem = sizeof(float) * smem_floats(p.NP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<<<grid, NTHREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return int(cudaGetLastError());
}
