// Fused complex tensor-product sector H·v for Hopper (sm_90a), complex64.
//
//   out[b] = diag[b] ⊙ X[b] + H_dw[b] · X[b] + X[b] · H_upᵀ[b]
//
// X is the complex sector vector viewed as a [D, U] matrix (D = dim of the
// spin-down factor, U = dim of the spin-up factor); H_dw is [D, D] and
// H_upᵀ is [U, U] (the transpose of H_up, not its conjugate transpose);
// diag is real.  X, H_dw, H_upᵀ and out are interleaved complex64 (float2),
// diag is float.
//
// Replaces the TPU kernel of the JAX package, ops/pallas_fused.py::
// fused_pair_matvec (the pl.pallas_call at :179), the f32 Krylov-stage H·v
// of ed_precision="mixed" for complex sector Hamiltonians, batched over
// same-bucket sectors.  It computes what that kernel computes, with its
// 3-multiplication (Karatsuba) complex products: for A·B
//
//   P1 = Ar·Br,  P2 = Ai·Bi,  P3 = (Ar+Ai)·(Br+Bi)
//   Re = P1 − P2,  Im = P3 − P1 − P2
//
// and since both products of H·v end in the same combination, one set of
// three accumulators serves H_dw · X and X · H_upᵀ together.
//
// What bounds it on an H100 SXM: at the flagship bucket D = U = 1024 one
// H·v is 6·D·U·(D+U) + 4·D·U ≈ 12.9 GFLOP (the TPU kernel's own count)
// against 8·(2·D·U + D² + U²) + 4·D·U ≈ 37.7 MB of compulsory traffic:
// ~193 µs at the 67 TFLOP/s FP32 (non-tensor) peak against ~11 µs at
// 3.35 TB/s, so it is compute-bound on FP32 FFMA.  The Karatsuba form does
// 3 FMAs per complex multiply-add instead of 4.
//
// Design (that of fused_real_matvec.cu): one block computes one BM x BN
// output tile of one sector (blockIdx.z is the batch index).  A loop over
// the k-tiles of H_dw · X and then a loop over the k-tiles of X · H_upᵀ
// stage both operands through shared memory; when a tile is staged the
// block also stores re+im of it, so the inner loop is three real FMA
// products.  Each thread holds three TM x TN register tiles (P1, P2, P3),
// updated with IEEE fmaf (no TF32).  The epilogue adds diag ⊙ X and writes
// each output once, so no [D, U] product intermediate reaches device
// memory.  Ragged edges are masked (zero-filled loads, guarded stores), so
// any D, U >= 1 works.
//
// Operands may be shared across the batch: a batch stride of 0 for diag,
// H_dw or H_upᵀ applies one sector operator to B vectors (the GF
// tridiagonalisation's injection batch).  X and out are [B, D, U]
// contiguous.  Strides count elements of each operand's own type.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output cols per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output cols per thread
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int PAD = 4;   // A-tile row padding: spreads the transposed stores

// One staged k-tile: the re, im and re+im planes of an A tile (stored
// transposed, [k][row]) and of a B tile ([k][col]).
struct Stage {
  float a[3][BK][BM + PAD];
  float b[3][BK][BN];
};

// acc[p] += Karatsuba product p of A[row0:row0+BM, :] · B[:, col0:col0+BN]
// for row-major complex A [M, K] and B [K, N], BK columns of A at a time.
__device__ __forceinline__ void accumulate(
    const float2* __restrict__ A, const float2* __restrict__ B,
    int M, int N, int K, int row0, int col0,
    float (&acc)[3][TM][TN], Stage& s) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      const float2 v = (gr < M && gc < K) ? A[(size_t)gr * K + gc]
                                          : make_float2(0.0f, 0.0f);
      s.a[0][c][r] = v.x;
      s.a[1][c][r] = v.y;
      s.a[2][c][r] = v.x + v.y;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      const float2 v = (gr < K && gc < N) ? B[(size_t)gr * N + gc]
                                          : make_float2(0.0f, 0.0f);
      s.b[0][r][c] = v.x;
      s.b[1][r][c] = v.y;
      s.b[2][r][c] = v.x + v.y;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float4 a =
            *reinterpret_cast<const float4*>(&s.a[p][kk][ty * TM]);
        const float4 b =
            *reinterpret_cast<const float4*>(&s.b[p][kk][tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[p][i][j] = fmaf(av[i], bv[j], acc[p][i][j]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) fused_pair_matvec_kernel(
    const float* __restrict__ diag, const float2* __restrict__ hdw,
    const float2* __restrict__ hupT, const float2* __restrict__ x,
    float2* __restrict__ out, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT) {
  __shared__ __align__(16) Stage s;
  const long long b = blockIdx.z;
  const long long du = (long long)D * U;
  diag += b * sb_diag;
  hdw += b * sb_hdw;
  hupT += b * sb_hupT;
  x += b * du;
  out += b * du;

  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = threadIdx.x / (BN / TN);
  const int tx = threadIdx.x % (BN / TN);

  float acc[3][TM][TN];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.0f;
  accumulate(hdw, x, D, U, D, row0, col0, acc, s);    // H_dw · X
  accumulate(x, hupT, D, U, U, row0, col0, acc, s);   // X · H_upᵀ
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (r < D && c < U) {
        const size_t o = (size_t)r * U + c;
        const float d = diag[o];
        const float2 v = x[o];
        const float p1 = acc[0][i][j], p2 = acc[1][i][j];
        out[o] = make_float2(fmaf(d, v.x, p1 - p2),
                             fmaf(d, v.y, acc[2][i][j] - p1 - p2));
      }
    }
  }
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns
// the cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int fused_pair_matvec_c64(
    const float* diag, const void* hdw, const void* hupT, const void* x,
    void* out, int batch, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT, void* stream) {
  if (batch <= 0 || D <= 0 || U <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((U + BN - 1) / BN, (D + BM - 1) / BM, batch);
  fused_pair_matvec_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      diag, static_cast<const float2*>(hdw),
      static_cast<const float2*>(hupT), static_cast<const float2*>(x),
      static_cast<float2*>(out), D, U, sb_diag, sb_hdw, sb_hupT);
  return (int)cudaGetLastError();
}
