// Fused real tensor-product sector H·v for Hopper (sm_90a), f32.
//
//   out[b] = diag[b] ⊙ X[b] + H_dw[b] · X[b] + X[b] · H_upᵀ[b]
//
// X is the sector vector viewed as a [D, U] matrix (D = dim of the spin-down
// factor, U = dim of the spin-up factor); H_dw is [D, D], H_upᵀ is [U, U].
//
// Replaces the TPU kernel of the JAX package, ops/pallas_fused.py::
// fused_real_matvec (the pl.pallas_call at :96), the f32 Krylov-stage H·v
// of ed_precision="mixed", batched over same-bucket sectors.
//
// What bounds it on an H100 SXM: at the flagship bucket D = U = 1024 one
// H·v is 2·D·U·(D+U) + 2·D·U ≈ 4.30 GFLOP against 4·(3·D·U + D² + U²) ≈
// 21.0 MB of compulsory traffic: ~64 µs at the 67 TFLOP/s FP32 (non-tensor)
// peak against ~6 µs at 3.35 TB/s, so it is compute-bound on FP32 FFMA.
//
// Design: one block computes one BM x BN output tile of one sector
// (blockIdx.z is the batch index).  The accumulator starts from diag ⊙ X,
// then a loop over the k-tiles of H_dw · X and a loop over the k-tiles of
// X · H_upᵀ stage both operands through shared memory, each thread holding
// a TM x TN register tile updated with IEEE fmaf (no TF32).  The tile is
// written once, so neither [D, U] product intermediate reaches device
// memory: what the Pallas kernel kept in VMEM across its k grid axis, a
// loop inside the block keeps in registers here.  Ragged edges are masked
// (zero-filled loads, guarded stores), so any D, U >= 1 works; the tiny
// unbucketed sectors (dims 1, 12, 66) reach it too.
//
// Operands may be shared across the batch: a batch stride of 0 for diag,
// H_dw or H_upᵀ applies one sector operator to B vectors (the GF
// tridiagonalisation's injection batch).  X and out are [B, D, U]
// contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output cols per block
constexpr int BK = 16;   // contraction depth per shared-memory stage
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output cols per thread
constexpr int NT = (BM / TM) * (BN / TN);   // 256 threads
constexpr int PAD = 4;   // As row padding: spreads the transposed stores

// acc += A[row0:row0+BM, :] · B[:, col0:col0+BN] for row-major A [M, K]
// and B [K, N], staged through shared memory BK columns of A at a time.
__device__ __forceinline__ void accumulate(
    const float* __restrict__ A, const float* __restrict__ B,
    int M, int N, int K, int row0, int col0,
    float (&acc)[TM][TN], float (*As)[BM + PAD], float (*Bs)[BN]) {
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / NT; ++q) {
      const int e = tid + q * NT;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) fused_real_matvec_kernel(
    const float* __restrict__ diag, const float* __restrict__ hdw,
    const float* __restrict__ hupT, const float* __restrict__ x,
    float* __restrict__ out, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN];
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

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      acc[i][j] = (r < D && c < U)
          ? diag[(size_t)r * U + c] * x[(size_t)r * U + c] : 0.0f;
    }
  }
  accumulate(hdw, x, D, U, D, row0, col0, acc, As, Bs);    // H_dw · X
  accumulate(x, hupT, D, U, U, row0, col0, acc, As, Bs);   // X · H_upᵀ
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (r < D && c < U) out[(size_t)r * U + c] = acc[i][j];
    }
  }
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns
// the cudaError_t of the launch (0 on success); it never synchronises.
extern "C" int fused_real_matvec_f32(
    const float* diag, const float* hdw, const float* hupT, const float* x,
    float* out, int batch, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT, void* stream) {
  if (batch <= 0 || D <= 0 || U <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((U + BN - 1) / BN, (D + BM - 1) / BM, batch);
  fused_real_matvec_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      diag, hdw, hupT, x, out, D, U, sb_diag, sb_hdw, sb_hupT);
  return (int)cudaGetLastError();
}
