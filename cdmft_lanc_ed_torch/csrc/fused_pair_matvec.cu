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
// 3.35 TB/s, so it is compute-bound on the FP32 pipe.  The Karatsuba form
// does 3 FMAs per complex multiply-add instead of 4, plus the Ar+Ai and
// Br+Bi sums, which are FADDs on the same pipe.
//
// Design (that of fused_real_matvec.cu, changed where complex arithmetic
// changes the balance): an SGEMM-class kernel in IEEE fmaf (no TF32, no
// tensor cores).  One block of 128 threads computes one 64 x 64 complex
// output tile of one sector (blockIdx.z is the batch index), each thread
// an 8 x 4 complex tile in three accumulators (P1, P2, P3): 8 rows 8 apart,
// and two pairs of adjacent columns 32 apart.  One k loop runs over the
// 16-deep k-tiles of H_dw · X followed by those of X · H_upᵀ, both through
// the same ring of 4 shared-memory stages filled with 16-byte cp.async
// copies, so the next stages load while this one computes and the ring
// does not drain between the two products; one barrier per stage.  The
// operands are staged interleaved, as they lie in memory (A row-major,
// padded to a row stride of 36 floats so the rows a warp reads fall on
// distinct banks): a 16-byte shared-memory load brings two complex values,
// the thread splits them into re and im and forms Ar+Ai and Br+Bi in
// registers, so no third plane is staged and nothing is transformed on the
// way in.  Per complex k a thread issues 6 such loads and 12 FADDs for 96
// FMAs (16 FMAs per load, against 8 in the first version's 4x4 tiles of
// three staged planes).  The 96 accumulators take the register budget of
// two blocks per SM (8 warps); the epilogue forms Re and Im, adds diag ⊙ X
// and writes each output once, so neither [D, U] product intermediate
// reaches device memory.
//
// Filling the card at small grids: where the tiles alone would give fewer
// than one block per SM (B = 1 at 512²: 64 tiles on 132 SMs), each tile
// goes to a cluster pair (a Hopper thread-block cluster of 2): one block
// runs H_dw · X and the other X · H_upᵀ, each through its own ring; the
// second folds its three accumulators into (Re, Im), leaves them in its
// shared memory, and the first adds them through distributed shared memory
// and writes the tile, so 2 floats per output cross the pair and the tile
// still reaches device memory once.  Ragged edges are zero-filled (cp.async
// with a source size of 0) and stores are guarded, so any D, U >= 1 works;
// where D or U is odd or a pointer is not 16-byte aligned (the tiny
// unbucketed sectors, an x at an odd offset in a larger buffer), the same
// kernel copies one complex value (one float2) per cp.async.
//
// Operands may be shared across the batch: a batch stride of 0 for diag,
// H_dw or H_upᵀ applies one sector operator to B vectors (the GF
// tridiagonalisation's injection batch).  X and out are [B, D, U]
// contiguous.  Strides count elements of each operand's own type.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>

namespace {

// 16-deep stages (128 bytes of an A row) beat 8- and 32-deep on an H100 at
// B = 1, 4 and 9 on the 1024 bucket; 4 stages edged out 3.
constexpr int BK = 16;               // complex contraction depth per stage
constexpr int STAGES = 4;            // shared-memory ring
constexpr int AS = 2 * BK + 4;       // padded A-row stride, in floats
// 64x64 tiles, 8x4 per thread, 128 threads, two blocks per SM (~240
// registers).  On an H100 it beat 128x64 over 256 threads (8x4, one block
// per SM), 128x32 over 128 threads, 64x32 over 64 threads, 64x64 over 256
// threads (4x4), and 3-4 blocks per SM (6x4 or 4x4 per thread, or 8x4
// spilling) at B = 1, 4 and 9 on the 1024 bucket.  A block of RG x CG
// threads computes a BM x BN complex output tile, each thread TM rows (RG
// apart) by TN columns (pairs of adjacent columns, 2·CG apart).
constexpr int TM = 8, TN = 4, RG = 8, CG = 16;
constexpr int NT = RG * CG;          // threads per block
constexpr int BM = TM * RG, BN = TN * CG;
static_assert(RG % 4 == 0 && CG % 8 == 0 && TN % 2 == 0, "warp layout");
constexpr int MIN_BLOCKS = 2;        // blocks per SM the registers allow

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 8) from src to shared dst; zero-filled when !valid (src must
// still be a mapped address)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float2* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC: complex values per cp.async (2, or 1 where rows are not 16-byte
// aligned).  A stage holds the interleaved A tile [BM][AS floats] and B
// tile [BK][2·BN floats].
template <int VEC>
struct Tile {
  static constexpr int A_FLOATS = BM * AS;
  static constexpr int B_FLOATS = BK * 2 * BN;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;

  // Stage the k-tile k0 of A [M, K] rows row0.. and of B [K, N] cols
  // col0.. into As and Bs.
  static __device__ __forceinline__ void load(
      const float2* __restrict__ A, const float2* __restrict__ B, int M,
      int N, int K, int row0, int col0, int k0, float* As, float* Bs) {
    constexpr int CA = BM * BK / VEC, CB = BK * BN / VEC;
    static_assert(CA % NT == 0 && CB % NT == 0, "whole copies per thread");
#pragma unroll
    for (int q = 0; q < CA / NT; ++q) {
      const int c = threadIdx.x + q * NT;
      const int r = c / (BK / VEC), k = (c % (BK / VEC)) * VEC;
      const bool ok = row0 + r < M && k0 + k < K;
      cp_async<8 * VEC>(As + r * AS + 2 * k,
                        ok ? A + (size_t)(row0 + r) * K + k0 + k : A, ok);
    }
#pragma unroll
    for (int q = 0; q < CB / NT; ++q) {
      const int c = threadIdx.x + q * NT;
      const int k = c / (BN / VEC), j = (c % (BN / VEC)) * VEC;
      const bool ok = k0 + k < K && col0 + j < N;
      cp_async<8 * VEC>(Bs + k * 2 * BN + 2 * j,
                        ok ? B + (size_t)(k0 + k) * N + col0 + j : B, ok);
    }
  }
};

// SPLIT = 1: one block runs both products through one ring into one set of
// accumulators.  SPLIT = 2: the two blocks of a cluster pair (blockIdx.x
// even, odd) run H_dw · X and X · H_upᵀ for the same tile, each through its
// own ring; the odd block leaves its (Re, Im) in its shared memory and the
// even one adds them through distributed shared memory and writes the tile.
template <int VEC, int SPLIT>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) fused_pair_matvec_kernel(
    const float* __restrict__ diag, const float2* __restrict__ hdw,
    const float2* __restrict__ hupT, const float2* __restrict__ x,
    float2* __restrict__ out, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT) {
  using T = Tile<VEC>;
  constexpr int CSTEP = 2 * CG;   // columns between a thread's pairs
  static_assert(SPLIT == 1 || 2 * TM * TN * NT <= STAGES * T::STAGE,
                "the ring holds the partner's (Re, Im)");
  extern __shared__ __align__(16) float smem[];
  const long long b = blockIdx.z;
  const long long du = (long long)D * U;
  diag += b * sb_diag;
  hdw += b * sb_hdw;
  hupT += b * sb_hupT;
  x += b * du;
  out += b * du;

  const int part = SPLIT == 2 ? (int)(blockIdx.x & 1) : 0;
  const int row0 = blockIdx.y * BM;
  const int col0 = (blockIdx.x / SPLIT) * BN;
  // a warp covers 4 row groups x 8 column groups: its A loads hit 4
  // consecutive rows (distinct banks), its B loads 8 consecutive pairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp / (CG / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (CG / 8)) * 8 + (lane & 7);

  // k-tiles: H_dw · X (K = D), then X · H_upᵀ (K = U); this block's run
  // [s_lo, s_hi) of them
  const int s1 = (D + BK - 1) / BK;
  const int ns = s1 + (U + BK - 1) / BK;
  const int s_lo = part == 1 ? s1 : 0;
  const int s_hi = SPLIT == 2 && part == 0 ? s1 : ns;
  auto load = [&](int s) {
    float* st = smem + ((s - s_lo) % STAGES) * T::STAGE;
    if (s < s1)
      T::load(hdw, x, D, U, D, row0, col0, s * BK, st, st + T::A_FLOATS);
    else
      T::load(x, hupT, D, U, U, row0, col0, (s - s1) * BK, st,
              st + T::A_FLOATS);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s_lo + s < s_hi) load(s_lo + s);
    cp_async_commit();
  }

  float p1[TM][TN], p2[TM][TN], p3[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) p1[i][j] = p2[i][j] = p3[i][j] = 0.0f;

  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s landed; stage s - 1 no longer read
    if (s + STAGES - 1 < s_hi) load(s + STAGES - 1);
    cp_async_commit();
    const float* As = smem + ((s - s_lo) % STAGES) * T::STAGE;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float4 a[TM];   // two complex k of each of the thread's rows
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + RG * i) * AS
                                                + 2 * kk);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float br[TN], bi[TN], bs[TN];
#pragma unroll
        for (int h = 0; h < TN / 2; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(
              Bs + (kk + k) * 2 * BN + 2 * (tx * 2 + h * CSTEP));
          br[2 * h] = q.x;
          bi[2 * h] = q.y;
          br[2 * h + 1] = q.z;
          bi[2 * h + 1] = q.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) bs[j] = br[j] + bi[j];
        float ar[TM], ai[TM], as[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          ar[i] = k == 0 ? a[i].x : a[i].z;
          ai[i] = k == 0 ? a[i].y : a[i].w;
          as[i] = ar[i] + ai[i];
        }
        // one product at a time (P1, then P2, then P3): faster on an H100
        // than the three interleaved per (i, j)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) p1[i][j] = fmaf(ar[i], br[j], p1[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) p2[i][j] = fmaf(ai[i], bi[j], p2[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) p3[i][j] = fmaf(as[i], bs[j], p3[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // fold: p1 becomes Re = P1 − P2, p3 becomes Im = P3 − P1 − P2
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float a1 = p1[i][j], a2 = p2[i][j];
      p1[i][j] = a1 - a2;
      p3[i][j] = p3[i][j] - a1 - a2;
    }

  if constexpr (SPLIT == 2) {
    namespace cg = cooperative_groups;
    cg::cluster_group pair = cg::this_cluster();
    __syncthreads();   // the ring is free
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          smem[(2 * (i * TN + j)) * NT + threadIdx.x] = p1[i][j];
          smem[(2 * (i * TN + j) + 1) * NT + threadIdx.x] = p3[i][j];
        }
    }
    pair.sync();
    if (part == 0) {
      const float* other = pair.map_shared_rank(smem, 1);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          p1[i][j] += other[(2 * (i * TN + j)) * NT + threadIdx.x];
          p3[i][j] += other[(2 * (i * TN + j) + 1) * NT + threadIdx.x];
        }
    }
    pair.sync();       // the odd block's shared memory is read
    if (part == 1) return;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + RG * i;
    if (r >= D) continue;
#pragma unroll
    for (int h = 0; h < TN / 2; ++h) {
      const int c = col0 + tx * 2 + h * CSTEP;
      const size_t o = (size_t)r * U + c;
      if (VEC == 2 && c < U) {   // U even: the pair is inside the row
        const float2 d = *reinterpret_cast<const float2*>(diag + o);
        const float4 v = *reinterpret_cast<const float4*>(x + o);
        *reinterpret_cast<float4*>(out + o) = make_float4(
            fmaf(d.x, v.x, p1[i][2 * h]), fmaf(d.x, v.y, p3[i][2 * h]),
            fmaf(d.y, v.z, p1[i][2 * h + 1]),
            fmaf(d.y, v.w, p3[i][2 * h + 1]));
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < U) {
            const float d = diag[o + e];
            const float2 v = x[o + e];
            out[o + e] = make_float2(fmaf(d, v.x, p1[i][2 * h + e]),
                                     fmaf(d, v.y, p3[i][2 * h + e]));
          }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int VEC, int SPLIT>
int launch(const float* diag, const float2* hdw, const float2* hupT,
           const float2* x, float2* out, int batch, int D, int U,
           long long sb_diag, long long sb_hdw, long long sb_hupT,
           cudaStream_t stream, int dev) {
  using T = Tile<VEC>;
  auto kernel = fused_pair_matvec_kernel<VEC, SPLIT>;
  // a ring above 48 KB needs the opt-in, set once per device
  static std::atomic<bool> opted_in[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t e;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SPLIT * ((U + BN - 1) / BN),
                     (D + BM - 1) / BM, batch);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, diag, hdw, hupT, x, out, D, U,
                         sb_diag, sb_hdw, sb_hupT);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  Launches on ``stream`` and returns
// the cudaError_t of the launch (0 on success); it never synchronises.
// 16-byte copies where D and U are even and every pointer is 16-byte
// aligned, else one complex value per copy.  Complex pointers must be 8-byte aligned (every complex64
// tensor's are).
extern "C" int fused_pair_matvec_c64(
    const float* diag, const void* hdw, const void* hupT, const void* x,
    void* out, int batch, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT, void* stream) {
  if (batch <= 0 || D <= 0 || U <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const uintptr_t cplx =
      (uintptr_t)hdw | (uintptr_t)hupT | (uintptr_t)x | (uintptr_t)out;
  if (cplx % 8 || (uintptr_t)diag % 4) return (int)cudaErrorMisalignedAddress;
  const auto* h = static_cast<const float2*>(hdw);
  const auto* t = static_cast<const float2*>(hupT);
  const auto* v = static_cast<const float2*>(x);
  auto* o = static_cast<float2*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool vec = D % 2 == 0 && U % 2 == 0 &&
                   (cplx | (uintptr_t)diag) % 16 == 0;
  if (!vec)
    return launch<1, 1>(diag, h, t, v, o, batch, D, U, sb_diag, sb_hdw,
                        sb_hupT, s, dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)batch * ((D + BM - 1) / BM) * ((U + BN - 1) / BN);
  // Below one tile per SM (B = 1 on 512²: 64 tiles) the two products go
  // to a cluster pair; from there up (B = 1 on 1024²: 256 tiles) the plain
  // grid was faster on an H100.
  if (tiles < sms)
    return launch<2, 2>(diag, h, t, v, o, batch, D, U, sb_diag, sb_hdw,
                        sb_hupT, s, dev);
  return launch<2, 1>(diag, h, t, v, o, batch, D, U, sb_diag, sb_hdw,
                      sb_hupT, s, dev);
}
