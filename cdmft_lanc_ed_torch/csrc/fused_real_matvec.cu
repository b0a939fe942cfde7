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
// Design: an SGEMM-class FP32 kernel, IEEE fmaf on the FP32 units (no
// TF32).  One block of 256 threads computes one 128 x 64 output tile of
// one sector (blockIdx.z is the batch index), each thread an 8 x 4
// register tile: 8 rows 16 apart and one float4 of columns.  The
// accumulator starts from diag ⊙ X; then one k loop runs over the 32-deep
// k-tiles of H_dw · X followed by those of X · H_upᵀ, both through the
// same ring of 3 shared-memory stages filled with 16-byte cp.async
// copies, so the next stages load while this one computes and the ring
// does not drain between the two products; one barrier per stage.  The A
// operand (H_dw or X) is staged row-major as it lies in memory (no
// transpose on the way in): a thread reads 4 consecutive k of each of its
// rows with one 16-byte load, and 4 k rows of B, so each 16-byte
// shared-memory load feeds ~11 FMAs, against 2 with the 4x4 tiles of the
// first version.  Rows 16 apart, at a padded stride of 36 floats, fall on
// distinct banks.  The tile is written once, so neither [D, U] product
// intermediate reaches device memory.
//
// Filling the card at B = 1: 1024² gives 128 tiles on 132 SMs, one block
// of 8 warps per SM, too few to hide the shared-memory latency.  Where the
// tiles alone would give fewer than two blocks per SM, each tile goes to a
// cluster pair (a Hopper thread-block cluster of 2): one block runs
// H_dw · X from diag ⊙ X and the other X · H_upᵀ from zero, each through
// its own ring; the second leaves its accumulator in its shared memory
// and the first adds it through distributed shared memory and writes the
// tile, so it still reaches device memory once.  Twice the blocks, half
// the k loop each.  Where the batch fills the card, the unsplit form is
// faster.  Ragged edges are zero-filled (cp.async with a source size of
// 0) and stores are guarded, so any D, U >= 1 works; where D or U is not
// a multiple of 4 or a pointer is not 16-byte aligned (the tiny
// unbucketed sectors of dims 1, 12, 66), the same kernel copies one float
// per cp.async.
//
// Operands may be shared across the batch: a batch stride of 0 for diag,
// H_dw or H_upᵀ applies one sector operator to B vectors (the GF
// tridiagonalisation's injection batch).  X and out are [B, D, U]
// contiguous.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <atomic>

namespace {

// 32-deep stages beat 16-deep on an H100 at B = 1, 4 and 9 on the 1024
// bucket; three stages keep two k-tiles in flight while one is computed.
constexpr int BK = 32;               // contraction depth per stage
constexpr int STAGES = 3;            // shared-memory ring
constexpr int AS = BK + 4;           // padded row stride of the A stage
// Below two blocks per SM (B = 1, 2 at 1024²) one block per SM cannot hide
// the shared-memory latency, so the two products go to a cluster pair.
constexpr int SPLIT_BELOW = 2;

// A block of RG x CG threads computes a (TM·RG) x (TN·CG) output tile,
// each thread TM rows (RG apart) by TN columns (float4 groups CG·4
// apart).
template <int TM_, int TN_, int RG_, int CG_>
struct Shape {
  static constexpr int TM = TM_, TN = TN_, RG = RG_, CG = CG_;
  static constexpr int NT = RG * CG;
  static constexpr int BM = TM * RG, BN = TN * CG;
  static_assert(RG % 4 == 0 && CG % 8 == 0 && TN % 4 == 0, "warp layout");
};
// 128x64 tiles, 8x4 per thread, 256 threads.  On an H100 it beat 128x128
// (8x8 per thread, or 8x4 over 512 threads), 128x64 over 512 threads
// (4x4) and 64x64 (4x4) at B = 1, 4 and 9 on the 1024 bucket.
using Tiling = Shape<8, 4, 16, 16>;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16 or 4) from src to shared dst; zero-filled when !valid (src must
// still be a mapped address)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// S: the tile shape; VEC: floats per cp.async (4, or 1 where rows are not
// 16-byte aligned).
template <class S, int VEC>
struct Tile {
  static constexpr int A_FLOATS = S::BM * AS;
  static constexpr int B_FLOATS = BK * S::BN;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;

  // Stage the k-tile k0 of A [M, K] rows row0.. and of B [K, N] cols
  // col0.. into As [BM][AS] and Bs [BK][BN].
  static __device__ __forceinline__ void load(
      const float* __restrict__ A, const float* __restrict__ B, int M,
      int N, int K, int row0, int col0, int k0, float* As, float* Bs) {
    constexpr int CA = S::BM * BK / VEC, CB = BK * S::BN / VEC;
#pragma unroll
    for (int q = 0; q < (CA + S::NT - 1) / S::NT; ++q) {
      const int c = threadIdx.x + q * S::NT;
      if (CA % S::NT && c >= CA) break;
      const int r = c / (BK / VEC), k = (c % (BK / VEC)) * VEC;
      const bool ok = row0 + r < M && k0 + k < K;
      cp_async<4 * VEC>(As + r * AS + k,
                        ok ? A + (size_t)(row0 + r) * K + k0 + k : A, ok);
    }
#pragma unroll
    for (int q = 0; q < (CB + S::NT - 1) / S::NT; ++q) {
      const int c = threadIdx.x + q * S::NT;
      if (CB % S::NT && c >= CB) break;
      const int k = c / (S::BN / VEC), j = (c % (S::BN / VEC)) * VEC;
      const bool ok = k0 + k < K && col0 + j < N;
      cp_async<4 * VEC>(Bs + k * S::BN + j,
                        ok ? B + (size_t)(k0 + k) * N + col0 + j : B, ok);
    }
  }
};

// SPLIT = 1: one block runs both products through one ring into one
// accumulator.  SPLIT = 2: the two blocks of a cluster pair (blockIdx.x
// even, odd) run H_dw · X (from diag ⊙ X) and X · H_upᵀ (from 0) for the
// same tile, each through its own ring; the odd block leaves its
// accumulator in its shared memory and the even one adds it through
// distributed shared memory and writes the tile.
template <class S, int VEC, int SPLIT>
__global__ void __launch_bounds__(S::NT) fused_real_matvec_kernel(
    const float* __restrict__ diag, const float* __restrict__ hdw,
    const float* __restrict__ hupT, const float* __restrict__ x,
    float* __restrict__ out, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT) {
  using T = Tile<S, VEC>;
  constexpr int TM = S::TM, TN = S::TN, RG = S::RG;
  constexpr int CSTEP = S::BN / (TN / 4);   // between a thread's float4s
  static_assert(SPLIT == 1 || TM * TN * S::NT <= STAGES * T::STAGE,
                "the ring holds the partner's accumulator");
  extern __shared__ __align__(16) float smem[];
  const long long b = blockIdx.z;
  const long long du = (long long)D * U;
  diag += b * sb_diag;
  hdw += b * sb_hdw;
  hupT += b * sb_hupT;
  x += b * du;
  out += b * du;

  const int part = SPLIT == 2 ? (int)(blockIdx.x & 1) : 0;
  const int row0 = blockIdx.y * S::BM;
  const int col0 = (blockIdx.x / SPLIT) * S::BN;
  // a warp covers 4 row groups x 8 column groups: its A loads hit 4
  // consecutive rows (distinct banks), its B loads 8 consecutive float4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp / (S::CG / 8)) * 4 + (lane >> 3);
  const int tx = (warp % (S::CG / 8)) * 8 + (lane & 7);

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

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + RG * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * 4 + (j / 4) * CSTEP + (j % 4);
      acc[i][j] = (part == 0 && r < D && c < U)
          ? diag[(size_t)r * U + c] * x[(size_t)r * U + c] : 0.0f;
    }
  }

  for (int s = s_lo; s < s_hi; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage s landed; stage s - 1 no longer read
    if (s + STAGES - 1 < s_hi) load(s + STAGES - 1);
    cp_async_commit();
    const float* As = smem + ((s - s_lo) % STAGES) * T::STAGE;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + RG * i) * AS
                                                + kk);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float bv[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(
              Bs + (kk + k) * S::BN + tx * 4 + h * CSTEP);
          bv[4 * h] = q.x;
          bv[4 * h + 1] = q.y;
          bv[4 * h + 2] = q.z;
          bv[4 * h + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = k == 0 ? a[i].x : k == 1 ? a[i].y
                         : k == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if constexpr (SPLIT == 2) {
    namespace cg = cooperative_groups;
    cg::cluster_group pair = cg::this_cluster();
    __syncthreads();   // the ring is free
    if (part == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          smem[(i * TN + j) * S::NT + threadIdx.x] = acc[i][j];
    }
    pair.sync();
    if (part == 0) {
      const float* other = pair.map_shared_rank(smem, 1);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += other[(i * TN + j) * S::NT + threadIdx.x];
    }
    pair.sync();       // the odd block's shared memory is read
    if (part == 1) return;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + RG * i;
    if (r >= D) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = col0 + tx * 4 + h * CSTEP;
      float* o = out + (size_t)r * U + c;
      if (VEC == 4 && c + 3 < U) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < U) o[e] = acc[i][4 * h + e];
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <class S, int VEC, int SPLIT>
int launch(const float* diag, const float* hdw, const float* hupT,
           const float* x, float* out, int batch, int D, int U,
           long long sb_diag, long long sb_hdw, long long sb_hupT,
           cudaStream_t stream, int dev) {
  using T = Tile<S, VEC>;
  auto kernel = fused_real_matvec_kernel<S, VEC, SPLIT>;
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
  cfg.gridDim = dim3(SPLIT * ((U + S::BN - 1) / S::BN),
                     (D + S::BM - 1) / S::BM, batch);
  cfg.blockDim = dim3(S::NT);
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
// 16-byte copies where every row and batch member is 16-byte aligned,
// else one float per copy; the cluster pair where the tiles alone would
// give fewer than SPLIT_BELOW blocks per SM (B = 1 and 2 at 1024²).
extern "C" int fused_real_matvec_f32(
    const float* diag, const float* hdw, const float* hupT, const float* x,
    float* out, int batch, int D, int U, long long sb_diag,
    long long sb_hdw, long long sb_hupT, void* stream) {
  if (batch <= 0 || D <= 0 || U <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool vec = D % 4 == 0 && U % 4 == 0 &&
                   ((uintptr_t)diag | (uintptr_t)hdw | (uintptr_t)hupT |
                    (uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (!vec)
    return launch<Tiling, 1, 1>(diag, hdw, hupT, x, out, batch, D, U,
                                sb_diag, sb_hdw, sb_hupT, s, dev);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)batch *
                          ((D + Tiling::BM - 1) / Tiling::BM) *
                          ((U + Tiling::BN - 1) / Tiling::BN);
  if (tiles < (long long)SPLIT_BELOW * sms)
    return launch<Tiling, 4, 2>(diag, hdw, hupT, x, out, batch, D, U,
                                sb_diag, sb_hdw, sb_hupT, s, dev);
  return launch<Tiling, 4, 1>(diag, hdw, hupT, x, out, batch, D, U, sb_diag,
                              sb_hdw, sb_hupT, s, dev);
}
