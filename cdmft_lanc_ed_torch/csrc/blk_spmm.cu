// Block-sparse SpMM of one spin factor for Hopper (sm_90a):
//
//   y[rb·128 + r, c] = Σ_{t : rb[t] = rb} Σ_k tiles[t, r, k] · x[cb[t]·128 + k, c]
//
// The spin factor H_up or H_dw of a large sector (Ns >= 16, factors beyond
// the dense-factor limit) is stored as 128x128 dense tiles with row- and
// column-block indices.  Applied to the sector vector X [DimDw, DimUp] this
// is H_dw·X in the natural layout and H_up·Xᵀ in the transposed one.
//
// Replaces the TPU kernel of the JAX package, ops/large.py::
// _pallas_blk_spmm_call (the pl.pallas_call at :403), the H·v of every
// large-sector solve and GF chain.  Instantiations: f32 (the Krylov stage,
// IEEE fmaf, never TF32), bf16 tiles and x with f32 accumulation (the
// coarse stage), f64 (refine, f64 solves and GF chains), complex64 and
// complex128 (complex sector Hamiltonians; interleaved re/im).
//
// What bounds it on an H100: the tiles are ~0.5% full (Ns=16: ~1.2e5
// nonzeros in ~1,500 tiles per factor), so the product needs 2·nnz·n
// operations (3e9 at n = 12,928) against tiles + x + y bytes (1.4 GB in
// f32): about 0.43 ms at 3.35 TB/s against 0.05 ms of FP32 work, so it is
// bound by bytes.  A dense tile loop would do 2·T·128²·n = 6.3e11 FLOPs,
// 200x the work the product needs.
//
// Design: CUDA blocks run in no order, so nothing carries over between
// them (the Pallas kernel zeroed a resident output band on its first-of-
// band tile).  One block owns one output row block (128 rows) x a slice of
// 32·CPL columns, walks its own tile run (a per-row-block tile list derived
// from the row-block indices by the wrapper) and writes each output once;
// a row block without tiles writes zeros.  A warp takes one output row at
// a time and 32·CPL neighbouring columns (CPL per lane, so x rows are read
// coalesced, 128 B per load in f32).  For each tile the warp reads the
// tile's row (coalesced, one entry per lane per quarter), finds its
// nonzeros with a ballot and broadcasts each one: tile[r, k] is the same
// for the whole warp, so skipping a zero never diverges, and skipping zero
// products is exact for finite x.  The sum over k runs in ascending global
// column order (tiles of a row block ascend in column block).  The ragged
// edge of n is masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int B = 128;           // tile edge
constexpr int WARPS = 8;         // warps per block, each on its own rows
constexpr int NT = 32 * WARPS;   // 256 threads

// accumulator-type view of a tile or x entry
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(double v) { return v != 0.0; }
__device__ __forceinline__ bool nonzero(float2 v) {
  return v.x != 0.0f || v.y != 0.0f;
}
__device__ __forceinline__ bool nonzero(double2 v) {
  return v.x != 0.0 || v.y != 0.0;
}

__device__ __forceinline__ float shfl(float v, int l) {
  return __shfl_sync(0xffffffffu, v, l);
}
__device__ __forceinline__ double shfl(double v, int l) {
  return __shfl_sync(0xffffffffu, v, l);
}
__device__ __forceinline__ float2 shfl(float2 v, int l) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, l),
                     __shfl_sync(0xffffffffu, v.y, l));
}
__device__ __forceinline__ double2 shfl(double2 v, int l) {
  return make_double2(__shfl_sync(0xffffffffu, v.x, l),
                      __shfl_sync(0xffffffffu, v.y, l));
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ double zero<double>() { return 0.0; }
template <> __device__ __forceinline__ float2 zero<float2>() {
  return make_float2(0.0f, 0.0f);
}
template <> __device__ __forceinline__ double2 zero<double2>() {
  return make_double2(0.0, 0.0);
}

// acc += a · v (IEEE fused multiply-adds; complex as four real ones)
__device__ __forceinline__ void fma_acc(float& acc, float a, float v) {
  acc = fmaf(a, v, acc);
}
__device__ __forceinline__ void fma_acc(double& acc, double a, double v) {
  acc = fma(a, v, acc);
}
__device__ __forceinline__ void fma_acc(float2& acc, float2 a, float2 v) {
  acc.x = fmaf(a.x, v.x, acc.x);
  acc.x = fmaf(-a.y, v.y, acc.x);
  acc.y = fmaf(a.x, v.y, acc.y);
  acc.y = fmaf(a.y, v.x, acc.y);
}
__device__ __forceinline__ void fma_acc(double2& acc, double2 a, double2 v) {
  acc.x = fma(a.x, v.x, acc.x);
  acc.x = fma(-a.y, v.y, acc.x);
  acc.y = fma(a.x, v.y, acc.y);
  acc.y = fma(a.y, v.x, acc.y);
}

// Tt: tile entry, Tx: x entry, Ta: accumulator and output; CPL columns
// per lane.
template <typename Tt, typename Tx, typename Ta, int CPL>
__global__ void __launch_bounds__(NT) blk_spmm_kernel(
    const Tt* __restrict__ tiles, const int* __restrict__ order,
    const int* __restrict__ cb, const int* __restrict__ off,
    const Tx* __restrict__ x, Ta* __restrict__ y, long long n) {
  const int rb = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c0 = (long long)blockIdx.x * (32 * CPL) + lane;
  const int t0 = off[rb], t1 = off[rb + 1];
  for (int r = warp; r < B; r += WARPS) {
    Ta acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = zero<Ta>();
    for (int it = t0; it < t1; ++it) {
      const int t = order[it];
      const Tt* row = tiles + ((size_t)t * B + r) * B;
      const Tx* xb = x + (size_t)cb[t] * B * (size_t)n;
#pragma unroll
      for (int q = 0; q < B / 32; ++q) {
        const Ta v = widen(row[q * 32 + lane]);
        unsigned m = __ballot_sync(0xffffffffu, nonzero(v));
        while (m) {
          const int l = __ffs(m) - 1;
          m &= m - 1;
          const Ta a = shfl(v, l);
          const Tx* xr = xb + (size_t)(q * 32 + l) * (size_t)n;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const long long c = c0 + 32 * j;
            if (c < n) fma_acc(acc[j], a, widen(xr[c]));
          }
        }
      }
    }
    Ta* yr = y + ((size_t)rb * B + r) * (size_t)n;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const long long c = c0 + 32 * j;
      if (c < n) yr[c] = acc[j];
    }
  }
}

template <typename Tt, typename Tx, typename Ta, int CPL>
int launch(const void* tiles, const int* order, const int* cb,
           const int* off, const void* x, void* y, int nb_out, long long n,
           void* stream) {
  if (nb_out <= 0 || nb_out > 65535 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long gx = (n + 32 * CPL - 1) / (32 * CPL);
  if (gx > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, nb_out);
  blk_spmm_kernel<Tt, Tx, Ta, CPL><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const Tt*)tiles, order, cb, off, (const Tx*)x, (Ta*)y, n);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes), one per instantiation.  tiles
// [T, 128, 128]; order [T] lists the tiles row block by row block, off
// [nb_out + 1] delimits each row block's run in it; cb [T] is each tile's
// column block; x [m_src, n] and y [nb_out·128, n] are row-major.  Each
// launches on ``stream`` and returns the cudaError_t of the launch (0 on
// success); it never synchronises.
#define BLK_SPMM_ENTRY(NAME, TT, TX, TA, CPL)                              \
  extern "C" int NAME(const void* tiles, const int* order, const int* cb, \
                      const int* off, const void* x, void* y, int nb_out, \
                      long long n, void* stream) {                        \
    return launch<TT, TX, TA, CPL>(tiles, order, cb, off, x, y, nb_out,   \
                                   n, stream);                            \
  }

BLK_SPMM_ENTRY(blk_spmm_f32, float, float, float, 16)
BLK_SPMM_ENTRY(blk_spmm_bf16, __nv_bfloat16, __nv_bfloat16, float, 16)
BLK_SPMM_ENTRY(blk_spmm_f64, double, double, double, 16)
BLK_SPMM_ENTRY(blk_spmm_c64, float2, float2, float2, 16)
BLK_SPMM_ENTRY(blk_spmm_c128, double2, double2, double2, 8)
