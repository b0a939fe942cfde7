// Block-sparse SpMM of one spin factor for Hopper (sm_90a):
//
//   y[r, c] = Σ_{p = row_ptr[r]}^{row_ptr[r+1]-1} vals[p] · x[cols[p], c]
//
// The spin factor H_up or H_dw of a large sector (Ns >= 16, factors beyond
// the dense-factor limit) is stored by the port as 128x128 dense tiles
// with row- and column-block indices (the plain version and the CPU path
// use them) and, for this kernel, in a compact form built once per
// operator: for each output row its nonzeros as (value, global source
// row) in ascending column order, a CSR of the factor (ops/large.py,
// blk_structure).  Applied to the sector vector X [DimDw, DimUp] this is
// H_dw·X in the natural layout and H_up·Xᵀ in the transposed one.
//
// Replaces the TPU kernel of the JAX package, ops/large.py::
// _pallas_blk_spmm_call (the pl.pallas_call at :403), the H·v of every
// large-sector solve and GF chain.  Instantiations: f32 (the Krylov stage,
// IEEE fmaf, never TF32), bf16 values and x with f32 accumulation (the
// coarse stage), f64 (refine, f64 solves and GF chains), complex64 and
// complex128 (complex sector Hamiltonians; interleaved re/im), and bf16
// complex values and x (interleaved (re, im) bf16 pairs, 4 bytes per
// entry) with float2 accumulation and complex64 output (the coarse stage
// of complex sectors: the JAX package's bf16 re/im/re+im tile planes).
//
// What bounds it on an H100: the factor is ~0.5% of its tiles (Ns=16:
// ~1.1e5 nonzeros, ~8.6 per row), so the product needs 2·nnz·n operations
// (3e9 at n = 12,928) against x and y moved once plus the compact form
// (1.3 GB in f32): about 0.4 ms at 3.35 TB/s against 0.05 ms of FP32
// work, so it is bound by bytes.  Each x row is used ~8.6 times, once for
// each nonzero in its column, so those reuses have to come from L2 and
// not from device memory.
//
// Design.  Two things made the tile-walking kernel slow: x came from
// device memory ~8.6 times over (the blocks resident at one time covered
// every column slice of a few row blocks, a working set of all of x), and
// every column slice rescanned its row block's dense, 0.5% full tiles.
// Here the grid is one dimension with the row group fastest, so the
// blocks resident at one time work on one column slice of x: 2 KB of
// each x row, 26 MB for all 12,928 rows, which L2 (50 MB) holds
// while the slice's blocks run; every reuse of an x row is an L2 hit and
// x is read from device memory about once.  The tiles are not read at
// all: a warp owns one output row, loads that row's nonzeros (~8.6: one
// coalesced load of up to 32 (column, value) pairs), and for each
// broadcasts the pair by shuffle and streams the source row's slice with
// 16-byte loads (float4, double2, 8 bf16, 4 bf16 pairs, 2 complex64, 1
// complex128);
// the ~5.7 GB (f32) of x rows that the nonzeros gather then stream from
// L2, which is what bounds the kernel after the redesign.  Sums run in
// ascending global column order with IEEE fmaf/fma (complex: four real
// FMAs); bf16 values and x, real or complex, are widened to f32.  y is written once with
// streaming stores, so it does not push the x slice out of L2.  A row
// without nonzeros writes zeros.  The ragged edge of n is masked; where n
// or a pointer does not allow 16-byte accesses, the same kernel runs with
// one element per access.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// 16-byte accesses per lane and row: a 2 KB slice of each x row (512 f32
// or bf16 complex, 1024 bf16, 256 f64 or complex64, 128 complex128
// columns), 26 MB for the 12,928 rows of an Ns=16 factor.  On an H100 a
// 1 KB slice was no faster in any type and slower in f64, the type of
// nearly every large-sector launch.
constexpr int WARPS = 8;            // rows per block, one per warp
constexpr int NT = 32 * WARPS;      // 256 threads
constexpr int NV = 4;               // 16-byte accesses per lane per row

// accumulator-type view of a value or x entry
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

__device__ __forceinline__ int shfl(int v, int l) {
  return __shfl_sync(0xffffffffu, v, l);
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

// VEC consecutive x entries, loaded as one access (16 bytes on the vector
// path, one element on the scalar one)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// y[0:VEC] = a: 16 bytes per streaming store on the vector path (so y
// does not push the x slice out of L2), one element per store otherwise
__device__ __forceinline__ void store(float* y, const float (&a)[1]) {
  y[0] = a[0];
}
__device__ __forceinline__ void store(double* y, const double (&a)[1]) {
  y[0] = a[0];
}
__device__ __forceinline__ void store(float2* y, const float2 (&a)[1]) {
  y[0] = a[0];
}
__device__ __forceinline__ void store(float* y, const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(y), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void store(float* y, const float (&a)[8]) {
  __stcs(reinterpret_cast<float4*>(y), make_float4(a[0], a[1], a[2], a[3]));
  __stcs(reinterpret_cast<float4*>(y + 4),
         make_float4(a[4], a[5], a[6], a[7]));
}
__device__ __forceinline__ void store(double* y, const double (&a)[2]) {
  __stcs(reinterpret_cast<double2*>(y), make_double2(a[0], a[1]));
}
__device__ __forceinline__ void store(float2* y, const float2 (&a)[2]) {
  __stcs(reinterpret_cast<float4*>(y),
         make_float4(a[0].x, a[0].y, a[1].x, a[1].y));
}
__device__ __forceinline__ void store(float2* y, const float2 (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(y),
         make_float4(a[0].x, a[0].y, a[1].x, a[1].y));
  __stcs(reinterpret_cast<float4*>(y + 2),
         make_float4(a[2].x, a[2].y, a[3].x, a[3].y));
}
__device__ __forceinline__ void store(double2* y, const double2 (&a)[1]) {
  __stcs(y, a[0]);
}

// Tv: value, Tx: x entry, Ta: accumulator and output; VEC x entries per
// access.  Block b handles rows (b mod row_groups)·WARPS + warp of the
// column slice b / row_groups.
template <typename Tv, typename Tx, typename Ta, int VEC>
__global__ void __launch_bounds__(NT) blk_spmm_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const Tv* __restrict__ vals, const Tx* __restrict__ x,
    Ta* __restrict__ y, int rows, long long n, int row_groups) {
  using P = Pack<Tx, VEC>;
  constexpr int W = 32 * NV * VEC;   // columns of a slice
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int r = (int)(b % row_groups) * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const long long c0 = (b / row_groups) * W + (long long)lane * VEC;
  bool in[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) in[v] = c0 + v * 32 * VEC < n;

  Ta acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = zero<Ta>();

  const int p1 = row_ptr[r + 1];
  for (int p = row_ptr[r]; p < p1; p += 32) {
    const int cnt = min(32, p1 - p);   // the same for the whole warp
    int col = 0;
    Ta val = zero<Ta>();
    if (lane < cnt) {
      col = cols[p + lane];
      val = widen(vals[p + lane]);
    }
    for (int j = 0; j < cnt; ++j) {
      const P* xr = reinterpret_cast<const P*>(
          x + (size_t)shfl(col, j) * (size_t)n + c0);
      const Ta a = shfl(val, j);
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (in[v]) {
          const P q = xr[v * 32];
#pragma unroll
          for (int e = 0; e < VEC; ++e) fma_acc(acc[v][e], a, widen(q.v[e]));
        }
    }
  }
  Ta* yr = y + (size_t)r * (size_t)n + c0;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (in[v]) store(yr + v * 32 * VEC, acc[v]);
}

template <typename Tv, typename Tx, typename Ta, int VEC>
int launch_vec(const int* row_ptr, const int* cols, const void* vals,
               const void* x, void* y, int rows, long long n,
               cudaStream_t stream) {
  const int row_groups = (rows + WARPS - 1) / WARPS;
  constexpr long long W = 32LL * NV * VEC;
  const long long slices = (n + W - 1) / W;
  const long long blocks = slices * row_groups;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  blk_spmm_kernel<Tv, Tx, Ta, VEC><<<(unsigned)blocks, NT, 0, stream>>>(
      row_ptr, cols, (const Tv*)vals, (const Tx*)x, (Ta*)y, rows, n,
      row_groups);
  return (int)cudaGetLastError();
}

// The vector path (16-byte accesses) where n and both pointers allow it,
// else one element per access.
template <typename Tv, typename Tx, typename Ta>
int launch(const int* row_ptr, const int* cols, const void* vals,
           const void* x, void* y, int rows, long long n, void* stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  constexpr int VEC = 16 / sizeof(Tx);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (n * (long long)sizeof(Tx)) % 16 == 0 &&
                   (n * (long long)sizeof(Ta)) % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  if (vec && VEC > 1)
    return launch_vec<Tv, Tx, Ta, VEC>(row_ptr, cols, vals, x, y, rows, n,
                                       s);
  return launch_vec<Tv, Tx, Ta, 1>(row_ptr, cols, vals, x, y, rows, n, s);
}

}  // namespace

// C entry points (bound with ctypes), one per instantiation.  row_ptr
// [rows + 1], cols [nnz] (global source rows, ascending within a row) and
// vals [nnz] are the compact form of the factor; x [m_src, n] and y
// [rows, n] are row-major.  Each launches on ``stream`` and returns the
// cudaError_t of the launch (0 on success); it never synchronises.
#define BLK_SPMM_ENTRY(NAME, TV, TX, TA)                                   \
  extern "C" int NAME(const int* row_ptr, const int* cols,                \
                      const void* vals, const void* x, void* y, int rows, \
                      long long n, void* stream) {                        \
    return launch<TV, TX, TA>(row_ptr, cols, vals, x, y, rows, n,         \
                              stream);                                    \
  }

BLK_SPMM_ENTRY(blk_spmm_f32, float, float, float)
BLK_SPMM_ENTRY(blk_spmm_bf16, __nv_bfloat16, __nv_bfloat16, float)
BLK_SPMM_ENTRY(blk_spmm_f64, double, double, double)
BLK_SPMM_ENTRY(blk_spmm_c64, float2, float2, float2)
BLK_SPMM_ENTRY(blk_spmm_c128, double2, double2, double2)
BLK_SPMM_ENTRY(blk_spmm_bf16c, __nv_bfloat162, __nv_bfloat162, float2)
