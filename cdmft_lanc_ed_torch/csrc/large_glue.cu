// The H·v glue of the large kits around their two block-sparse SpMMs, for
// Hopper (sm_90a).
//
// For a batch of bb vectors x [bb, ddp, dup] on a large sector's padded
// (dw, up) grid, whose elements are f32, f64, or complex64 / complex128
// (re, im) pairs, H·x is
//
//   y_dw = H_dw · xdw,  xdw [ddp, dup·bb],  xdw[d, u·bb + b] = x[b, d, u]
//   y_up = H_up · xt,   xt  [dup, ddp·bb],  xt[u, d·bb + b]  = x[b, d, u]
//   out[b, d, u] = diag[d, u]·x[b, d, u] + y_dw[d, u·bb + b]
//                  + y_up[u, d·bb + b]
//
// with the two SpMMs in csrc/blk_spmm.cu.  glue_pack writes xt, and xdw for
// bb > 1, in one read of x (at bb = 1 xdw is x itself); glue_combine writes
// out in one read of diag, x, y_dw and y_up.  The diagonal is real and
// multiplies both parts of a complex element.
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA
// (ops/large.py::matvec_large_real), which fuses it.  The port ran it as
// PyTorch expressions, 11 passes over a vector per H·v at bb = 1 (the
// product, two adds, the transposed copy; the copy and the transposed add
// through PyTorch's strided elementwise path).  Here it takes 7: pack reads
// x and writes xt, combine reads diag, x, y_dw, y_up and writes out.
//
// What bounds it on an H100: device memory alone.  At Ns = 16 the (8,8)
// sector's padded f64 vector is 12,928² doubles (1.34 GB): the 7 passes
// move 9.36 GB, 2.79 ms at 3.35 TB/s.
//
// Design.  Both kernels cut the (d, u) grid into tiles of TILE u-columns
// (64 for 4-byte elements, 32 for the others) by td d-rows and a chunk of
// bc vectors of the batch: bc = bb and td = TILE / bb up to bb = TILE, else
// td = 1 and the batch in chunks of TILE.  Row r = dl·bc + bl of a tile is
// (d0 + dl, b0 + bl), so a tile's rows are consecutive columns of xt and
// y_up.  One block of 256 threads takes a tile.  Each transposed operand
// (xt written, y_up read; for bb > 1 also the interleaved xdw written and
// y_dw read) goes through shared memory, so that device memory is read and
// written along its rows only, each warp over whole segments of 128 to 512
// bytes.  At bb = 1, where the row lengths and the pointers allow, the
// accesses are 16 bytes wide (4 f32, 2 f64 or complex64, 1 complex128),
// else one element wide.  Each thread issues all its loads of a tile
// before its first store.  The combine rounds as PyTorch's glue did, in
// its order: the product, then the y_dw add, then the y_up add, each
// rounded to nearest (__dmul_rn, __dadd_rn and their f32 twins, so no
// fused multiply-add), which gives PyTorch's result bit for bit up to the
// sign of a zero.  Nothing here allocates or synchronises; every launch
// goes on the caller's stream.
#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block

// N consecutive scalars: one element (N = P) or one access (N = V·P)
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T c[N];
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Elements of P scalars T: the tile edge and the elements of a 16-byte
// access.
template <typename T, int P>
struct Geo {
  static constexpr int ESZ = (int)sizeof(T) * P;
  static constexpr int TILE = ESZ == 4 ? 64 : 32;
  static constexpr int VEC = 16 / ESZ;
};

// The tile of block blockIdx.x: u in [u0, u0 + TILE), d in [d0, d0 + td),
// b in [b0, b0 + bc), ``rows`` = td·bc rows, ``j0`` the xt / y_up column
// of row 0.  Without a batch (BAT false: bb = 1, so bc = 1 and td = TILE)
// every row's (d, b) is known at compile time.
template <int TILE, bool BAT>
struct Tile {
  long long u0, d0, j0, ddp, dup;
  int b0, bc, rows, bb;
  __device__ Tile(int bb_, int bc_, int td, long long ddp_, long long dup_,
                  long long nut, long long ndt) {
    long long id = blockIdx.x;
    u0 = (id % nut) * TILE;
    id /= nut;
    d0 = (id % ndt) * td;
    b0 = BAT ? (int)(id / ndt) * bc_ : 0;
    bb = BAT ? bb_ : 1;
    bc = BAT ? bc_ : 1;
    rows = BAT ? td * bc_ : TILE;
    ddp = ddp_;
    dup = dup_;
    j0 = d0 * bb + b0;
  }
  __device__ int dl(int r) const { return BAT ? r / bc : r; }
  __device__ int bl(int r) const { return BAT ? r % bc : 0; }
  // row r lies inside the grid and the batch
  __device__ bool row_ok(int r) const {
    return (BAT ? r < rows : r < TILE) && d0 + dl(r) < ddp &&
           (!BAT || b0 + bl(r) < bb);
  }
  // the x / out element of row r at u
  __device__ long long x_at(int r, long long u) const {
    return ((long long)(b0 + bl(r)) * ddp + d0 + dl(r)) * dup + u;
  }
  // the diag element of row r at u
  __device__ long long d_at(int r, long long u) const {
    return (d0 + dl(r)) * dup + u;
  }
  // the xt / y_up element of row r at u
  __device__ long long t_at(int r, long long u) const {
    return u * (ddp * bb) + j0 + r;
  }
  // the xdw / y_dw element of row r at u
  __device__ long long w_at(int r, long long u) const {
    return (d0 + dl(r)) * (dup * bb) + u * bb + b0 + bl(r);
  }
};

// xt, and for a batch (BAT: bb > 1) xdw, of x; V elements per access
// (V > 1 only without a batch)
template <typename T, int P, int V, bool BAT>
__global__ void __launch_bounds__(NT) glue_pack_kernel(
    const T* __restrict__ x, T* __restrict__ xt, T* __restrict__ xdw,
    int bb, int bc, int td, long long ddp, long long dup, long long nut,
    long long ndt) {
  constexpr int TILE = Geo<T, P>::TILE;
  constexpr int CV = TILE / V;                   // accesses per tile row
  constexpr int K = (TILE * CV + NT - 1) / NT;   // a full tile's, a thread
  using E = Pack<T, P>;
  using A = Pack<T, V * P>;
  __shared__ E sm[TILE][TILE + 1];
  const Tile<TILE, BAT> t(bb, bc, td, ddp, dup, nut, ndt);
  // accesses per tile column of xt (V consecutive rows are all in the
  // grid or all out: V > 1 only where V divides ddp)
  const int rv = BAT ? t.rows : CV;

  // x's rows into the tile, along u
  A reg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT, r = i / CV;
    const long long u = t.u0 + (i % CV) * V;
    if (t.row_ok(r) && u < dup)
      reg[k] = *reinterpret_cast<const A*>(x + t.x_at(r, u) * P);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT, r = i / CV, c = (i % CV) * V;
    if (t.row_ok(r) && t.u0 + c < dup) {
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int p = 0; p < P; ++p) sm[r][c + v].c[p] = reg[k].c[v * P + p];
    }
  }
  __syncthreads();

  // xt's rows out of the tile, along the rows
  for (int i = threadIdx.x; i < TILE * rv; i += NT) {
    const int c = i / rv, r = (i % rv) * V;
    const long long u = t.u0 + c;
    if (u >= dup || !t.row_ok(r)) continue;
    A a;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int p = 0; p < P; ++p) a.c[v * P + p] = sm[r + v][c].c[p];
    *reinterpret_cast<A*>(xt + t.t_at(r, u) * P) = a;
  }
  if (!BAT) return;

  // xdw's rows out of the tile: per d, along (u, b)
  for (int i = threadIdx.x; i < TILE * t.rows; i += NT) {
    const int dl = i / (TILE * bc), q = i % (TILE * bc);
    const int c = q / bc, r = dl * bc + q % bc;
    const long long u = t.u0 + c;
    if (u >= dup || !t.row_ok(r)) continue;
    *reinterpret_cast<E*>(xdw + t.w_at(r, u) * P) = sm[r][c];
  }
}

// out = diag·x + y_dw + y_up, each y transposed through a tile where it is
// not in x's layout: y_up always, y_dw for a batch (BAT)
template <typename T, int P, int V, bool BAT>
__global__ void __launch_bounds__(NT) glue_combine_kernel(
    const T* __restrict__ diag, const T* __restrict__ x,
    const T* __restrict__ ydw, const T* __restrict__ yup, T* __restrict__ out,
    int bb, int bc, int td, long long ddp, long long dup, long long nut,
    long long ndt) {
  constexpr int TILE = Geo<T, P>::TILE;
  constexpr int CV = TILE / V;
  constexpr int K = (TILE * CV + NT - 1) / NT;
  using E = Pack<T, P>;
  using A = Pack<T, V * P>;
  using D = Pack<T, V>;
  __shared__ E su[TILE][TILE + 1];
  __shared__ E sd[BAT ? TILE : 1][BAT ? TILE + 1 : 1];
  const Tile<TILE, BAT> t(bb, bc, td, ddp, dup, nut, ndt);
  const int rv = BAT ? t.rows : CV;

  // every load first: y_up's rows (along the rows), for a batch y_dw's
  // (along (u, b)), then x, diag and, without a batch, y_dw (along u)
  A ru[K], rx[K], rw[BAT ? 1 : K];
  D rd[K];
  E rt[BAT ? K : 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT;
    const int c = i / rv, r = (i % rv) * V;
    const long long u = t.u0 + c;
    if (i < TILE * rv && u < dup && t.row_ok(r))
      ru[k] = *reinterpret_cast<const A*>(yup + t.t_at(r, u) * P);
  }
  if (BAT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * NT;
      const int dl = i / (TILE * bc), q = i % (TILE * bc);
      const int c = q / bc, r = dl * bc + q % bc;
      const long long u = t.u0 + c;
      if (i < TILE * t.rows && u < dup && t.row_ok(r))
        rt[BAT ? k : 0] = *reinterpret_cast<const E*>(ydw + t.w_at(r, u) * P);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT, r = i / CV;
    const long long u = t.u0 + (i % CV) * V;
    if (t.row_ok(r) && u < dup) {
      rx[k] = *reinterpret_cast<const A*>(x + t.x_at(r, u) * P);
      rd[k] = *reinterpret_cast<const D*>(diag + t.d_at(r, u));
      if (!BAT)
        rw[BAT ? 0 : k] = *reinterpret_cast<const A*>(ydw + t.x_at(r, u) * P);
    }
  }

  // the transposed operands into their tiles
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT;
    const int c = i / rv, r = (i % rv) * V;
    if (i < TILE * rv && t.u0 + c < dup && t.row_ok(r)) {
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int p = 0; p < P; ++p) su[r + v][c].c[p] = ru[k].c[v * P + p];
    }
  }
  if (BAT) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * NT;
      const int dl = i / (TILE * bc), q = i % (TILE * bc);
      const int c = q / bc, r = dl * bc + q % bc;
      if (i < TILE * t.rows && t.u0 + c < dup && t.row_ok(r))
        sd[BAT ? r : 0][BAT ? c : 0] = rt[BAT ? k : 0];
    }
  }
  __syncthreads();

  // out along u, in PyTorch's order and rounding
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * NT, r = i / CV, c = (i % CV) * V;
    const long long u = t.u0 + c;
    if (!t.row_ok(r) || u >= dup) continue;
    A o;
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T w = BAT ? sd[BAT ? r : 0][BAT ? c + v : 0].c[p]
                        : rw[BAT ? 0 : k].c[v * P + p];
        const T s = add_rn(mul_rn(rd[k].c[v], rx[k].c[v * P + p]), w);
        o.c[v * P + p] = add_rn(s, su[r][c + v].c[p]);
      }
    *reinterpret_cast<A*>(out + t.x_at(r, u) * P) = o;
  }
}

// The tiling of a batch of bb: (bc, td) as the design note says, and the
// tile counts along u, d and the batch; false when the grid is too large.
struct Grid {
  int bc, td;
  long long nut, ndt, blocks;
  bool ok;
  Grid(int tile, int bb, long long ddp, long long dup) {
    bc = bb <= tile ? bb : tile;
    td = bb <= tile ? tile / bb : 1;
    nut = (dup + tile - 1) / tile;
    ndt = (ddp + td - 1) / td;
    blocks = nut * ndt * ((bb + bc - 1) / bc);
    ok = blocks <= INT_MAX;
  }
};

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T, int P>
int pack(const void* x, void* xt, void* xdw, int bb, long long ddp,
         long long dup, void* stream) {
  using G = Geo<T, P>;
  if (bb <= 0 || ddp < 0 || dup < 0 || (bb > 1) != (xdw != nullptr))
    return (int)cudaErrorInvalidValue;
  if (ddp == 0 || dup == 0) return 0;
  const Grid g(G::TILE, bb, ddp, dup);
  if (!g.ok) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = G::VEC > 1 && bb == 1 && dup % G::VEC == 0 &&
                   ddp % G::VEC == 0 && aligned16(x) && aligned16(xt);
  const T* xx = (const T*)x;
  if (vec)
    glue_pack_kernel<T, P, G::VEC, false><<<(unsigned)g.blocks, NT, 0, s>>>(
        xx, (T*)xt, nullptr, bb, g.bc, g.td, ddp, dup, g.nut, g.ndt);
  else if (bb == 1)
    glue_pack_kernel<T, P, 1, false><<<(unsigned)g.blocks, NT, 0, s>>>(
        xx, (T*)xt, nullptr, bb, g.bc, g.td, ddp, dup, g.nut, g.ndt);
  else
    glue_pack_kernel<T, P, 1, true><<<(unsigned)g.blocks, NT, 0, s>>>(
        xx, (T*)xt, (T*)xdw, bb, g.bc, g.td, ddp, dup, g.nut, g.ndt);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int combine(const void* diag, const void* x, const void* ydw,
            const void* yup, void* out, int bb, long long ddp, long long dup,
            void* stream) {
  using G = Geo<T, P>;
  if (bb <= 0 || ddp < 0 || dup < 0) return (int)cudaErrorInvalidValue;
  if (ddp == 0 || dup == 0) return 0;
  const Grid g(G::TILE, bb, ddp, dup);
  if (!g.ok) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = G::VEC > 1 && bb == 1 && dup % G::VEC == 0 &&
                   ddp % G::VEC == 0 && aligned16(diag) && aligned16(x) &&
                   aligned16(ydw) && aligned16(yup) && aligned16(out);
  const T *d = (const T*)diag, *xx = (const T*)x, *w = (const T*)ydw,
          *up = (const T*)yup;
  if (vec)
    glue_combine_kernel<T, P, G::VEC, false>
        <<<(unsigned)g.blocks, NT, 0, s>>>(d, xx, w, up, (T*)out, bb, g.bc,
                                           g.td, ddp, dup, g.nut, g.ndt);
  else if (bb == 1)
    glue_combine_kernel<T, P, 1, false><<<(unsigned)g.blocks, NT, 0, s>>>(
        d, xx, w, up, (T*)out, bb, g.bc, g.td, ddp, dup, g.nut, g.ndt);
  else
    glue_combine_kernel<T, P, 1, true><<<(unsigned)g.blocks, NT, 0, s>>>(
        d, xx, w, up, (T*)out, bb, g.bc, g.td, ddp, dup, g.nut, g.ndt);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  x and out are [bb, ddp, dup], xt and
// y_up [dup, ddp·bb], xdw and y_dw [ddp, dup·bb], all row-major of the
// entry's element (c64 / c128: (re, im) pairs of float / double); diag is
// [ddp, dup] of the real type.  xdw is null for bb = 1 and only then.
// Each launches on ``stream`` and returns the cudaError_t of the launch
// (0 on success); none synchronises.
#define GLUE_ENTRIES(SUFFIX, T, P)                                          \
  extern "C" int glue_pack_##SUFFIX(const void* x, void* xt, void* xdw,    \
                                    int bb, long long ddp, long long dup,  \
                                    void* stream) {                        \
    return pack<T, P>(x, xt, xdw, bb, ddp, dup, stream);                   \
  }                                                                         \
  extern "C" int glue_combine_##SUFFIX(                                     \
      const void* diag, const void* x, const void* ydw, const void* yup,    \
      void* out, int bb, long long ddp, long long dup, void* stream) {      \
    return combine<T, P>(diag, x, ydw, yup, out, bb, ddp, dup, stream);     \
  }

GLUE_ENTRIES(f32, float, 1)
GLUE_ENTRIES(f64, double, 1)
GLUE_ENTRIES(c64, float, 2)
GLUE_ENTRIES(c128, double, 2)
