// The vector recurrence of a GF Lanczos chain step for Hopper (sm_90a).
//
// After the H·v of a step gives w = H v, for each of the B rows (one start
// vector each, length n):
//
//   chain_dot     α = Σ_i v_i w_i
//   chain_update  w ← w − α v − β' p,   s = Σ_i w_i²   (β' the last β)
//   chain_scale   β = √s;  w ← w / β, or zeros where β ≤ 1e-200
//
// after which the caller rotates its buffers (p ← v, v ← w) without a copy.
// A complex chain (α and β real) is the same recurrence on the (re, im)
// pairs of its vectors, so it runs on their real view at twice the length.
//
// Replaces no TPU kernel: the JAX package runs the recurrence inside the
// jitted lax.scan of its tridiagonalisation (ops/lanczos.py::
// _tridiag_real_run), which XLA fuses; the port ran it as eager PyTorch
// expressions, ~21 passes over a vector a step, several of them broadcast
// kernels below the bandwidth.  Here it takes 8 passes (7 on a chain's first
// step, whose p is zero and not read): read v, w; read w, v, p and write w;
// read and write w.
//
// What bounds it on an H100: at Ns=16 a row is 1.49e8 f64 (1.19 GB), so a
// step moves 9.5 GB for ~3·n flops: bound by device memory, 2.85 ms at
// 3.35 TB/s.  At Ns=12 (6.8 MB rows, B ≤ 16) a step is a few tens of µs and
// bound by its launches: three instead of ~12.
//
// Design.  A grid of B × nb blocks of 256 threads; block (row, k) walks its
// row with a stride of nb·256 packs of 16 bytes (double2, float4), two packs
// of each operand in flight per thread.  nb aims at 4 resident blocks per
// SM over the whole grid (B = 1 at 1.5e8 and B = 16 at 8.5e5 alike) and is
// at most 1024.  A row starts wherever n puts it, so each row's first
// elements up to a 16-byte boundary and its last ones after the last whole
// pack go one element at a time (at most 6, taken by block (row, 0)); where
// the operands do not share their alignment the whole row goes one element
// at a time.  The two reductions sum in double for f32 and f64 alike:
// each thread sums its elements in order with fma, each block sums its
// threads by a fixed shuffle tree, writes its partial, and the last block
// of the row to arrive (an integer counter, which it resets for the next
// launch) sums the row's nb partials in the same fixed order and writes
// the total.  No floating-point atomics: repeated runs are bitwise equal.
// The update is two IEEE fmas per element.  α and β stay on the device:
// chain_dot writes α into the caller's α slot, chain_update reads it and
// β' from theirs and leaves s in a [B] double buffer (for a sharded chain
// the caller sums α and s over its ranks between the launches), and
// chain_scale writes β into the β slot.  Nothing here allocates or
// synchronises; every launch goes on the caller's stream.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int WARPS = NT / 32;
constexpr int BLOCKS_PER_SM = 4;    // resident blocks the grid aims at
constexpr int MAX_NB = 1024;        // blocks, and partials, per row

// VEC consecutive entries: one 16-byte access on the vector path
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// A row at r of length n: elements [0, head) and [tail, n) one at a time,
// packs of VEC between (VEC = 1: every element is a pack).
template <typename T, int VEC>
struct Row {
  long long head, packs, tail;
  __device__ Row(const T* r, long long n) {
    if (VEC == 1) {
      head = 0;
      packs = tail = n;
      return;
    }
    const long long h =
        (long long)(((16u - ((uintptr_t)r & 15u)) & 15u) / sizeof(T));
    head = h < n ? h : n;
    packs = (n - head) / VEC;
    tail = head + packs * VEC;
  }
  // the element that thread t of block (row, 0) takes one at a time, or -1
  __device__ long long edge(int t, long long n) const {
    if (t < head) return t;
    const long long e = tail + (t - head);
    return e < n ? e : -1;
  }
};

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// the block's sum of x, in thread 0 (the same tree every run)
__device__ double block_sum(double x) {
  __shared__ double sh[WARPS];
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = x;
  __syncthreads();
  x = threadIdx.x < WARPS ? sh[threadIdx.x] : 0.0;
  if (threadIdx.x < 32) x = warp_sum(x);
  return x;
}

// Adds this block's per-thread sums s to row ``row``'s total: the block
// writes its partial to part[row·nb + k], and the last block of the row to
// arrive sums the row's nb partials and writes the total to out[row].
template <typename To>
__device__ void finish(double s, double* part, unsigned* cnt, To* out,
                       int row, int k, int nb) {
  __shared__ bool last;
  s = block_sum(s);
  if (threadIdx.x == 0) {
    part[(size_t)row * nb + k] = s;
    __threadfence();
    last = atomicAdd(&cnt[row], 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double x = 0.0;
  for (int j = threadIdx.x; j < nb; j += NT)
    x += __ldcg(&part[(size_t)row * nb + j]);
  x = block_sum(x);
  if (threadIdx.x == 0) {
    out[row] = (To)x;
    cnt[row] = 0u;
  }
}

// α[row] = Σ v·w over the row
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) chain_dot_kernel(
    const T* __restrict__ v, const T* __restrict__ w, T* __restrict__ alpha,
    double* __restrict__ part, unsigned* __restrict__ cnt, long long n,
    int nb) {
  using P = Pack<T, VEC>;
  const int row = blockIdx.x / nb, k = blockIdx.x % nb;
  const T* vr = v + (size_t)row * (size_t)n;
  const T* wr = w + (size_t)row * (size_t)n;
  const Row<T, VEC> g(vr, n);
  const P* vp = reinterpret_cast<const P*>(vr + g.head);
  const P* wp = reinterpret_cast<const P*>(wr + g.head);
  const long long stride = (long long)nb * NT;
  double acc = 0.0;
  long long i = (long long)k * NT + threadIdx.x;
  for (; i + stride < g.packs; i += 2 * stride) {
    const P a0 = vp[i], b0 = wp[i], a1 = vp[i + stride], b1 = wp[i + stride];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc = fma((double)a0.v[e], (double)b0.v[e], acc);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc = fma((double)a1.v[e], (double)b1.v[e], acc);
  }
  if (i < g.packs) {
    const P a0 = vp[i], b0 = wp[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc = fma((double)a0.v[e], (double)b0.v[e], acc);
  }
  if (k == 0) {
    const long long e = g.edge(threadIdx.x, n);
    if (e >= 0) acc = fma((double)vr[e], (double)wr[e], acc);
  }
  finish(acc, part, cnt, alpha, row, k, nb);
}

// w ← w − α v − β' p over the row (no p on a chain's first step),
// sq[row] = Σ w²
template <typename T, int VEC, bool HAS_P>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) chain_update_kernel(
    T* __restrict__ w, const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ alpha, const T* __restrict__ beta_prev,
    double* __restrict__ sq, double* __restrict__ part,
    unsigned* __restrict__ cnt, long long n, int nb) {
  using P = Pack<T, VEC>;
  const int row = blockIdx.x / nb, k = blockIdx.x % nb;
  const size_t off = (size_t)row * (size_t)n;
  T* wr = w + off;
  const T* vr = v + off;
  const T* pr = HAS_P ? p + off : nullptr;
  const T a = -alpha[row];
  const T b = HAS_P ? -beta_prev[row] : T(0);
  const Row<T, VEC> g(wr, n);
  P* wp = reinterpret_cast<P*>(wr + g.head);
  const P* vp = reinterpret_cast<const P*>(vr + g.head);
  const P* pp = HAS_P ? reinterpret_cast<const P*>(pr + g.head) : nullptr;
  const long long stride = (long long)nb * NT;
  double acc = 0.0;
  long long i = (long long)k * NT + threadIdx.x;
  for (; i + stride < g.packs; i += 2 * stride) {
    P x0 = wp[i], x1 = wp[i + stride];
    const P y0 = vp[i], y1 = vp[i + stride];
    P z0, z1;
    if (HAS_P) {
      z0 = pp[i];
      z1 = pp[i + stride];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      T t = fma_t(a, y0.v[e], x0.v[e]);
      if (HAS_P) t = fma_t(b, z0.v[e], t);
      x0.v[e] = t;
      acc = fma((double)t, (double)t, acc);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      T t = fma_t(a, y1.v[e], x1.v[e]);
      if (HAS_P) t = fma_t(b, z1.v[e], t);
      x1.v[e] = t;
      acc = fma((double)t, (double)t, acc);
    }
    wp[i] = x0;
    wp[i + stride] = x1;
  }
  if (i < g.packs) {
    P x0 = wp[i];
    const P y0 = vp[i];
    P z0;
    if (HAS_P) z0 = pp[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      T t = fma_t(a, y0.v[e], x0.v[e]);
      if (HAS_P) t = fma_t(b, z0.v[e], t);
      x0.v[e] = t;
      acc = fma((double)t, (double)t, acc);
    }
    wp[i] = x0;
  }
  if (k == 0) {
    const long long e = g.edge(threadIdx.x, n);
    if (e >= 0) {
      T t = fma_t(a, vr[e], wr[e]);
      if (HAS_P) t = fma_t(b, pr[e], t);
      wr[e] = t;
      acc = fma((double)t, (double)t, acc);
    }
  }
  finish(acc, part, cnt, sq, row, k, nb);
}

// β[row] = √sq[row]; the row ← row / β, or zeros where β ≤ 1e-200
template <typename T, int VEC>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) chain_scale_kernel(
    T* __restrict__ w, const double* __restrict__ sq, T* __restrict__ beta,
    long long n, int nb) {
  using P = Pack<T, VEC>;
  const int row = blockIdx.x / nb, k = blockIdx.x % nb;
  T* wr = w + (size_t)row * (size_t)n;
  const T bt = (T)sqrt(sq[row]);
  if (k == 0 && threadIdx.x == 0) beta[row] = bt;
  const bool good = (double)bt > 1e-200;
  const Row<T, VEC> g(wr, n);
  P* wp = reinterpret_cast<P*>(wr + g.head);
  const long long stride = (long long)nb * NT;
  for (long long i = (long long)k * NT + threadIdx.x; i < g.packs;
       i += stride) {
    P x;
    if (good) {
      x = wp[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = x.v[e] / bt;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = T(0);
    }
    wp[i] = x;
  }
  if (k == 0) {
    const long long e = g.edge(threadIdx.x, n);
    if (e >= 0) wr[e] = good ? wr[e] / bt : T(0);
  }
}

// Blocks per row: about BLOCKS_PER_SM per SM over the grid, one pack per
// thread at least, at most MAX_NB.
template <typename T>
int blocks_per_row(int rows, long long n, int* nb) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  constexpr long long VEC = 16 / sizeof(T);
  const long long want = ((n + VEC - 1) / VEC + NT - 1) / NT;
  const long long share =
      ((long long)sms * BLOCKS_PER_SM + rows - 1) / rows;
  long long b = want < share ? want : share;
  b = b < MAX_NB ? b : MAX_NB;
  *nb = b < 1 ? 1 : (int)b;
  if ((long long)rows * *nb > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// whether the operands share their place within 16 bytes (then every row
// of each starts at the same offset from a 16-byte boundary), so the
// vector path serves them all
bool alike(const void* a, const void* b, const void* c = nullptr) {
  const uintptr_t r = (uintptr_t)a & 15u;
  return ((uintptr_t)b & 15u) == r && (!c || ((uintptr_t)c & 15u) == r);
}

template <typename T>
int dot(const void* v, const void* w, void* alpha, void* part, void* cnt,
        int rows, long long n, void* stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  int nb = 0;
  int err = blocks_per_row<T>(rows, n, &nb);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int VEC = 16 / sizeof(T);
  if (alike(v, w))
    chain_dot_kernel<T, VEC><<<rows * nb, NT, 0, s>>>(
        (const T*)v, (const T*)w, (T*)alpha, (double*)part, (unsigned*)cnt,
        n, nb);
  else
    chain_dot_kernel<T, 1><<<rows * nb, NT, 0, s>>>(
        (const T*)v, (const T*)w, (T*)alpha, (double*)part, (unsigned*)cnt,
        n, nb);
  return (int)cudaGetLastError();
}

template <typename T, bool HAS_P>
void update_launch(bool vec, int grid, cudaStream_t s, void* w,
                   const void* v, const void* p, const void* alpha,
                   const void* beta_prev, void* sq, void* part, void* cnt,
                   long long n, int nb) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec)
    chain_update_kernel<T, VEC, HAS_P><<<grid, NT, 0, s>>>(
        (T*)w, (const T*)v, (const T*)p, (const T*)alpha,
        (const T*)beta_prev, (double*)sq, (double*)part, (unsigned*)cnt, n,
        nb);
  else
    chain_update_kernel<T, 1, HAS_P><<<grid, NT, 0, s>>>(
        (T*)w, (const T*)v, (const T*)p, (const T*)alpha,
        (const T*)beta_prev, (double*)sq, (double*)part, (unsigned*)cnt, n,
        nb);
}

template <typename T>
int update(void* w, const void* v, const void* p, const void* alpha,
           const void* beta_prev, void* sq, void* part, void* cnt, int rows,
           long long n, void* stream) {
  if (rows <= 0 || n < 0 || (p == nullptr) != (beta_prev == nullptr))
    return (int)cudaErrorInvalidValue;
  int nb = 0;
  int err = blocks_per_row<T>(rows, n, &nb);
  if (err) return err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p)
    update_launch<T, true>(alike(w, v, p), rows * nb, s, w, v, p, alpha,
                           beta_prev, sq, part, cnt, n, nb);
  else
    update_launch<T, false>(alike(w, v), rows * nb, s, w, v, p, alpha,
                            beta_prev, sq, part, cnt, n, nb);
  return (int)cudaGetLastError();
}

template <typename T>
int scale(void* w, const void* sq, void* beta, int rows, long long n,
          void* stream) {
  if (rows <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  int nb = 0;
  int err = blocks_per_row<T>(rows, n, &nb);
  if (err) return err;
  constexpr int VEC = 16 / sizeof(T);
  chain_scale_kernel<T, VEC><<<rows * nb, NT, 0, (cudaStream_t)stream>>>(
      (T*)w, (const double*)sq, (T*)beta, n, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  Vectors are [rows, n] row-major of
// the entry's type (a complex chain passes its real view); alpha, beta and
// beta_prev are [rows] of that type, sq [rows] double; part holds
// rows · chain_max_blocks() doubles and cnt rows unsigned ints, zero before
// the first launch (each launch leaves them so).  p and beta_prev are both
// null on a chain's first step.  Each launches on ``stream`` and returns
// the cudaError_t of the launch (0 on success); none synchronises.
extern "C" int chain_max_blocks() { return MAX_NB; }

#define CHAIN_ENTRIES(SUFFIX, T)                                            \
  extern "C" int chain_dot_##SUFFIX(const void* v, const void* w,          \
                                    void* alpha, void* part, void* cnt,    \
                                    int rows, long long n, void* stream) { \
    return dot<T>(v, w, alpha, part, cnt, rows, n, stream);                \
  }                                                                         \
  extern "C" int chain_update_##SUFFIX(                                     \
      void* w, const void* v, const void* p, const void* alpha,             \
      const void* beta_prev, void* sq, void* part, void* cnt, int rows,     \
      long long n, void* stream) {                                          \
    return update<T>(w, v, p, alpha, beta_prev, sq, part, cnt, rows, n,     \
                     stream);                                               \
  }                                                                         \
  extern "C" int chain_scale_##SUFFIX(void* w, const void* sq, void* beta, \
                                      int rows, long long n,                \
                                      void* stream) {                       \
    return scale<T>(w, sq, beta, rows, n, stream);                          \
  }

CHAIN_ENTRIES(f64, double)
CHAIN_ENTRIES(f32, float)
