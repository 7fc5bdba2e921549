// Batch-minor products, Taylor expm and its backward pass for large sweeps of
// small complex matrices, for Hopper (sm_90a).
//
// Replaces three TPU kernels of qiskit_dynamics_tpu/ops/batched_linalg.py
// (Pallas): _matmul_kernel (launched by matmul_bol), _expm_kernel
// (expm_taylor_bol) and _expm_bwd_kernel (expm_taylor_bol_bwd). Wrappers and
// plain versions: qiskit_dynamics_tpu_torch/ops/batched_linalg.py.
//
// Layout. Matrices come as (n, n, L) real and imaginary planes with the lane
// (sweep member x time step) minor, n <= 256: float32, or float64 for the expm
// (the complex128 instantiation serves the FP64 Magnus Dysolve). A plane is addressed with an
// element stride es: 1 for a contiguous plane, 2 for the real or imaginary
// view of a contiguous complex tensor, so neither form needs a copy.
// Outputs are written as the two views of one complex tensor (stride 2).
//
// What they compute, per lane:
// - matmul_bol_kernel:  C = A B.
// - expm_bol_kernel:    s = X 2^-q; t = I + s/p; t <- I + (s t)/k for
//                       k = p-1..1; t <- t t, q times; P = t.
// - expm_bwd_bol_kernel: the vector-Jacobian product of that recursion. The
//   forward is recomputed with every stage operand t kept (p - 1 + q of them);
//   then, from g = cotangent of P: per squaring g <- y^H g + g y^H; per Horner
//   stage (k = 1..p-1) sbar += (g t_{k+1}^H)/k and g <- (s^H g)/k; finally
//   sbar += g/p and Xbar = sbar 2^-q.
//
// What bounds them on this card. expm and its backward are operation-bound:
// (p - 1 + q) and (3(p - 1) + 3q) products of 8 n^3 float32 operations per lane
// against 16 n^2 and 24 n^2 bytes of traffic (at n = 10, p = 12, q = 1: 96 and
// 288 kFLOP against 1.6 and 2.4 kB). matmul alone is byte-bound (8 n^3 against
// 24 n^2 bytes). What limits a product held in shared memory is neither: it is
// the shared-memory traffic, two 8-byte loads per complex multiply-add when a
// thread forms one entry at a time (the first version of this file: 14.4 ms
// for expm at 2,048,000 lanes of n = 10 against a 2.9 ms bound).
//
// Design. One block owns LB lanes (a power of two up to 32, the largest whose
// matrices fit about half an SM's shared memory, so two blocks share an SM;
// in FP64 each matrix takes twice the bytes, so a block holds half the lanes;
// from n ~ 40 one lane's matrices pass half an SM and a block holds one lane,
// up to the whole 227 KB: n = 98 for the product and the expm, 76 for the
// backward, 69 for the FP64 expm).
// Above that a lane's working matrices live in device memory instead: a
// per-block region of a work buffer the wrapper allocates (row-major, one
// lane per block), read through L1 and L2 by the same code (shared and
// device memory share the generic address space; only the copy-in differs).
// Such blocks are persistent, one per SM, and walk over the lanes. A lane has
// at most 256 threads (their registers fill an SM); where its tiles are more
// (n > 64), every thread loops over the tiles q = q0, q0 + qs, ... of its lane.
// Working matrices are float2 arrays [row][col][lane] in shared memory, lane
// minor: a half-warp's 8-byte accesses fall on consecutive words. A thread
// owns one TILE x TILE block of entries of its lane's matrices (TILE = 5
// where it divides n, as at n = 10, else 4; ragged tiles clamp their loads
// and mask their stores). All three entry points share one product routine,
// cmm: per m the thread loads TILE entries of op(A) and TILE of op(B) and
// does TILE^2 complex multiply-adds in registers, 2/TILE loads per
// multiply-add instead of 2, summing over m in order. A^H B reads A
// transposed in place and A B^H reads B transposed in place, with the
// conjugation applied in registers (the TPU kernel needed an explicit
// conjugate-transpose copy for the latter). Every elementwise pass touches
// only the thread's own tile, so it needs no barrier. Horner stages alternate
// between two buffers instead of copying the product back. The backward pass
// keeps its stage operands in a per-block scratch in device memory: each
// thread writes and later reads back only its own tile, so no fence is
// needed, and with one block per resident slot the scratch (12 x 800 B per
// lane at n = 10) stays mostly in L2. Blocks walk over the lane tiles (those
// of the product and the expm once, where the grid has a block per tile).
// Ragged last lane tiles are masked (dead lanes compute on zeros and store
// nothing).
//
// FP64 (expm only). The same code in double, with the same register tile:
// twice the shared memory per lane, so a block holds half the lanes, and twice
// the registers (the 5 x 5 tile of complex128 accumulators takes 100 of them).
// Bound: operations, all of them matrix products, against the 67 TFLOP/s of
// the FP64 tensor cores.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Up to n = 98 one lane's three complex64 matrices fit a block's 227 KB of
// shared memory (76 for the backward's five, 69 for three complex128 ones);
// above, they go to device memory, up to n = 256.
constexpr int kMaxN = 256;
constexpr int kMaxThreads = 1024;
// Threads per lane at most (one per tile below; above, each loops over several
// tiles): 256 threads of up to 255 registers fill an SM's register file.
constexpr int kLaneThreads = 256;
constexpr size_t kSharedTarget = 110 * 1024;  // two blocks of this size share an SM
constexpr size_t kSharedLimit = 232448;       // dynamic shared memory a block may use
constexpr int kOutStride = 2;                 // outputs are views of a complex64 tensor
constexpr int kBwdMats = 5;                   // working matrices of the backward kernel

enum Op { kAB, kAhB, kABh };

template <typename R> struct Complex;
template <> struct Complex<float> { using type = float2; };
template <> struct Complex<double> { using type = double2; };

__device__ __forceinline__ float fma_r(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_r(double a, double b, double c) { return fma(a, b, c); }

template <typename R>
__device__ __forceinline__ typename Complex<R>::type cplx(R x, R y) {
  typename Complex<R>::type c;
  c.x = x;
  c.y = y;
  return c;
}

// What a thread owns: lane `lane` of the block's LB lanes (global lane b), and
// the TILE x TILE tiles q = q0, q0 + qs, ... (< side^2) of that lane's
// matrices, tile q covering rows (q / side) TILE + [0, TILE) and columns
// (q % side) TILE + [0, TILE). Up to n = 64 a block has a thread per tile and
// lane, so each thread owns the one tile q0; W (wide) instantiations, for n
// above that or matrices in device memory, loop over q.
template <bool W>
struct Own {
  int n, LB, lane, q0, qs, side;
  long long L, b;
  bool live;
};

template <int TILE, bool W>
__device__ __forceinline__ Own<W> own_of(int n, int LB, long long L, long long tile) {
  Own<W> t;
  t.n = n;
  t.LB = LB;
  t.lane = threadIdx.x % LB;
  t.q0 = threadIdx.x / LB;
  t.qs = blockDim.x / LB;
  t.side = (n + TILE - 1) / TILE;
  t.L = L;
  t.b = tile * LB + t.lane;
  t.live = t.b < L;
  return t;
}

// One tile of C (+)= coef * op(A) op(B) (+ I), rows i0.. and columns j0..;
// C is neither A nor B.
template <int OP, int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void cmm_tile(const Own<W>& t, int i0, int j0,
                                         const C2* __restrict__ A, const C2* __restrict__ B,
                                         C2* __restrict__ C, R coef, bool accumulate,
                                         bool add_identity) {
  const int n = t.n, LB = t.LB, last = t.n - 1;
  C2 acc[TILE][TILE];
#pragma unroll
  for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) acc[ii][jj] = cplx<R>(0, 0);
  int rows[TILE], cols[TILE];
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    rows[k] = min(i0 + k, last);  // ragged tiles: clamped loads, masked stores
    cols[k] = min(j0 + k, last);
  }
#pragma unroll 2
  for (int m = 0; m < n; ++m) {
    C2 a[TILE], b[TILE];
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
      a[k] = OP == kAhB ? A[(m * n + rows[k]) * LB + t.lane] : A[(rows[k] * n + m) * LB + t.lane];
      if (OP == kAhB) a[k].y = -a[k].y;
      b[k] = OP == kABh ? B[(cols[k] * n + m) * LB + t.lane] : B[(m * n + cols[k]) * LB + t.lane];
      if (OP == kABh) b[k].y = -b[k].y;
    }
#pragma unroll
    for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        // four fused multiply-adds (written out: "acc += p - q" would cost a
        // multiply, a fused multiply-add and an add)
        acc[ii][jj].x = fma_r(a[ii].x, b[jj].x, acc[ii][jj].x);
        acc[ii][jj].x = fma_r(-a[ii].y, b[jj].y, acc[ii][jj].x);
        acc[ii][jj].y = fma_r(a[ii].x, b[jj].y, acc[ii][jj].y);
        acc[ii][jj].y = fma_r(a[ii].y, b[jj].x, acc[ii][jj].y);
      }
  }
#pragma unroll
  for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      const int i = i0 + ii, j = j0 + jj;
      if (i < n && j < n) {
        C2 c = cplx<R>(acc[ii][jj].x * coef, acc[ii][jj].y * coef);
        const int at = (i * n + j) * LB + t.lane;
        if (accumulate) {
          c.x += C[at].x;
          c.y += C[at].y;
        }
        if (add_identity && i == j) c.x += R(1);
        C[at] = c;
      }
    }
}

// The thread's tiles of C (+)= coef * op(A) op(B) (+ I), then a block barrier.
template <int OP, int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void cmm(const Own<W>& t, const C2* A, const C2* B, C2* C, R coef,
                                    bool accumulate, bool add_identity) {
  if constexpr (W) {
    for (int q = t.q0; q < t.side * t.side; q += t.qs)
      cmm_tile<OP, TILE>(t, (q / t.side) * TILE, (q % t.side) * TILE, A, B, C, coef, accumulate,
                         add_identity);
  } else {
    cmm_tile<OP, TILE>(t, (t.q0 / t.side) * TILE, (t.q0 % t.side) * TILE, A, B, C, coef,
                       accumulate, add_identity);
  }
  __syncthreads();
}

// Calls f(i, j, at) for every entry of the thread's tiles: at is the entry's
// place in a working matrix.
template <int TILE, bool W, typename F>
__device__ __forceinline__ void for_tile(const Own<W>& t, int q, F f) {
  const int i0 = (q / t.side) * TILE, j0 = (q % t.side) * TILE;
#pragma unroll
  for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      const int i = i0 + ii, j = j0 + jj;
      if (i < t.n && j < t.n) f(i, j, (i * t.n + j) * t.LB + t.lane);
    }
}

template <int TILE, bool W, typename F>
__device__ __forceinline__ void for_own(const Own<W>& t, F f) {
  if constexpr (W) {
    for (int q = t.q0; q < t.side * t.side; q += t.qs) for_tile<TILE>(t, q, f);
  } else {
    for_tile<TILE>(t, t.q0, f);
  }
}

// Starts the copy of the thread's tiles of a matrix of planes (pr, pi) with
// element stride es into M: into shared memory without passing through
// registers, so all of a thread's entries are in flight at once (with 2 or 4
// threads per lane a register-staged load leaves too few bytes in flight);
// into a device-memory M by plain loads and stores. finish_loads() completes
// it for the issuing thread.
template <int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void load_own(const Own<W>& t, const R* pr, const R* pi, int es,
                                         C2* M) {
  const bool shared = !W || __isShared(M);
  for_own<TILE>(t, [&](int i, int j, int at) {
    if (t.live) {
      const long long g = ((long long)(i * t.n + j) * t.L + t.b) * es;
      if (shared) {
        __pipeline_memcpy_async(&M[at].x, pr + g, sizeof(R));
        __pipeline_memcpy_async(&M[at].y, pi + g, sizeof(R));
      } else {
        M[at] = cplx<R>(pr[g], pi[g]);
      }
    } else {
      M[at] = cplx<R>(0, 0);
    }
  });
}

__device__ __forceinline__ void finish_loads() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

template <int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void store_own(const Own<W>& t, const C2* M, R scale, R* pr, R* pi) {
  if (!t.live) return;
  for_own<TILE>(t, [&](int i, int j, int at) {
    const long long g = ((long long)(i * t.n + j) * t.L + t.b) * kOutStride;
    pr[g] = M[at].x * scale;
    pi[g] = M[at].y * scale;
  });
}

// The thread's tile of S = X * scale (in place) and T = S / order + I.
template <int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void horner_start(const Own<W>& t, C2* S, R scale, int order,
                                             C2* T) {
  for_own<TILE>(t, [&](int i, int j, int at) {
    const C2 s = cplx<R>(S[at].x * scale, S[at].y * scale);
    S[at] = s;
    C2 v = cplx<R>(s.x / order, s.y / order);
    if (i == j) v.x += R(1);
    T[at] = v;
  });
}

template <int TILE, bool W, typename C2>
__device__ __forceinline__ void copy_own(const Own<W>& t, const C2* from, C2* to) {
  for_own<TILE>(t, [&](int, int, int at) { to[at] = from[at]; });
}

// The block's `mats` working matrices: in shared memory, or, where a W
// instantiation is given `work`, at the block's region of it. Narrow
// instantiations address shared memory alone, so the compiler emits shared
// loads and stores (through a generic pointer B6 ran 1.4x and B7 2.1x
// slower at the Magnus row on an H100).
template <bool W, typename C2>
__device__ __forceinline__ C2* working(C2* smem, C2* work, int mats, int mat) {
  if (!W || work == nullptr) return smem;
  return work + (size_t)blockIdx.x * mats * mat;
}

// Runs body(tile) for the block's lane tiles: blockIdx.x alone where the grid
// has a block per tile, every gridDim.x-th from it in W instantiations.
template <bool W, typename F>
__device__ __forceinline__ void for_tiles(long long tiles, F body) {
  if constexpr (W) {
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) body(tile);
  } else {
    body((long long)blockIdx.x);
  }
}

template <int TILE, bool W>
__global__ void matmul_bol_kernel(const float* ar, const float* ai, const float* br,
                                  const float* bi, float* cr, float* ci, int n, long long L,
                                  int LB, int es_a, int es_b, float2* work) {
  extern __shared__ float2 smem[];
  const int mat = n * n * LB;
  float2* base = working<W>(smem, work, 3, mat);
  float2 *A = base, *B = base + mat, *C = base + 2 * mat;
  for_tiles<W>((L + LB - 1) / LB, [&](long long tile) {
    const Own<W> t = own_of<TILE, W>(n, LB, L, tile);
    load_own<TILE>(t, ar, ai, es_a, A);
    load_own<TILE>(t, br, bi, es_b, B);
    finish_loads();
    __syncthreads();
    cmm<kAB, TILE>(t, A, B, C, 1.f, false, false);
    store_own<TILE>(t, C, 1.f, cr, ci);
  });
}

template <int TILE, bool W, typename R>
__global__ void expm_bol_kernel(const R* xr, const R* xi, R* pr, R* pi, int n, long long L,
                                int LB, int order, int squarings, int es,
                                typename Complex<R>::type* work) {
  using C2 = typename Complex<R>::type;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int mat = n * n * LB;
  C2* base = working<W>(reinterpret_cast<C2*>(smem_bytes), work, 3, mat);
  for_tiles<W>((L + LB - 1) / LB, [&](long long tile) {
    C2 *S = base, *T = base + mat, *U = base + 2 * mat;
    const Own<W> t = own_of<TILE, W>(n, LB, L, tile);
    load_own<TILE>(t, xr, xi, es, S);
    finish_loads();
    horner_start<TILE>(t, S, R(1) / (R)(1 << squarings), order, T);
    __syncthreads();
    for (int k = order - 1; k >= 1; --k) {
      cmm<kAB, TILE>(t, S, T, U, R(1) / k, false, true);
      C2* swap = T; T = U; U = swap;
    }
    for (int q = 0; q < squarings; ++q) {
      cmm<kAB, TILE>(t, T, T, U, R(1), false, false);
      C2* swap = T; T = U; U = swap;
    }
    store_own<TILE>(t, T, R(1), pr, pi);
  });
}

template <int TILE, bool W>
__global__ void expm_bwd_bol_kernel(const float* xr, const float* xi, const float* ctr,
                                    const float* cti, float* gxr, float* gxi, float2* scratch,
                                    int n, long long L, int LB, int order, int squarings,
                                    int es_x, int es_ct, int in_device) {
  extern __shared__ float2 smem[];
  const int mat = n * n * LB;
  const int stages = order - 1 + squarings;
  const int mats = in_device ? kBwdMats : 0;
  float2* stage = scratch + (size_t)blockIdx.x * (stages + mats) * mat;
  float2* base = W && in_device ? stage + (size_t)stages * mat : smem;
  float2 *S = base, *G = base + mat, *U = base + 2 * mat, *Y = base + 3 * mat,
         *GX = base + 4 * mat;
  const float scale = 1.f / (float)(1 << squarings);
  const long long tiles = (L + LB - 1) / LB;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Own<W> t = own_of<TILE, W>(n, LB, L, tile);

    // forward recompute, keeping every stage operand
    load_own<TILE>(t, xr, xi, es_x, S);
    finish_loads();
    horner_start<TILE>(t, S, scale, order, G);
    __syncthreads();
    int idx = 0;
    for (int k = order - 1; k >= 1; --k, ++idx) {
      copy_own<TILE>(t, G, stage + (size_t)idx * mat);
      cmm<kAB, TILE>(t, S, G, U, 1.f / k, false, true);
      float2* swap = G; G = U; U = swap;
    }
    for (int q = 0; q < squarings; ++q, ++idx) {
      copy_own<TILE>(t, G, stage + (size_t)idx * mat);
      cmm<kAB, TILE>(t, G, G, U, 1.f, false, false);
      float2* swap = G; G = U; U = swap;
    }

    // reverse sweep: g <- cotangent of the output
    load_own<TILE>(t, ctr, cti, es_ct, G);
    for_own<TILE>(t, [&](int, int, int at) { GX[at] = make_float2(0.f, 0.f); });
    finish_loads();
    for (int q = 0; q < squarings; ++q) {
      --idx;
      copy_own<TILE>(t, stage + (size_t)idx * mat, Y);
      __syncthreads();
      cmm<kAhB, TILE>(t, Y, G, U, 1.f, false, false);  // w  = y^H g
      cmm<kABh, TILE>(t, G, Y, U, 1.f, true, false);   // w += g y^H
      float2* swap = G; G = U; U = swap;
    }
    for (int k = 1; k < order; ++k) {
      --idx;
      copy_own<TILE>(t, stage + (size_t)idx * mat, Y);
      __syncthreads();
      cmm<kABh, TILE>(t, G, Y, GX, 1.f / k, true, false);  // sbar += g t^H / k
      cmm<kAhB, TILE>(t, S, G, U, 1.f / k, false, false);  // g <- s^H g / k
      float2* swap = G; G = U; U = swap;
    }
    // the top of the recursion, t_p = s / p + I, and the scaling of X
    for_own<TILE>(t, [&](int, int, int at) {
      GX[at].x += G[at].x / order;
      GX[at].y += G[at].y / order;
    });
    store_own<TILE>(t, GX, scale, gxr, gxi);
    __syncthreads();  // the next tile overwrites S, G and GX
  }
}

// The register tile: 5 where it divides n (no ragged tiles at n = 10), else 4.
int tile_of(int n) { return n % 5 == 0 ? 5 : 4; }

int threads_per_lane(int n) {
  const int per_side = (n + tile_of(n) - 1) / tile_of(n);
  return per_side * per_side < kLaneThreads ? per_side * per_side : kLaneThreads;
}

size_t shared_bytes(int n, int mats, int lb, size_t entry) {
  return (size_t)mats * n * n * lb * entry;
}

// Lanes per block: the largest power of two up to 32 whose `mats` matrices of
// `entry`-byte complex entries fit the shared-memory target and whose threads
// fit a block.
int lanes_per_block(int n, int mats, size_t entry) {
  int lb = 32;
  while (lb > 1 && (shared_bytes(n, mats, lb, entry) > kSharedTarget ||
                    threads_per_lane(n) * lb > kMaxThreads))
    lb /= 2;
  return lb;
}

enum Kind { kMatmul = 0, kExpm = 1, kBwd = 2 };

// A launch: lanes per block, threads, blocks, dynamic shared memory, whether
// the working matrices are in device memory (one lane per block), and whether
// it takes the W instantiation (threads loop over tiles and lane tiles).
struct Shape {
  int lb, threads, blocks;
  size_t smem;
  bool in_device, wide;
};

// The launch of `kind` on L lanes of n x n matrices with `entry`-byte complex
// entries; blocks = 0 where the shape is refused or the card cannot be asked.
Shape shape_of(int kind, int n, int L, size_t entry) {
  Shape sh{1, 0, 0, 0, false, false};
  if (n < 1 || n > kMaxN || L < 1) return sh;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return sh;
  const int mats = kind == kBwd ? kBwdMats : 3;
  if (shared_bytes(n, mats, 1, entry) <= kSharedLimit) {
    sh.lb = lanes_per_block(n, mats, entry);
    sh.threads = threads_per_lane(n) * sh.lb;
    sh.smem = shared_bytes(n, mats, sh.lb, entry);
    const long long tiles = ((long long)L + sh.lb - 1) / sh.lb;
    long long blocks = tiles;
    if (kind == kBwd) {  // persistent: as many as are resident at once
      size_t per_sm = kSharedLimit / (sh.smem + 1024);
      per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
      const long long resident = (long long)sms * (long long)per_sm;
      blocks = tiles < resident ? tiles : resident;
    }
    sh.blocks = (int)blocks;
  } else {
    sh.threads = threads_per_lane(n);
    sh.blocks = L < sms ? L : sms;
    sh.in_device = true;
  }
  const int side = (n + tile_of(n) - 1) / tile_of(n);
  sh.wide = sh.in_device || side * side > kLaneThreads;
  return sh;
}

// Bytes of the work buffer of a launch: per block, the working matrices where
// they are in device memory, and the backward's p - 1 + q stage operands.
long long work_bytes(int kind, int n, int L, int order, int squarings, size_t entry) {
  const Shape sh = shape_of(kind, n, L, entry);
  const long long mats = (sh.in_device ? (kind == kBwd ? kBwdMats : 3) : 0) +
                         (kind == kBwd ? order - 1 + squarings : 0);
  const long long bytes = (long long)sh.blocks * mats * n * n * sh.lb * (long long)entry;
  return kind == kBwd && bytes < 16 ? 16 : bytes;  // the backward always takes a buffer
}

// Launches `kernel` at the shape `sh` on `stream`.
template <typename... Params, typename... Args>
cudaError_t run(void (*kernel)(Params...), const Shape& sh, cudaStream_t stream, Args... args) {
  if (sh.smem > kSharedLimit) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  kernel<<<sh.blocks, sh.threads, sh.smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int TILE>
cudaError_t launch_matmul(const float* ar, const float* ai, const float* br, const float* bi,
                          float* cr, float* ci, int n, int L, int es_a, int es_b, void* work,
                          cudaStream_t stream) {
  const Shape sh = shape_of(kMatmul, n, L, sizeof(float2));
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return cudaErrorInvalidValue;
  auto kernel = sh.wide ? matmul_bol_kernel<TILE, true> : matmul_bol_kernel<TILE, false>;
  return run(kernel, sh, stream, ar, ai, br, bi, cr, ci, n, (long long)L, sh.lb, es_a, es_b,
             sh.in_device ? (float2*)work : (float2*)nullptr);
}

template <int TILE, typename R>
cudaError_t launch_expm(const void* xr, const void* xi, void* pr, void* pi, int n, int L,
                        int order, int squarings, int es, void* work, cudaStream_t stream) {
  using C2 = typename Complex<R>::type;
  const Shape sh = shape_of(kExpm, n, L, sizeof(C2));
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return cudaErrorInvalidValue;
  auto kernel = sh.wide ? expm_bol_kernel<TILE, true, R> : expm_bol_kernel<TILE, false, R>;
  return run(kernel, sh, stream, (const R*)xr, (const R*)xi, (R*)pr, (R*)pi, n, (long long)L,
             sh.lb, order, squarings, es, sh.in_device ? (C2*)work : (C2*)nullptr);
}

template <int TILE>
cudaError_t launch_expm_bwd(const float* xr, const float* xi, const float* ctr, const float* cti,
                            float* gxr, float* gxi, void* work, int n, int L, int order,
                            int squarings, int es_x, int es_ct, cudaStream_t stream) {
  const Shape sh = shape_of(kBwd, n, L, sizeof(float2));
  if (sh.blocks < 1 || work == nullptr) return cudaErrorInvalidValue;
  auto kernel = sh.wide ? expm_bwd_bol_kernel<TILE, true> : expm_bwd_bol_kernel<TILE, false>;
  return run(kernel, sh, stream, xr, xi, ctr, cti, gxr, gxi, (float2*)work, n, (long long)L,
             sh.lb, order, squarings, es_x, es_ct, (int)sh.in_device);
}

bool bad_expm(int order, int squarings) { return order < 1 || squarings < 0 || squarings > 30; }

}  // namespace

extern "C" {

// Bytes of the device work buffer a launch of `kind` (0 product, 1 expm, 2
// backward) needs: 0 where it needs none, -1 for a shape it refuses.
long long batched_linalg_work_bytes(int kind, int n, int L, int order, int squarings,
                                    int double_precision) {
  if (kind < kMatmul || kind > kBwd || (kind != kMatmul && bad_expm(order, squarings)) ||
      shape_of(kind, n, L, double_precision ? sizeof(double2) : sizeof(float2)).blocks < 1)
    return -1;
  return work_bytes(kind, n, L, order, squarings,
                    double_precision ? sizeof(double2) : sizeof(float2));
}

int matmul_bol_launch(const void* ar, const void* ai, const void* br, const void* bi, void* cr,
                      void* ci, int n, int L, int es_a, int es_b, void* work, void* stream) {
  auto launch = tile_of(n) == 5 ? launch_matmul<5> : launch_matmul<4>;
  return (int)launch((const float*)ar, (const float*)ai, (const float*)br, (const float*)bi,
                     (float*)cr, (float*)ci, n, L, es_a, es_b, work, (cudaStream_t)stream);
}

// double_precision = 0: float32 planes and a complex64 output; 1: float64 and
// complex128.
int expm_bol_launch(const void* xr, const void* xi, void* pr, void* pi, int n, int L, int order,
                    int squarings, int es, int double_precision, void* work, void* stream) {
  if (bad_expm(order, squarings)) return (int)cudaErrorInvalidValue;
  auto launch = double_precision ? (tile_of(n) == 5 ? launch_expm<5, double>
                                                    : launch_expm<4, double>)
                                 : (tile_of(n) == 5 ? launch_expm<5, float>
                                                    : launch_expm<4, float>);
  return (int)launch(xr, xi, pr, pi, n, L, order, squarings, es, work, (cudaStream_t)stream);
}

int expm_bwd_bol_launch(const void* xr, const void* xi, const void* ctr, const void* cti,
                        void* gxr, void* gxi, void* work, int n, int L, int order,
                        int squarings, int es_x, int es_ct, void* stream) {
  if (bad_expm(order, squarings)) return (int)cudaErrorInvalidValue;
  auto launch = tile_of(n) == 5 ? launch_expm_bwd<5> : launch_expm_bwd<4>;
  return (int)launch((const float*)xr, (const float*)xi, (const float*)ctr, (const float*)cti,
                     (float*)gxr, (float*)gxi, work, n, L, order, squarings, es_x, es_ct,
                     (cudaStream_t)stream);
}

const char* batched_linalg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
