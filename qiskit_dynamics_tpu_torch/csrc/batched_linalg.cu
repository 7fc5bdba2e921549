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
// - expm kernels:       s = X 2^-q; t = I + s/p; t <- I + (s t)/k for
//                       k = p-1..1; t <- t t, q times; P = t.
// - backward kernels:   the vector-Jacobian product of that recursion with
//   cotangent G = CTr + i CTi. The recursion is a polynomial in X with real
//   coefficients, so its VJP is its Frechet derivative at X^H in the
//   direction G, run forward as a pair (t, dt) from s = X^H 2^-q and
//   E = G 2^-q: t = I + s/p, dt = E/p; per Horner stage
//   (t, dt) <- (I + s t/k, (E t + s dt)/k) (the old t in both); per squaring
//   (t, dt) <- (t t, t dt + dt t); the result is dt. Nothing is stored for a
//   reverse pass.
//
// What bounds them on this card. expm and its backward are operation-bound:
// (p - 1 + q) and (3(p - 1) + 3q) products of 8 n^3 float32 operations per lane
// against 16 n^2 and 24 n^2 bytes of traffic (at n = 10, p = 12, q = 1: 96 and
// 288 kFLOP against 1.6 and 2.4 kB). matmul alone is byte-bound (8 n^3 against
// 24 n^2 bytes). What keeps a product held in shared memory from the FMA
// rate is the shared-memory traffic and the barriers between products.
//
// Lane kernels (expm and backward, n <= 16: the Magnus rows' n = 10). One
// thread owns one column j of its lane's t (and dt) in registers, for the
// whole recursion: a Horner stage multiplies t from the left by the
// lane-constant s (and E), so column j of the new t needs column j of the old
// one alone. A stage therefore exchanges nothing and needs no barrier; only a
// squaring writes t (and dt) to shared memory and reads it back, between two
// __syncwarp. A lane's n threads sit in one warp (32 / n lanes per warp, 3 at
// n = 10, the last 32 % n threads idle). The constant factors live in shared
// memory once per lane, row-major (s transposed at the copy-in for the
// backward, conjugated in the multiply-adds), padded with zeros to an even
// NP x NP (n rounded up; the pad stays zero through the recursion), and are
// read as broadcasts: all threads of a lane load the same 16 bytes (two
// complex64 entries or one complex128), consecutive lanes 16 bytes apart
// modulo the 128 bytes of the banks (lane_stride), so a load of the warp is
// one conflict-free wavefront serving 8 multiply-adds a thread (16 in the
// backward, whose two factors s and E share the loop over m). A block of
// eight warps takes up to kLaneRounds rounds of 8 (32 / n) lanes (72 lanes at
// n = 10: as many as shared memory holds beside the blocks its registers
// allow), so each plane is read and written in long runs of consecutive
// lanes: one round per block ran B6 at the Magnus row 1.10x slower than
// three (6.33 against 5.73 ms on an H100). The block copies its lanes in with
// 16-byte loads (four lanes of a plane each), scattered to the lane planes,
// and writes them out from the planes, a warp per entry; these are its only
// two block barriers. Each instantiation's registers are capped at what its
// columns need plus a margin (lane_min_blocks), so 16-24 warps stay resident
// per SM at n = 10.
//
// Tiled kernels (the product at every n, the expm and backward above n = 16).
// One block owns LB lanes (a power of two up to 32, the largest whose
// matrices fit about half an SM's shared memory, so two blocks share an SM;
// in FP64 each matrix takes twice the bytes, so a block holds half the lanes;
// from n ~ 40 one lane's matrices pass half an SM and a block holds one lane,
// up to the whole 227 KB: n = 98 for the product and the expm, 69 for the
// backward's six matrices and the FP64 expm).
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
// where it divides n, else 4; ragged tiles clamp their loads and mask their
// stores). The product routine cmm: per m the thread loads TILE entries of
// A and TILE of B and does TILE^2 complex multiply-adds in
// registers, 2/TILE loads per multiply-add instead of 2, summing over m in
// order (the first version of this file formed one entry at a time: 14.4 ms
// for expm at 2,048,000 lanes of n = 10 against a 2.9 ms bound). The
// backward's pair_tile forms both sums of a stage in one pass over m. Every
// elementwise pass touches only the thread's own tile, so it needs no
// barrier. Stages alternate between two buffers instead of copying the
// product back. Ragged last lane tiles are masked (dead lanes compute on
// zeros and store nothing).
//
// FP64 (expm only). The same code in double, with the same mapping: twice the
// registers and shared memory per entry. Bound: operations, all of them
// matrix products, against the 67 TFLOP/s of the FP64 tensor cores (34 on
// the FP64 FMA pipes, where these kernels run them).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Up to n = 98 one lane's three complex64 matrices fit a block's 227 KB of
// shared memory (69 for the backward's six, 69 for three complex128 ones);
// above, they go to device memory, up to n = 256.
constexpr int kMaxN = 256;
constexpr int kMaxThreads = 1024;
// Threads per lane at most (one per tile below; above, each loops over several
// tiles): 256 threads of up to 255 registers fill an SM's register file.
constexpr int kLaneThreads = 256;
constexpr size_t kSharedTarget = 110 * 1024;  // two blocks of this size share an SM
constexpr size_t kSharedLimit = 232448;       // dynamic shared memory a block may use
constexpr int kOutStride = 2;                 // outputs are views of a complex64 tensor
constexpr int kBwdMats = 6;                   // working matrices of the tiled backward
constexpr int kLaneMaxN = 16;                 // the lane kernels take n up to this
constexpr int kLaneWarps = 8;                 // warps per block of a lane kernel
// Registers a lane kernel's thread keeps beside its columns, for shared loads
// in flight and addresses.
constexpr int kLaneSpare = 40;
// Rounds of lane groups a lane-kernel block takes at most (its warps hold
// 32 / n lanes each per round): more lanes per block read longer runs of each
// plane.
constexpr int kLaneRounds = 3;
constexpr size_t kSharedPerSM = 233472;  // an SM's shared memory
// 16-byte loads a lane kernel's thread keeps in flight while it copies its
// block's lanes in (nothing else holds registers yet).
constexpr int kLaneLoads = 8;

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

// acc += op(a) v, op(a) = conj(a) where CJ: four fused multiply-adds (written
// out: "acc += p - q" would cost a multiply, a fused multiply-add and an add).
template <bool CJ, typename C2>
__device__ __forceinline__ void cmac(C2& acc, C2 a, C2 v) {
  acc.x = fma_r(a.x, v.x, acc.x);
  acc.x = fma_r(CJ ? a.y : -a.y, v.y, acc.x);
  acc.y = fma_r(a.x, v.y, acc.y);
  acc.y = fma_r(CJ ? -a.y : a.y, v.x, acc.y);
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

// One tile of C = coef * A B (+ I), rows i0.. and columns j0..; C is neither
// A nor B.
template <int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void cmm_tile(const Own<W>& t, int i0, int j0,
                                         const C2* __restrict__ A, const C2* __restrict__ B,
                                         C2* __restrict__ C, R coef, bool add_identity) {
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
      a[k] = A[(rows[k] * n + m) * LB + t.lane];
      b[k] = B[(m * n + cols[k]) * LB + t.lane];
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
        if (add_identity && i == j) c.x += R(1);
        C[(i * n + j) * LB + t.lane] = c;
      }
    }
}

// The thread's tiles of C = coef * A B (+ I), then a block barrier.
template <int TILE, bool W, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void cmm(const Own<W>& t, const C2* A, const C2* B, C2* C, R coef,
                                    bool add_identity) {
  if constexpr (W) {
    for (int q = t.q0; q < t.side * t.side; q += t.qs)
      cmm_tile<TILE>(t, (q / t.side) * TILE, (q % t.side) * TILE, A, B, C, coef, add_identity);
  } else {
    cmm_tile<TILE>(t, (t.q0 / t.side) * TILE, (t.q0 % t.side) * TILE, A, B, C, coef,
                   add_identity);
  }
  __syncthreads();
}

// One tile of (T2, D2) = (c A T (+ I), c (A D + B T)), rows i0.. and columns
// j0..; A is read as its conjugate transpose where AH. One pass over m feeds
// both sums: 4 TILE loads for 3 TILE^2 complex multiply-adds.
template <bool AH, int TILE, bool W>
__device__ __forceinline__ void pair_tile(const Own<W>& t, int i0, int j0,
                                          const float2* __restrict__ A,
                                          const float2* __restrict__ B,
                                          const float2* __restrict__ T,
                                          const float2* __restrict__ D, float2* __restrict__ T2,
                                          float2* __restrict__ D2, float c, bool add_identity) {
  const int n = t.n, LB = t.LB, last = t.n - 1;
  float2 at[TILE][TILE], ad[TILE][TILE];
#pragma unroll
  for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) at[ii][jj] = ad[ii][jj] = make_float2(0.f, 0.f);
  int rows[TILE], cols[TILE];
#pragma unroll
  for (int k = 0; k < TILE; ++k) {
    rows[k] = min(i0 + k, last);
    cols[k] = min(j0 + k, last);
  }
  for (int m = 0; m < n; ++m) {
    float2 a[TILE], b[TILE], x[TILE], y[TILE];
#pragma unroll
    for (int k = 0; k < TILE; ++k) {
      a[k] = AH ? A[(m * n + rows[k]) * LB + t.lane] : A[(rows[k] * n + m) * LB + t.lane];
      b[k] = B[(rows[k] * n + m) * LB + t.lane];
      x[k] = T[(m * n + cols[k]) * LB + t.lane];
      y[k] = D[(m * n + cols[k]) * LB + t.lane];
    }
#pragma unroll
    for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        cmac<AH>(at[ii][jj], a[ii], x[jj]);
        cmac<AH>(ad[ii][jj], a[ii], y[jj]);
        cmac<false>(ad[ii][jj], b[ii], x[jj]);
      }
  }
#pragma unroll
  for (int ii = 0; ii < TILE; ++ii)
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      const int i = i0 + ii, j = j0 + jj;
      if (i < n && j < n) {
        const int to = (i * n + j) * LB + t.lane;
        T2[to] = make_float2(at[ii][jj].x * c + (add_identity && i == j ? 1.f : 0.f),
                             at[ii][jj].y * c);
        D2[to] = make_float2(ad[ii][jj].x * c, ad[ii][jj].y * c);
      }
    }
}

// The thread's tiles of pair_tile, then a block barrier.
template <bool AH, int TILE, bool W>
__device__ __forceinline__ void pair(const Own<W>& t, const float2* A, const float2* B,
                                     const float2* T, const float2* D, float2* T2, float2* D2,
                                     float c, bool add_identity) {
  if constexpr (W) {
    for (int q = t.q0; q < t.side * t.side; q += t.qs)
      pair_tile<AH, TILE>(t, (q / t.side) * TILE, (q % t.side) * TILE, A, B, T, D, T2, D2, c,
                          add_identity);
  } else {
    pair_tile<AH, TILE>(t, (t.q0 / t.side) * TILE, (t.q0 % t.side) * TILE, A, B, T, D, T2, D2,
                        c, add_identity);
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
    cmm<TILE>(t, A, B, C, 1.f, false);
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
      cmm<TILE>(t, S, T, U, R(1) / k, true);
      C2* swap = T; T = U; U = swap;
    }
    for (int q = 0; q < squarings; ++q) {
      cmm<TILE>(t, T, T, U, R(1), false);
      C2* swap = T; T = U; U = swap;
    }
    store_own<TILE>(t, T, R(1), pr, pi);
  });
}

// The tiled backward: six working matrices, X and G as loaded (X read as X^H
// in place) and two buffers each for t and dt.
template <int TILE, bool W>
__global__ void expm_bwd_bol_kernel(const float* xr, const float* xi, const float* ctr,
                                    const float* cti, float* gxr, float* gxi, float2* work, int n,
                                    long long L, int LB, int order, int squarings, int es_x,
                                    int es_ct) {
  extern __shared__ float2 smem[];
  const int mat = n * n * LB;
  float2* base = working<W>(smem, work, kBwdMats, mat);
  const float scale = 1.f / (float)(1 << squarings);
  for_tiles<W>((L + LB - 1) / LB, [&](long long tile) {
    float2 *S = base, *E = base + mat, *T = base + 2 * mat, *D = base + 3 * mat,
           *T2 = base + 4 * mat, *D2 = base + 5 * mat;
    const Own<W> t = own_of<TILE, W>(n, LB, L, tile);
    load_own<TILE>(t, xr, xi, es_x, S);
    load_own<TILE>(t, ctr, cti, es_ct, E);
    finish_loads();
    __syncthreads();
    // t = I + s / p and dt = E / p, with s = X^H 2^-q and E = G 2^-q
    const float c0 = scale / order;
    for_own<TILE>(t, [&](int i, int j, int at) {
      const float2 x = S[(j * n + i) * LB + t.lane];
      T[at] = make_float2(x.x * c0 + (i == j ? 1.f : 0.f), -x.y * c0);
      D[at] = make_float2(E[at].x * c0, E[at].y * c0);
    });
    __syncthreads();
    for (int k = order - 1; k >= 1; --k) {
      pair<true, TILE>(t, S, E, T, D, T2, D2, scale / k, true);
      float2* swap = T; T = T2; T2 = swap;
      swap = D; D = D2; D2 = swap;
    }
    for (int q = 0; q < squarings; ++q) {
      pair<false, TILE>(t, T, D, T, D, T2, D2, 1.f, false);
      float2* swap = T; T = T2; T2 = swap;
      swap = D; D = D2; D2 = swap;
    }
    store_own<TILE>(t, D, 1.f, gxr, gxi);
    __syncthreads();  // the next tile overwrites S and E
  });
}

// --------------------------------------------------------------------------
// lane kernels: n <= kLaneMaxN, a thread per column, a lane per n threads of
// one warp
// --------------------------------------------------------------------------

// Complex entries between consecutive lanes' planes: NP x NP, padded so that
// the planes start 16 bytes apart modulo the 128 bytes of the 32 banks.
__host__ __device__ constexpr int lane_stride(int np, int entry) {
  return np * np + (((16 / entry - (np * np) % (128 / entry)) % (128 / entry)) + 128 / entry) %
                       (128 / entry);
}

// What a thread of a lane kernel owns in round `round`: column j of lane
// `lane` of the block (global lane b); the last 32 % n threads of a warp are
// idle. mask: the warp's working threads.
struct LaneOwn {
  int lane, j;
  long long b;
  bool active;
  unsigned mask;
};

__device__ __forceinline__ LaneOwn lane_own(int n, int LB, long long tile, int round) {
  const int per_warp = 32 / n, r = threadIdx.x % 32, local = r / n, used = per_warp * n;
  LaneOwn o;
  o.active = local < per_warp;
  o.j = r % n;
  o.lane = (round * (int)(blockDim.x / 32) + (int)(threadIdx.x / 32)) * per_warp + local;
  o.b = tile * LB + o.lane;
  o.mask = used == 32 ? 0xffffffffu : (1u << used) - 1u;
  return o;
}

// Blocks of a lane kernel an SM can hold by registers, for a thread that keeps
// `columns` columns of NP complex entries of `words` 32-bit words each: the
// compiler is held to that budget (left alone, it hoists the unrolled shared
// loads into 255 registers and spills).
constexpr int lane_min_blocks(int np, int words, int columns) {
  return 65536 / (kLaneWarps * 32 * (np * words * columns + kLaneSpare)) > 1
             ? 65536 / (kLaneWarps * 32 * (np * words * columns + kLaneSpare))
             : 1;
}

// 16-byte vectors of a plane: four float32 lanes or two float64 ones.
template <typename R> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int K = 4;
  __device__ static __forceinline__ float at(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int K = 2;
  __device__ static __forceinline__ double at(const double2& v, int k) { return k == 0 ? v.x : v.y; }
};

// Copies lane tile `tile` (LB lanes) of a complex matrix given as planes (pr,
// pi), element stride es, into lane planes M (stride LS; NP x NP row-major,
// transposed where TR; zeros in the pad and for dead lanes). Contiguous
// planes whose lanes fall in whole 16-byte vectors are read one vector (4
// float32 lanes) per load, each thread's loads in flight together, and
// scattered to the lanes' planes; other planes one value per cp.async. The
// copy is complete for the block after finish_loads() and a block barrier.
template <int NP, bool TR, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void lane_load(const R* pr, const R* pi, int es, C2* M, int LS, int n,
                                          long long L, int LB, long long tile) {
  using V = Vec<R>;
  constexpr int K = V::K, U = kLaneLoads;  // lanes per vector, loads in flight per thread
  const long long first = tile * LB;
  const bool vectors = es == 1 && L % K == 0 && LB % K == 0 &&
                       ((reinterpret_cast<uintptr_t>(pr) | reinterpret_cast<uintptr_t>(pi)) % 16) == 0;
  if (vectors) {
    const int per_plane = LB / K, items = 2 * n * n * per_plane;  // (entry, plane, vector)
    for (int base = threadIdx.x; base < items; base += U * blockDim.x) {
      typename V::type v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int item = base + u * blockDim.x, q = item % per_plane, e = item / per_plane / 2;
        const long long lane = first + (long long)q * K;
        if (item < items && lane < L) {
          const R* plane = (item / per_plane) % 2 ? pi : pr;
          v[u] = *reinterpret_cast<const typename V::type*>(plane + (long long)e * L + lane);
        } else {
          v[u] = typename V::type{};
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int item = base + u * blockDim.x, q = item % per_plane, e = item / per_plane / 2;
        if (item >= items) break;
        const int r = e / n, c = e % n, at = TR ? c * NP + r : r * NP + c;
        R* to = reinterpret_cast<R*>(M + q * K * LS + at) + (item / per_plane) % 2;
#pragma unroll
        for (int k = 0; k < K; ++k) to[2 * k * LS] = V::at(v[u], k);
      }
    }
    if (n < NP)  // the pad: row and column n
      for (int idx = threadIdx.x; idx < (2 * NP - 1) * LB; idx += blockDim.x) {
        const int l = idx % LB, p = idx / LB;
        M[l * LS + (p < NP ? p * NP + n : n * NP + (p - NP))] = cplx<R>(0, 0);
      }
    return;
  }
  for (int e = threadIdx.x / 32; e < NP * NP; e += blockDim.x / 32) {
    const int r = e / NP, c = e % NP;
    for (int l = threadIdx.x % 32; l < LB; l += 32) {
      C2* to = M + l * LS + (TR ? c * NP + r : e);
      if (r < n && c < n && first + l < L) {
        const long long g = ((long long)(r * n + c) * L + first + l) * es;
        __pipeline_memcpy_async(&to->x, pr + g, sizeof(R));
        __pipeline_memcpy_async(&to->y, pi + g, sizeof(R));
      } else {
        *to = cplx<R>(0, 0);
      }
    }
  }
}

// The entries A[u], u < K, of a lane plane's row in one 16-byte shared load:
// two complex64 entries, or one complex128.
template <typename C2> struct Pack;
template <> struct Pack<float2> {
  static constexpr int K = 2;
  __device__ static __forceinline__ void load(const float2* A, float2 (&a)[2]) {
    const float4 v = *reinterpret_cast<const float4*>(A);
    a[0] = make_float2(v.x, v.y);
    a[1] = make_float2(v.z, v.w);
  }
};
template <> struct Pack<double2> {
  static constexpr int K = 1;
  __device__ static __forceinline__ void load(const double2* A, double2 (&a)[1]) { a[0] = *A; }
};

// acc[i] = sum_m op(A[i][m]) v[m] for a lane plane A (row-major NP x NP;
// op = conj where CJ) and a column v in registers. The loop over m is the
// outer one, so the NP sums advance side by side.
template <int NP, bool CJ, typename C2>
__device__ __forceinline__ void lane_mv(const C2* A, const C2 (&v)[NP], C2 (&acc)[NP]) {
  constexpr int K = Pack<C2>::K;
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i].x = acc[i].y = 0;
#pragma unroll
  for (int m = 0; m < NP; m += K)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      C2 a[K];
      Pack<C2>::load(A + i * NP + m, a);
#pragma unroll
      for (int u = 0; u < K; ++u) cmac<CJ>(acc[i], a[u], v[m + u]);
    }
}

// at[i] = sum_m op(A[i][m]) v[m] and ad[i] = sum_m op(A[i][m]) dv[m] + B[i][m]
// v[m], one pass over m.
template <int NP, bool CJ, typename C2>
__device__ __forceinline__ void lane_mv2(const C2* A, const C2* B, const C2 (&v)[NP],
                                         const C2 (&dv)[NP], C2 (&at)[NP], C2 (&ad)[NP]) {
  constexpr int K = Pack<C2>::K;
#pragma unroll
  for (int i = 0; i < NP; ++i) at[i].x = at[i].y = ad[i].x = ad[i].y = 0;
#pragma unroll
  for (int m = 0; m < NP; m += K)
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      C2 a[K], b[K];
      Pack<C2>::load(A + i * NP + m, a);
      Pack<C2>::load(B + i * NP + m, b);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        cmac<CJ>(at[i], a[u], v[m + u]);
        cmac<CJ>(ad[i], a[u], dv[m + u]);
        cmac<false>(ad[i], b[u], v[m + u]);
      }
    }
}

// Nothing writes the lane planes during the Horner stages, so the compiler
// would hoist all of their NP^2 shared loads out of the stage loop and hold s
// in registers (255 of them and a spill at n = 10, 8 warps per SM); a memory
// clobber at the top of each stage keeps the loads in it.
__device__ __forceinline__ void keep_loads_in_stage() { asm volatile("" ::: "memory"); }

// Writes the block's LB lanes from their planes (row-major NP x NP, stride LS)
// to the output tensor, whose real plane pr starts an interleaved complex
// tensor: a warp takes one entry at a time and stores its LB consecutive
// lanes, 8 or 16 bytes each, in one instruction (a thread storing its own
// column would touch n lines per instruction).
template <int NP, typename R, typename C2 = typename Complex<R>::type>
__device__ __forceinline__ void lane_store(const C2* planes, int LS, R* pr, int n, long long L,
                                           int LB) {
  C2* out = reinterpret_cast<C2*>(pr);
  const long long first = (long long)blockIdx.x * LB;
  for (int e = threadIdx.x / 32; e < n * n; e += blockDim.x / 32) {
    const int at = (e / n) * NP + e % n;
    for (int l = threadIdx.x % 32; l < LB && first + l < L; l += 32)
      out[(long long)e * L + first + l] = planes[l * LS + at];
  }
}

template <int NP, typename R>
__global__ void __launch_bounds__(kLaneWarps * 32, lane_min_blocks(NP, 2 * sizeof(R) / 4, 2))
    expm_lane_kernel(const R* xr, const R* xi, R* pr, R* pi, int n, long long L, int LB,
                     int order, int squarings, int es, typename Complex<R>::type*) {
  using C2 = typename Complex<R>::type;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int LS = lane_stride(NP, sizeof(C2));
  C2* planes = reinterpret_cast<C2*>(smem_bytes);
  lane_load<NP, false>(xr, xi, es, planes, LS, n, L, LB, blockIdx.x);
  finish_loads();
  __syncthreads();
  const int rounds = LB / (blockDim.x / 32 * (32 / n));
  for (int round = 0; round < rounds; ++round) {
    const LaneOwn o = lane_own(n, LB, blockIdx.x, round);
    if (!o.active) break;
    C2* S = planes + o.lane * LS;  // s = X 2^-q, the scale kept in the coefficients
    const R scale = R(1) / (R)(1 << squarings);
    C2 t[NP], acc[NP];
    const R c0 = scale / order;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const C2 x = S[i * NP + o.j];
      t[i] = cplx<R>(x.x * c0 + (i == o.j ? R(1) : R(0)), x.y * c0);
    }
    for (int k = order - 1; k >= 1; --k) {
      keep_loads_in_stage();
      lane_mv<NP, false>(S, t, acc);
      const R c = scale / k;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        t[i] = cplx<R>(acc[i].x * c + (i == o.j ? R(1) : R(0)), acc[i].y * c);
    }
    for (int q = 0; q < squarings; ++q) {
      __syncwarp(o.mask);  // the lane is done reading S
#pragma unroll
      for (int i = 0; i < NP; ++i) S[i * NP + o.j] = t[i];
      __syncwarp(o.mask);
      lane_mv<NP, false>(S, t, acc);
#pragma unroll
      for (int i = 0; i < NP; ++i) t[i] = acc[i];
    }
    __syncwarp(o.mask);
#pragma unroll
    for (int i = 0; i < NP; ++i) S[i * NP + o.j] = t[i];
  }
  __syncthreads();
  lane_store<NP>(planes, LS, pr, n, L, LB);
}

template <int NP>
__global__ void __launch_bounds__(kLaneWarps * 32, lane_min_blocks(NP, 2, 4))
    expm_bwd_lane_kernel(const float* xr, const float* xi, const float* ctr, const float* cti,
                         float* gxr, float* gxi, float2*, int n, long long L, int LB, int order,
                         int squarings, int es_x, int es_ct) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  constexpr int LS = lane_stride(NP, sizeof(float2));
  // per lane: X transposed (read conjugated: s = X^H) and G
  float2* planes = reinterpret_cast<float2*>(smem_bytes);
  lane_load<NP, true>(xr, xi, es_x, planes, LS, n, L, LB, blockIdx.x);
  lane_load<NP, false>(ctr, cti, es_ct, planes + LB * LS, LS, n, L, LB, blockIdx.x);
  finish_loads();
  __syncthreads();
  const int rounds = LB / (blockDim.x / 32 * (32 / n));
  for (int round = 0; round < rounds; ++round) {
    const LaneOwn o = lane_own(n, LB, blockIdx.x, round);
    if (!o.active) break;
    float2* S = planes + o.lane * LS;
    float2* E = S + LB * LS;
    const float scale = 1.f / (float)(1 << squarings);
    float2 t[NP], dt[NP], at[NP], ad[NP];
    const float c0 = scale / order;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float2 x = S[i * NP + o.j], g = E[i * NP + o.j];
      t[i] = make_float2(x.x * c0 + (i == o.j ? 1.f : 0.f), -x.y * c0);
      dt[i] = make_float2(g.x * c0, g.y * c0);
    }
    for (int k = order - 1; k >= 1; --k) {
      keep_loads_in_stage();
      lane_mv2<NP, true>(S, E, t, dt, at, ad);
      const float c = scale / k;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        t[i] = make_float2(at[i].x * c + (i == o.j ? 1.f : 0.f), at[i].y * c);
        dt[i] = make_float2(ad[i].x * c, ad[i].y * c);
      }
    }
    for (int q = 0; q < squarings; ++q) {
      __syncwarp(o.mask);  // the lane is done reading S and E
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        S[i * NP + o.j] = t[i];
        E[i * NP + o.j] = dt[i];
      }
      __syncwarp(o.mask);
      lane_mv2<NP, false>(S, E, t, dt, at, ad);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        t[i] = at[i];
        dt[i] = ad[i];
      }
    }
    __syncwarp(o.mask);
#pragma unroll
    for (int i = 0; i < NP; ++i) S[i * NP + o.j] = dt[i];
  }
  __syncthreads();
  lane_store<NP>(planes, LS, gxr, n, L, LB);
}

// --------------------------------------------------------------------------
// launch shapes
// --------------------------------------------------------------------------

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
// it takes a lane kernel, whether the working matrices are in device memory
// (one lane per block), and whether it takes the W instantiation (threads
// loop over tiles and lane tiles).
struct Shape {
  int lb, threads, blocks;
  size_t smem;
  bool lane, in_device, wide;
};

// The shape `sh` with lb lanes per block (tiled kernels in shared memory).
void set_lanes(Shape& sh, int lb, int n, int L, int mats, size_t entry) {
  sh.lb = lb;
  sh.threads = threads_per_lane(n) * lb;
  sh.smem = shared_bytes(n, mats, lb, entry);
  sh.blocks = (int)(((long long)L + lb - 1) / lb);
}

bool takes_lane_kernel(int kind, int n) { return kind != kMatmul && n <= kLaneMaxN; }

// The launch of `kind` on L lanes of n x n matrices with `entry`-byte complex
// entries; blocks = 0 where the shape is refused or the card cannot be asked.
Shape shape_of(int kind, int n, int L, size_t entry) {
  Shape sh{1, 0, 0, 0, false, false, false};
  if (n < 1 || n > kMaxN || L < 1) return sh;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return sh;
  if (takes_lane_kernel(kind, n)) {
    sh.lane = true;
    sh.lb = kLaneWarps * (32 / n);
    sh.threads = kLaneWarps * 32;
    const int planes = kind == kBwd ? 2 : 1, np = n + (n & 1);
    sh.smem = (size_t)sh.lb * planes * lane_stride(np, (int)entry) * entry;
    sh.blocks = (int)(((long long)L + sh.lb - 1) / sh.lb);
    return sh;
  }
  const int mats = kind == kBwd ? kBwdMats : 3;
  if (shared_bytes(n, mats, 1, entry) <= kSharedLimit) {
    set_lanes(sh, lanes_per_block(n, mats, entry), n, L, mats, entry);
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
// they are in device memory; 0 where they fit shared memory.
long long work_bytes(int kind, int n, int L, size_t entry) {
  const Shape sh = shape_of(kind, n, L, entry);
  if (!sh.in_device) return 0;
  const long long mats = kind == kBwd ? kBwdMats : 3;
  return (long long)sh.blocks * mats * n * n * (long long)entry;
}

template <typename R>
using ExpmKernel = void (*)(const R*, const R*, R*, R*, int, long long, int, int, int, int,
                            typename Complex<R>::type*);
using BwdKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                           float*, float2*, int, long long, int, int, int, int, int);
using MatmulKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                              float*, int, long long, int, int, int, float2*);

// The kernel each launch takes: a lane kernel for the padded size NP = n
// rounded up to even, else the tiled kernel for n's tile, narrow or wide.
template <typename R>
ExpmKernel<R> expm_kernel_for(const Shape& sh, int n) {
  if (sh.lane) {
    const ExpmKernel<R> lanes[] = {expm_lane_kernel<2, R>,  expm_lane_kernel<4, R>,
                                   expm_lane_kernel<6, R>,  expm_lane_kernel<8, R>,
                                   expm_lane_kernel<10, R>, expm_lane_kernel<12, R>,
                                   expm_lane_kernel<14, R>, expm_lane_kernel<16, R>};
    return lanes[(n - 1) / 2];
  }
  if (tile_of(n) == 5) return sh.wide ? expm_bol_kernel<5, true, R> : expm_bol_kernel<5, false, R>;
  return sh.wide ? expm_bol_kernel<4, true, R> : expm_bol_kernel<4, false, R>;
}

BwdKernel bwd_kernel_for(const Shape& sh, int n) {
  if (sh.lane) {
    const BwdKernel lanes[] = {expm_bwd_lane_kernel<2>,  expm_bwd_lane_kernel<4>,
                               expm_bwd_lane_kernel<6>,  expm_bwd_lane_kernel<8>,
                               expm_bwd_lane_kernel<10>, expm_bwd_lane_kernel<12>,
                               expm_bwd_lane_kernel<14>, expm_bwd_lane_kernel<16>};
    return lanes[(n - 1) / 2];
  }
  if (tile_of(n) == 5) return sh.wide ? expm_bwd_bol_kernel<5, true> : expm_bwd_bol_kernel<5, false>;
  return sh.wide ? expm_bwd_bol_kernel<4, true> : expm_bwd_bol_kernel<4, false>;
}

MatmulKernel matmul_kernel_for(const Shape& sh, int n) {
  if (tile_of(n) == 5) return sh.wide ? matmul_bol_kernel<5, true> : matmul_bol_kernel<5, false>;
  return sh.wide ? matmul_bol_kernel<4, true> : matmul_bol_kernel<4, false>;
}

// Allows `kernel` the shape's dynamic shared memory.
template <typename... Params>
cudaError_t allow(void (*kernel)(Params...), const Shape& sh) {
  if (sh.smem > kSharedLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
}

// Launches `kernel` at the shape `sh` on `stream`.
template <typename... Params, typename... Args>
cudaError_t run(void (*kernel)(Params...), const Shape& sh, cudaStream_t stream, Args... args) {
  cudaError_t err = allow(kernel, sh);
  if (err != cudaSuccess) return err;
  kernel<<<sh.blocks, sh.threads, sh.smem, stream>>>(args...);
  return cudaGetLastError();
}

// Blocks of `kernel` resident on one SM at the shape `sh` (0 if refused).
template <typename... Params>
int resident(void (*kernel)(Params...), const Shape& sh) {
  int blocks = 0;
  if (allow(kernel, sh) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, sh.threads, sh.smem) !=
          cudaSuccess)
    return 0;
  return blocks;
}

// A lane kernel's rounds: as many lane groups per block (up to kLaneRounds)
// as the SM's shared memory holds for the blocks its registers allow.
template <typename... Params>
void fill_rounds(Shape& sh, void (*kernel)(Params...), int n, int L) {
  if (!sh.lane) return;
  const size_t per_round = sh.smem;
  const int per_sm = resident(kernel, sh);
  int rounds = 1;
  while (rounds < kLaneRounds && per_sm > 0 &&
         (size_t)per_sm * ((rounds + 1) * per_round + 1024) <= kSharedPerSM)
    ++rounds;
  sh.lb *= rounds;
  sh.smem *= rounds;
  sh.blocks = (int)(((long long)L + sh.lb - 1) / sh.lb);
}

// Halves a tiled launch's lanes per block until its threads fit `kernel`'s
// registers: a block of 400 threads of 168 registers (n = 17) asks for more
// than an SM holds, and the card refuses the launch.
template <typename... Params>
void fit_registers(Shape& sh, void (*kernel)(Params...), int n, int L, int mats, size_t entry) {
  cudaFuncAttributes attr;
  if (sh.lane || sh.in_device || cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return;
  while (sh.lb > 1 && sh.threads > attr.maxThreadsPerBlock)
    set_lanes(sh, sh.lb / 2, n, L, mats, entry);
}

// Each kind's launch and kernel, fitted.
template <typename R>
Shape expm_shape(int n, int L, ExpmKernel<R>* kernel) {
  Shape sh = shape_of(kExpm, n, L, sizeof(typename Complex<R>::type));
  *kernel = expm_kernel_for<R>(sh, n);
  fit_registers(sh, *kernel, n, L, 3, sizeof(typename Complex<R>::type));
  fill_rounds(sh, *kernel, n, L);
  return sh;
}

Shape bwd_shape(int n, int L, BwdKernel* kernel) {
  Shape sh = shape_of(kBwd, n, L, sizeof(float2));
  *kernel = bwd_kernel_for(sh, n);
  fit_registers(sh, *kernel, n, L, kBwdMats, sizeof(float2));
  fill_rounds(sh, *kernel, n, L);
  return sh;
}

Shape matmul_shape(int n, int L, MatmulKernel* kernel) {
  Shape sh = shape_of(kMatmul, n, L, sizeof(float2));
  *kernel = matmul_kernel_for(sh, n);
  fit_registers(sh, *kernel, n, L, 3, sizeof(float2));
  return sh;
}

bool bad_expm(int order, int squarings) { return order < 1 || squarings < 0 || squarings > 30; }

size_t entry_of(int double_precision) {
  return double_precision ? sizeof(double2) : sizeof(float2);
}

template <typename R>
cudaError_t launch_expm(const void* xr, const void* xi, void* pr, void* pi, int n, int L,
                               int order, int squarings, int es, void* work,
                               cudaStream_t stream) {
  using C2 = typename Complex<R>::type;
  ExpmKernel<R> kernel;
  const Shape sh = expm_shape<R>(n, L, &kernel);
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return cudaErrorInvalidValue;
  return run(kernel, sh, stream, (const R*)xr, (const R*)xi, (R*)pr, (R*)pi,
             n, (long long)L, sh.lb, order, squarings, es,
             sh.in_device ? (C2*)work : (C2*)nullptr);
}

}  // namespace

extern "C" {

// Bytes of the device work buffer a launch of `kind` (0 product, 1 expm, 2
// backward) needs: 0 where it needs none, -1 for a shape it refuses.
long long batched_linalg_work_bytes(int kind, int n, int L, int order, int squarings,
                                    int double_precision) {
  if (kind < kMatmul || kind > kBwd || (kind != kMatmul && bad_expm(order, squarings)) ||
      shape_of(kind, n, L, entry_of(double_precision)).blocks < 1)
    return -1;
  return work_bytes(kind, n, L, entry_of(double_precision));
}

// The launch of `kind` on L lanes of n x n matrices: out[] = lanes per block,
// threads per lane, threads, blocks, dynamic shared bytes, lane kernel (0/1),
// matrices in device memory (0/1), wide (0/1), blocks resident per SM.
// Returns 0, or a CUDA error code for a refused shape.
int batched_linalg_shape(int kind, int n, int L, int double_precision, long long* out) {
  if (kind < kMatmul || kind > kBwd || (kind == kBwd && double_precision) ||
      (kind == kMatmul && double_precision))
    return (int)cudaErrorInvalidValue;
  if (shape_of(kind, n, L, entry_of(double_precision)).blocks < 1)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  int per_sm = 0;
  if (kind == kMatmul) {
    MatmulKernel kernel;
    sh = matmul_shape(n, L, &kernel);
    per_sm = resident(kernel, sh);
  } else if (kind == kBwd) {
    BwdKernel kernel;
    sh = bwd_shape(n, L, &kernel);
    per_sm = resident(kernel, sh);
  } else if (double_precision) {
    ExpmKernel<double> kernel;
    sh = expm_shape<double>(n, L, &kernel);
    per_sm = resident(kernel, sh);
  } else {
    ExpmKernel<float> kernel;
    sh = expm_shape<float>(n, L, &kernel);
    per_sm = resident(kernel, sh);
  }
  const long long values[] = {sh.lb,    sh.lane ? n : threads_per_lane(n),
                              sh.threads, sh.blocks,
                              (long long)sh.smem, sh.lane,
                              sh.in_device, sh.wide,
                              per_sm};
  for (int k = 0; k < 9; ++k) out[k] = values[k];
  return 0;
}

int matmul_bol_launch(const void* ar, const void* ai, const void* br, const void* bi, void* cr,
                      void* ci, int n, int L, int es_a, int es_b, void* work, void* stream) {
  MatmulKernel kernel;
  const Shape sh = matmul_shape(n, L, &kernel);
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)run(kernel, sh, (cudaStream_t)stream, (const float*)ar,
                  (const float*)ai, (const float*)br, (const float*)bi, (float*)cr, (float*)ci, n,
                  (long long)L, sh.lb, es_a, es_b, sh.in_device ? (float2*)work : (float2*)nullptr);
}

// double_precision = 0: float32 planes and a complex64 output; 1: float64 and
// complex128. pr and pi are the real and imaginary views of one complex tensor.
int expm_bol_launch(const void* xr, const void* xi, void* pr, void* pi, int n, int L, int order,
                    int squarings, int es, int double_precision, void* work, void* stream) {
  if (bad_expm(order, squarings)) return (int)cudaErrorInvalidValue;
  auto launch = double_precision ? launch_expm<double> : launch_expm<float>;
  return (int)launch(xr, xi, pr, pi, n, L, order, squarings, es, work, (cudaStream_t)stream);
}

// gxr and gxi are the real and imaginary views of one complex64 tensor; work
// may be null where batched_linalg_work_bytes gives 0.
int expm_bwd_bol_launch(const void* xr, const void* xi, const void* ctr, const void* cti,
                        void* gxr, void* gxi, void* work, int n, int L, int order,
                        int squarings, int es_x, int es_ct, void* stream) {
  if (bad_expm(order, squarings)) return (int)cudaErrorInvalidValue;
  BwdKernel kernel;
  const Shape sh = bwd_shape(n, L, &kernel);
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)run(kernel, sh, (cudaStream_t)stream, (const float*)xr,
                  (const float*)xi, (const float*)ctr, (const float*)cti, (float*)gxr,
                  (float*)gxi, sh.in_device ? (float2*)work : (float2*)nullptr, n, (long long)L,
                  sh.lb, order, squarings, es_x, es_ct);
}

const char* batched_linalg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
