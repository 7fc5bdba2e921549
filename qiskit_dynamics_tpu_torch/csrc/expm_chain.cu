// Fused expm-propagator chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/expm_chain_pallas.py::_kernel
// (Pallas, launched by expm_chain_fused). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/expm_chain_pallas.py.
//
// What it computes. For every batch element e and every step t = 0..T-1, from
// the complex64 or complex128 generators G (T, b, n, n) and states y0 (b, n, m):
//   X = G[t, e] * (dt / 2^q)
//   P = the Taylor polynomial of order p >= 6 of exp(X), by Paterson-Stockmeyer:
//       the powers X^1..X^s (s = max(2, isqrt(p))), then Horner in X^s over the
//       blocks B_j = sum_{i < s, s j + i <= p} X^i / (s j + i)!, the top block
//       folded into the first Horner step when it is c I (the same blocks, the
//       same order and the same coefficients as ops/expm.py::expm_taylor);
//   P <- P P, q times;
//   y <- P y.
// At order 12: 2 products for the powers, 3 Horner products, q squarings and
// the apply, each a complex (n, n) x (n, n) or (n, n) x (n, m) product.
//
// What bounds it on this card. Operations: 8 n^3 real operations per complex
// product, 7 per step at order 12 with one squaring (0.94 GFLOP at n = m = 256),
// against 8 n^2 bytes of generator read per step; TF32 stays off. The steps
// of one element are serial; the elements are independent.
//
// Design. The TPU kernel holds an element's whole step in VMEM. On Hopper one
// complex64 (256, 256) matrix is 512 KB, more than a block's 227 KB of shared
// memory, and a step's working set (X..X^s, two polynomial buffers, two states)
// is ~3.5 MB. So a group of blocks walks an element's T steps, and the
// element's matrices live in a per-group scratch in device memory (8 groups x
// 3.5 MB = 28 MB stays in the 50 MB L2). The blocks of a group form a grid of
// output tiles (4 x 4 at 16 blocks, 4 x 2 at 8, ...), and each block computes
// its tile of every product C = A B: it reads its rows of A and its columns
// of B, staging 64 x 32 A tiles and 32 x 64 B tiles through shared memory,
// the next tile loaded into registers while the current one is multiplied;
// each thread forms a 4 x 4 block of C entries with complex fused
// multiply-adds. The scaling and the Horner blocks are elementwise on the
// block's own tile, folded into the product's epilogue. Between dependent
// products the group meets at a barrier in device memory: every thread
// fences its writes, then one thread per block adds to the group's counter
// and spins (acquire loads, with a bounded wait that traps rather than hangs)
// until all blocks of the group have arrived; scratch reads bypass L1
// (ld.global.cg), so every block sees the others' tiles from L2. A software
// barrier needs its blocks resident together, so the kernel is a cooperative
// launch, which the CUDA runtime refuses rather than run if they cannot be. A
// thread-block cluster would give a hardware barrier, but a cluster must fit
// one GPC and the card holds only 7 clusters of 10-16 blocks
// (scripts/cuda_cluster_occupancy.cu), so 8 elements could use 64 SMs at
// most; groups take 128. Each block reserves over half an SM's shared memory,
// so one block runs per SM. The host picks the group size by the work on the
// busiest block (waves of groups times chunks per tile). Groups are
// persistent and walk over the batch elements. Any n and m: ragged tiles are
// masked. The complex128 instantiation is the same code in double (twice the
// shared memory per tile).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 64;  // rows of a product chunk
constexpr int kColChunk = 64;  // columns of a product chunk
constexpr int kDepth = 32;     // k-depth of a staged tile
constexpr int kMaxOrder = 40;
constexpr int kRowsPerThread = 4;  // thread (ty, tx): rows ty + 16 r, columns tx + 16 c
constexpr int kColsPerThread = 4;
constexpr int kALoads = kRowChunk * kDepth / kThreads;  // 8
constexpr int kBLoads = kDepth * kColChunk / kThreads;  // 8

struct Coeffs {
  double c[kMaxOrder + 1];  // c[k] = 1 / k!
};

template <typename R> struct Complex;
template <> struct Complex<float> { using type = float2; };
template <> struct Complex<double> { using type = double2; };

__device__ __forceinline__ float fma_r(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_r(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 ld_l2(const float2* p) { return __ldcg(p); }
__device__ __forceinline__ double2 ld_l2(const double2* p) { return __ldcg(p); }

template <typename R>
__device__ __forceinline__ typename Complex<R>::type cplx(R x, R y) {
  typename Complex<R>::type c;
  c.x = x;
  c.y = y;
  return c;
}

// A block's tile of an (n, N) output: rows [r0, r1), columns [c0, c1).
struct Tile {
  int r0, r1, c0, c1;
};

// The tile of block (rank / gc, rank % gc) of a gr x gc grid over (rows, cols).
__device__ __forceinline__ Tile tile_of(int rank, int gr, int gc, int rows, int cols) {
  const int tr = (rows + gr - 1) / gr, tc = (cols + gc - 1) / gc;
  Tile t;
  t.r0 = min(rows, (rank / gc) * tr);
  t.r1 = min(rows, t.r0 + tr);
  t.c0 = min(cols, (rank % gc) * tc);
  t.c1 = min(cols, t.c0 + tc);
  return t;
}

// What every block of a group agrees on for one element.
template <typename R>
struct Plan {
  using C = typename Complex<R>::type;
  int n, order, s;
  const Coeffs* coeff;
  C* pow;  // X^1..X^s, (s, n, n)
};

// sum_{i < s, base + i <= order} c[base + i] X^i at (i, j), plus extra * X^s:
// a Horner block, with X^0 = I.
template <typename R>
__device__ __forceinline__ typename Complex<R>::type block_value(const Plan<R>& P, int i, int j,
                                                                 int base, R extra) {
  using C = typename Complex<R>::type;
  const size_t at = (size_t)i * P.n + j, nn = (size_t)P.n * P.n;
  C v = cplx<R>(i == j ? (R)P.coeff->c[base] : R(0), R(0));
  for (int p = 1; p < P.s && base + p <= P.order; ++p) {
    const R w = (R)P.coeff->c[base + p];
    const C x = ld_l2(P.pow + (size_t)(p - 1) * nn + at);
    v.x += w * x.x;
    v.y += w * x.y;
  }
  if (extra != R(0)) {
    const C x = ld_l2(P.pow + (size_t)(P.s - 1) * nn + at);
    v.x += extra * x.x;
    v.y += extra * x.y;
  }
  return v;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// All `blocks` blocks of a group meet: their writes before the barrier are
// visible (in L2) to every block of the group after it. `arrived` is the
// group's counter, `target` this block's count of arrivals so far (every
// block of the group passes the same barriers, so the counts agree).
__device__ __forceinline__ void group_barrier(unsigned int* arrived, unsigned int& target,
                                              int blocks) {
  __threadfence();
  __syncthreads();
  target += blocks;
  if (threadIdx.x == 0) {
    atomicAdd(arrived, 1u);
    // ~17 s of 256 ns naps: far beyond any step here; a lost block traps
    // the kernel (an error at the next synchronize) instead of hanging it
    for (long long spins = 0; load_acquire(arrived) < target; ++spins) {
      if (spins > (1LL << 26)) __trap();
      __nanosleep(256);
    }
  }
  __syncthreads();
}

// The thread's share of the A tile (rows rc0.., depth k0..) and the B tile
// (depth k0.., columns cc0..) of a product chunk, masked at the tile's edges.
template <typename C>
__device__ __forceinline__ void load_tiles(const Tile& t, const C* A, const C* B, int N, int n,
                                           int rc0, int cc0, int k0, C (&ra)[kALoads],
                                           C (&rb)[kBLoads]) {
  const int tid = threadIdx.x;
  C zero;
  zero.x = 0;
  zero.y = 0;
#pragma unroll
  for (int q = 0; q < kALoads; ++q) {
    const int e = tid + q * kThreads, i = rc0 + e / kDepth, k = k0 + e % kDepth;
    ra[q] = (i < t.r1 && k < n) ? ld_l2(A + (size_t)i * n + k) : zero;
  }
#pragma unroll
  for (int q = 0; q < kBLoads; ++q) {
    const int e = tid + q * kThreads, k = k0 + e / kColChunk, j = cc0 + e % kColChunk;
    rb[q] = (k < n && j < t.c1) ? ld_l2(B + (size_t)k * N + j) : zero;
  }
}

// The block's tile of out (n, N) = A (n, n) @ B (n, N), plus the Horner block
// of base `horner_base` when it is >= 0. out is neither A nor B.
template <typename R>
__device__ void product(const Plan<R>& P, const Tile& t, const typename Complex<R>::type* A,
                        const typename Complex<R>::type* B, typename Complex<R>::type* out,
                        int N, int horner_base, typename Complex<R>::type* smem) {
  using C = typename Complex<R>::type;
  C* As = smem;                       // [kRowChunk][kDepth]
  C* Bs = smem + kRowChunk * kDepth;  // [kDepth][kColChunk]
  const int n = P.n, tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const C zero = cplx<R>(0, 0);
  for (int rc0 = t.r0; rc0 < t.r1; rc0 += kRowChunk) {
    for (int cc0 = t.c0; cc0 < t.c1; cc0 += kColChunk) {
      C acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) acc[r][c] = zero;
      C ra[kALoads], rb[kBLoads];
      load_tiles(t, A, B, N, n, rc0, cc0, 0, ra, rb);
      for (int k0 = 0; k0 < n; k0 += kDepth) {
        __syncthreads();  // the previous tile is consumed
#pragma unroll
        for (int q = 0; q < kALoads; ++q) As[tid + q * kThreads] = ra[q];
#pragma unroll
        for (int q = 0; q < kBLoads; ++q) Bs[tid + q * kThreads] = rb[q];
        __syncthreads();
        if (k0 + kDepth < n)  // in flight while this tile multiplies
          load_tiles(t, A, B, N, n, rc0, cc0, k0 + kDepth, ra, rb);
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          C a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) a[r] = As[(ty + 16 * r) * kDepth + kk];
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) b[c] = Bs[kk * kColChunk + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int c = 0; c < kColsPerThread; ++c) {
              acc[r][c].x = fma_r(a[r].x, b[c].x, acc[r][c].x);
              acc[r][c].x = fma_r(-a[r].y, b[c].y, acc[r][c].x);
              acc[r][c].y = fma_r(a[r].x, b[c].y, acc[r][c].y);
              acc[r][c].y = fma_r(a[r].y, b[c].x, acc[r][c].y);
            }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int i = rc0 + ty + 16 * r, j = cc0 + tx + 16 * c;
          if (i < t.r1 && j < t.c1) {
            C v = acc[r][c];
            if (horner_base >= 0) {
              const C blk = block_value(P, i, j, horner_base, R(0));
              v.x += blk.x;
              v.y += blk.y;
            }
            out[(size_t)i * N + j] = v;
          }
        }
    }
  }
}

template <typename R>
__global__ void __launch_bounds__(kThreads)
expm_chain_kernel(const typename Complex<R>::type* __restrict__ gen,
                  const typename Complex<R>::type* __restrict__ y0,
                  typename Complex<R>::type* __restrict__ out,
                  typename Complex<R>::type* __restrict__ scratch,
                  unsigned int* __restrict__ barriers, int T, int b, int n, int m, int order,
                  int squarings, int group_size, int grid_cols, R scale, Coeffs coeff) {
  using C = typename Complex<R>::type;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  C* smem = reinterpret_cast<C*>(smem_bytes);
  const int gs = group_size, rank = blockIdx.x % gs;
  const int gid = blockIdx.x / gs, groups = gridDim.x / gs;
  unsigned int* arrived = barriers + gid;
  unsigned int target = 0;
  const int gr = gs / grid_cols;
  const Tile sq = tile_of(rank, gr, grid_cols, n, n);   // of every (n, n) result
  const Tile ap = tile_of(rank, gr, grid_cols, n, m);   // of the state

  int s = 2;
  while ((s + 1) * (s + 1) <= order) ++s;
  const size_t nn = (size_t)n * n, nm = (size_t)n * m;
  C* base = scratch + (size_t)gid * ((s + 2) * nn + 2 * nm);
  Plan<R> P;
  P.n = n;
  P.order = order;
  P.s = s;
  P.coeff = &coeff;
  P.pow = base;
  C* poly[2] = {base + s * nn, base + (s + 1) * nn};
  C* state[2] = {base + (s + 2) * nn, base + (s + 2) * nn + nm};
  C* Xs = base + (size_t)(s - 1) * nn;
  const int tw = sq.c1 - sq.c0, own = (sq.r1 - sq.r0) * tw;

  // index of the top Horner block, and whether it is c I (folded)
  const int mtop = (order + s) / s - 1;
  const bool fold = s * mtop == order;

  for (int e = gid; e < b; e += groups) {
    const C* y = y0 + (size_t)e * nm;
    int ys = 0;
    for (int t = 0; t < T; ++t) {
      // X = G * dt / 2^q on the block's tile
      const C* g = gen + ((size_t)t * b + e) * nn;
      for (int k = threadIdx.x; k < own; k += kThreads) {
        const size_t at = (size_t)(sq.r0 + k / tw) * n + sq.c0 + k % tw;
        const C v = __ldcs(g + at);
        P.pow[at] = cplx<R>(v.x * scale, v.y * scale);
      }
      group_barrier(arrived, target, gs);
      // powers X^2..X^s
      for (int p = 1; p < s; ++p) {
        product(P, sq, P.pow + (size_t)(p - 1) * nn, P.pow, P.pow + (size_t)p * nn, n, -1, smem);
        group_barrier(arrived, target, gs);
      }
      // the top Horner block (the folded form when it is c I)
      int top = mtop;
      for (int k = threadIdx.x; k < own; k += kThreads) {
        const int i = sq.r0 + k / tw, j = sq.c0 + k % tw;
        poly[0][(size_t)i * n + j] = fold ? block_value(P, i, j, s * (top - 1), (R)coeff.c[order])
                                          : block_value(P, i, j, s * top, R(0));
      }
      if (fold) --top;
      int cur = 0;
      group_barrier(arrived, target, gs);
      for (int jb = top - 1; jb >= 0; --jb) {  // P <- B_j + X^s P
        product(P, sq, Xs, poly[cur], poly[cur ^ 1], n, s * jb, smem);
        cur ^= 1;
        group_barrier(arrived, target, gs);
      }
      for (int q = 0; q < squarings; ++q) {  // P <- P P
        product(P, sq, poly[cur], poly[cur], poly[cur ^ 1], n, -1, smem);
        cur ^= 1;
        group_barrier(arrived, target, gs);
      }
      // y <- P y; the last step writes the output
      C* dst = t == T - 1 ? out + (size_t)e * nm : state[ys];
      product(P, ap, poly[cur], y, dst, m, -1, smem);
      y = dst;
      ys ^= 1;
      group_barrier(arrived, target, gs);
    }
  }
}

// Dynamic shared memory of a block: its tiles, but at least 114 KB, so that no
// two blocks share an SM (2 x 115 KB with the per-block reserve passes the
// SM's 228 KB).
constexpr size_t kSpreadBytes = 114 * 1024;

size_t shared_bytes(size_t entry) {
  const size_t tiles = (size_t)(kRowChunk * kDepth + kDepth * kColChunk) * entry;
  return tiles > kSpreadBytes ? tiles : kSpreadBytes;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The group shape for (n, b): among groups of 64 (an 8 x 8 grid of output
// tiles), 32 (8 x 4), 16 (4 x 4), 8 (4 x 2), 4 (2 x 2), 2 (2 x 1) and 1
// block, the one with the least work on the busiest block: waves of groups
// (ceil(b / groups resident at once)) times the product chunks of a tile;
// ties go to the smaller group. Returns the group size, the grid's columns
// and the groups resident at once.
template <typename R>
cudaError_t plan_groups(int n, int b, int* group_size, int* grid_cols, int* groups) {
  using C = typename Complex<R>::type;
  auto kernel = expm_chain_kernel<R>;
  const size_t smem = shared_bytes(sizeof(C));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)sms * per_sm;
  const int shapes[][2] = {{1, 1}, {2, 1}, {2, 2}, {4, 2}, {4, 4}, {8, 4}, {8, 8}};
  long long best = -1;
  for (const auto& shape : shapes) {
    const int gr = shape[0], gc = shape[1], gs = gr * gc;
    const long long count = resident / gs;
    if (count < 1) continue;
    const long long work = ceil_div(b, count) * ceil_div(ceil_div(n, gr), kRowChunk) *
                           ceil_div(ceil_div(n, gc), kColChunk);
    if (best < 0 || work < best) {
      best = work;
      *group_size = gs;
      *grid_cols = gc;
      *groups = (int)count;
    }
  }
  return best < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename R>
cudaError_t launch(const void* gen, const void* y0, void* out, void* scratch, void* barriers,
                   int T, int b, int n, int m, int order, int squarings, double dt, int gs,
                   int gc, int groups, cudaStream_t stream) {
  using C = typename Complex<R>::type;
  Coeffs coeff;
  double f = 1.0;
  for (int k = 0; k <= kMaxOrder; ++k) {
    if (k > 0) f *= k;
    coeff.c[k] = 1.0 / f;
  }
  const R scale = (R)(dt / (double)(1LL << squarings));
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident at once, or refused
  attr[0].val.cooperative = 1;
  config.gridDim = dim3(gs * groups);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = shared_bytes(sizeof(C));
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, expm_chain_kernel<R>, (const C*)gen, (const C*)y0,
                                       (C*)out, (C*)scratch, (unsigned int*)barriers, T, b, n, m,
                                       order, squarings, gs, gc, scale, coeff);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for (n, b) in complex64 (double_precision = 0) or
// complex128 (1): the group size, the columns of its grid of output tiles,
// and the groups resident at once. The wrapper launches min(b, groups)
// groups and gives each a scratch of expm_chain_scratch_entries(n, m, order)
// complex entries and a zeroed 32-bit barrier counter.
int expm_chain_plan(int n, int b, int double_precision, int* group_size, int* grid_cols,
                    int* groups) {
  if (n < 1 || b < 1) return (int)cudaErrorInvalidValue;
  return (int)(double_precision ? plan_groups<double>(n, b, group_size, grid_cols, groups)
                                : plan_groups<float>(n, b, group_size, grid_cols, groups));
}

long long expm_chain_scratch_entries(int n, int m, int order) {
  int s = 2;
  while ((s + 1) * (s + 1) <= order) ++s;
  return (long long)(s + 2) * n * n + 2LL * n * m;
}

// gen: contiguous (T, b, n, n); y0, out: contiguous (b, n, m), all complex64
// or all complex128; scratch: groups x expm_chain_scratch_entries entries;
// barriers: groups zeroed unsigned 32-bit counters.
int expm_chain_launch(const void* gen, const void* y0, void* out, void* scratch, void* barriers,
                      int T, int b, int n, int m, int order, int squarings, double dt,
                      int group_size, int grid_cols, int groups, int double_precision,
                      void* stream) {
  if (T < 1 || b < 1 || n < 1 || m < 1 || order < 6 || order > kMaxOrder || squarings < 0 ||
      squarings > 60 || group_size < 1 || grid_cols < 1 || group_size % grid_cols != 0 ||
      groups < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(double_precision
                   ? launch<double>(gen, y0, out, scratch, barriers, T, b, n, m, order,
                                    squarings, dt, group_size, grid_cols, groups, s)
                   : launch<float>(gen, y0, out, scratch, barriers, T, b, n, m, order,
                                   squarings, dt, group_size, grid_cols, groups, s));
}

const char* expm_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
