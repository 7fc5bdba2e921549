// Member-major fixed-step Magnus-2 / Magnus-3 sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/member_sweep.py::_kernel
// (Pallas, launched by sweep_expm_magnus2_member). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/member_sweep.py.
//
// What it computes. For every sweep member b, T fixed steps of size dt. At
// each Gauss point g of a step (2 points for Magnus-2, 3 for Magnus-3) the
// generator is
//   G_g = R_{g,0} + sum_j c_{b,j,g} R_{g,1+j},  R_{g,0} = P(tau_g) o S,
//   R_{g,1+j} = P(tau_g) o O_j,  P(tau)[i,m] = exp(i omega[i,m] tau),
//   tau_g = t0 + (s + node_g) dt
// (the frame rotation is elementwise-linear, so the shared tables are rotated
// once and each member only combines them). The step matrix is
//   Magnus-2: M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1]
//   Magnus-3: a1 = dt G_2, a2 = (sqrt(15)/3) dt (G_3 - G_1),
//             a3 = (10/3) dt (G_3 - 2 G_2 + G_1), C1 = [a1, a2],
//             C2 = [2 a3 + C1, a1] / 60,
//             M = a1 + a3/12 + [-20 a1 - a3 + C1, a2 + C2] / 240
// and the state advances by the Horner Taylor action
//   v = y; v = y + (M v)/j for j = order..1; y = v.
// With `hermitian` (anti-Hermitian generators, G = -iH) the Magnus-2 bracket
// is one product: [A, B] = P - P^H with P = A B. Magnus-3 forms its brackets
// as A B - B A either way (the same function to roundoff): the transpose of
// P needs a fourth matrix to stage it, which left one block per SM and took
// longer than the second product saves (1,482 against 1,333 ms at the dim-8
// row on an H100 SXM at 700 W, scripts/torch_member_sweep_time.py).
//
// What bounds it on this card. Operations: a complex n x n product is 8 n^3
// float32 operations, and a Magnus-3 step at n = 64 does 6 of them; table
// reads (from L2) and the Horner mat-vecs are small beside them. As 3xTF32 on
// the tensor cores (495 TFLOP/s TF32, three passes) the products of the dim-8
// rows need 312 ms (Magnus-3) and 260 ms (Magnus-2), against 769 and 641 ms
// at the FP32 rate; chip_smoke.py's b3_bounds gives both. Beside the
// products, what costs time is latency: the generator build's L2 reads, the
// elementwise combinations and the barriers of the Horner action.
//
// Design.
// - Products on the tensor cores in 3xTF32: each float32 operand x is split
//   into hi (x truncated to TF32) and lo = tf32(x - hi), and mma.sync m16n8k8
//   (TF32 in, FP32 accumulators) sums lo*hi + hi*lo + hi*hi, which keeps
//   float32 accuracy. Built with -DMEMBER_SWEEP_ONE_PASS_TF32 it sums hi*hi
//   alone, hi rounded to TF32: single-pass TF32, a control that the package
//   never builds, which scripts/torch_member_sweep_time.py --control shows
//   failing chip_smoke.py's bracket-dominated check. Complex products are four real ones (Re = ArBr - AiBi, Im =
//   ArBi + AiBr; signs by flipping sign bits, which is exact), and both
//   products of a bracket go into the same accumulators. A warp owns a 16 x 32
//   output tile (four m16n8 tiles), so each A fragment serves four products.
// - Matrices are complex64 (float2) in shared memory, padded to np = n
//   rounded up to 16 with zero rows and columns (zeros stay zero through
//   every product and combination, so ragged n needs no masks in the
//   products), row stride np + 4: the 8-byte fragment loads of a half-warp
//   then fall on 16 distinct bank pairs.
// - Two blocks of 8 warps per SM at n = 64 for both rules: Magnus-3 keeps 3
//   matrices (104 KB). A bracket's result stays in the warp's fragments across
//   the barrier after it, and the Magnus combinations are done in the
//   brackets' epilogues at the fragments' own entries: C1 is held in registers
//   through the second bracket, so a3 = (X - C1)/2 is recovered from X and no
//   fourth matrix is needed. Magnus-2 keeps G_1, G_2 and M (with `hermitian`
//   P is staged in M's place for its transpose); from np = 96 its matrices live
//   in a per-block scratch in device memory (a persistent grid of 2 blocks
//   per SM, so the scratch stays small and mostly in L2).
// - The generator build reads the step's rotated tables (padded like the
//   matrices) with 16-byte loads, software-pipelined over entry pairs (the
//   next pair's static and first operator tables in flight; further
//   operators loaded in the pair's own iteration), and the next step's
//   coefficients are loaded during the current step; the other block on the
//   SM overlaps these reads.
// - The Horner action: four threads per row (columns interleaved, so a
//   half-warp's loads fall on distinct banks; four independent chains),
//   sums reduced by two shuffles; the vectors rotate over three buffers, so
//   each order costs one barrier.
// - member_tables_kernel fills the rotated tables R (T, n_gauss, k+1, np, np)
//   once per launch: they depend on the step, never on the member, and their
//   phases cos/sin(fmod(omega tau, 2 pi)) are formed from float64 tau.
// - Any B: one block per member (grid-stride over members on the scratch
//   path), no padding lanes.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;     // state dimension cap
constexpr int kMaxN3 = 64;     // cap for Magnus-3 (a warp holds at most one output tile)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr double kTwoPi = 6.283185307179586;

struct TableParams {
  const float* statr;  // (n, n)
  const float* stati;
  const float* opsr;  // (k, n, n)
  const float* opsi;
  const double* omega;  // (n, n) frame frequency differences
  float2* table;        // (T, n_gauss, k + 1, np, np)
  int n, np, k, T, gauss;
  double dt, t0;
  double node[3];  // Gauss nodes in (0, 1)
};

struct SweepParams {
  const float2* table;  // (T, n_gauss, k + 1, np, np)
  const float* coef;    // (T, n_gauss, k, B)
  const float* y0r;     // (n, B)
  const float* y0i;
  float* outr;  // (n, B)
  float* outi;
  float2* scratch;  // per-block matrices when they do not fit in shared memory
  int n, k, T, B, order, magnus, hermitian;
  float c1, c2;           // Magnus-2: dt / 2, p2 dt^2
  float dtf, c0dt, c1dt;  // Magnus-3: dt, (sqrt(15)/3) dt, (10/3) dt
};

__host__ __device__ inline int padded(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int row_stride(int n) { return padded(n) + 4; }
constexpr int kMatrices = 3;

// float2 elements of one block's matrices
__host__ __device__ inline size_t matrix_elems(int n) {
  return (size_t)kMatrices * padded(n) * row_stride(n);
}

// float2 elements of one block's vectors: three state buffers and the
// coefficients of two steps (2 x 3 k floats)
__host__ __device__ inline size_t vector_elems(int n, int k) {
  return 3 * (size_t)padded(n) + 3 * (size_t)k;
}

__global__ void member_tables_kernel(TableParams p) {
  const int sg = blockIdx.x;  // step * n_gauss + gauss point
  const int s = sg / p.gauss, g = sg % p.gauss;
  const double tau = p.t0 + ((double)s + p.node[g]) * p.dt;
  const int nn = p.n * p.n, pp = p.np * p.np;
  float2* out = p.table + (size_t)sg * (p.k + 1) * pp;
  for (int q = threadIdx.x; q < pp; q += blockDim.x) {
    const int i = q / p.np, j = q % p.np;
    if (i >= p.n || j >= p.n) {  // zero padding
      for (int m = 0; m <= p.k; ++m) out[(size_t)m * pp + q] = make_float2(0.0f, 0.0f);
      continue;
    }
    const int e = i * p.n + j;
    const double ph = fmod(p.omega[e] * tau, kTwoPi);
    const float cp = (float)cos(ph), sp = (float)sin(ph);
    float ar = p.statr[e], ai = p.stati[e];
    out[q] = make_float2(ar * cp - ai * sp, ar * sp + ai * cp);
    for (int m = 0; m < p.k; ++m) {
      ar = p.opsr[(size_t)m * nn + e];
      ai = p.opsi[(size_t)m * nn + e];
      out[(size_t)(1 + m) * pp + q] = make_float2(ar * cp - ai * sp, ar * sp + ai * cp);
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products
// ---------------------------------------------------------------------------
constexpr uint32_t kSign = 0x80000000u;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to float32 accuracy, both exact TF32 values: hi keeps the top
// 10 mantissa bits (truncation, one instruction), x - hi is exact in float32
// and rounds to TF32 with an error below 2^-21 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#ifdef MEMBER_SWEEP_ONE_PASS_TF32
  hi = to_tf32(x);
  lo = 0u;
#else
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = to_tf32(x - __uint_as_float(hi));
#endif
}

// d += a b for one m16n8k8 TF32 tile (FP32 accumulators)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
#ifndef MEMBER_SWEEP_ONE_PASS_TF32
  mma(d, alo, bhi[0], bhi[1]);
  mma(d, ahi, blo[0], blo[1]);
#endif
  mma(d, ahi, bhi[0], bhi[1]);
}

// One warp's output tile: rows r0 .. r0 + 15, columns c0 .. c0 + 8 nt - 1
// (nt <= 4 m16n8 tiles). Fragment entry q of m16n8 tile j is at row
// r0 + g + 8 (q / 2), column c0 + 8 j + 2 t + (q % 2), g = lane / 4, t = lane % 4.
struct Tile {
  int r0, c0, nt;
};

__device__ __forceinline__ int tile_count(int np) { return (np / 16) * ((np + 31) / 32); }

__device__ __forceinline__ Tile warp_tile(int np, int w) {
  const int tiles_c = (np + 31) / 32;
  Tile t;
  t.r0 = 16 * (w / tiles_c);
  t.c0 = 32 * (w % tiles_c);
  t.nt = min(4, (np - t.c0) / 8);
  return t;
}

struct Acc {
  float re[4][4];
  float im[4][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc.re[j][q] = acc.im[j][q] = 0.0f;
  }
}

// acc (+ or -)= A B over the tile, A and B (np, np) complex with row stride ld.
template <bool NEG>
__device__ __forceinline__ void tile_product(const float2* A, const float2* B, int np, int ld,
                                             const Tile& tile, Acc& acc) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float2* arow0 = A + (size_t)(tile.r0 + g) * ld + t;
  const float2* arow1 = arow0 + 8 * ld;
  const float2* bcol = B + (size_t)t * ld + tile.c0 + g;
  const uint32_t sa = NEG ? kSign : 0u;
#pragma unroll 1
  for (int k0 = 0; k0 < np; k0 += 8) {
    // A fragment (rows g, g + 8; columns t, t + 4 of this k-slab), real and
    // imaginary parts; the product's sign goes on A (exact)
    const float2 x0 = arow0[k0], x1 = arow1[k0], x2 = arow0[k0 + 4], x3 = arow1[k0 + 4];
    uint32_t rhi[4], rlo[4], ihi[4], ilo[4];
    split(x0.x, rhi[0], rlo[0]);
    split(x1.x, rhi[1], rlo[1]);
    split(x2.x, rhi[2], rlo[2]);
    split(x3.x, rhi[3], rlo[3]);
    split(x0.y, ihi[0], ilo[0]);
    split(x1.y, ihi[1], ilo[1]);
    split(x2.y, ihi[2], ilo[2]);
    split(x3.y, ihi[3], ilo[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rhi[q] ^= sa;
      rlo[q] ^= sa;
      ihi[q] ^= sa;
      ilo[q] ^= sa;
    }
    const float2* bk = bcol + (size_t)k0 * ld;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < tile.nt) {
        const float2 y0 = bk[8 * j], y1 = bk[4 * ld + 8 * j];
        uint32_t brh[2], brl[2], bih[2], bil[2];
        split(y0.x, brh[0], brl[0]);
        split(y1.x, brh[1], brl[1]);
        split(y0.y, bih[0], bil[0]);
        split(y1.y, bih[1], bil[1]);
        const uint32_t nih[2] = {bih[0] ^ kSign, bih[1] ^ kSign};
        const uint32_t nil[2] = {bil[0] ^ kSign, bil[1] ^ kSign};
        mma3(acc.re[j], rhi, rlo, brh, brl);  // Re += Ar Br
        mma3(acc.re[j], ihi, ilo, nih, nil);  //      - Ai Bi
        mma3(acc.im[j], rhi, rlo, bih, bil);  // Im += Ar Bi
        mma3(acc.im[j], ihi, ilo, brh, brl);  //      + Ai Br
      }
    }
  }
}

// f(row, col, v0, v1) over the tile's entries, two adjacent columns at a
// time (col is even): v0 and v1 are the fragment values at (row, col) and
// (row, col + 1), which f may change.
template <class F>
__device__ __forceinline__ void for_each_pair(const Tile& tile, Acc& acc, F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < tile.nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v0 = make_float2(acc.re[j][2 * h], acc.im[j][2 * h]);
        float2 v1 = make_float2(acc.re[j][2 * h + 1], acc.im[j][2 * h + 1]);
        f(tile.r0 + g + 8 * h, tile.c0 + 8 * j + 2 * t, v0, v1);
        acc.re[j][2 * h] = v0.x;
        acc.im[j][2 * h] = v0.y;
        acc.re[j][2 * h + 1] = v1.x;
        acc.im[j][2 * h + 1] = v1.y;
      }
    }
  }
}

// The same over two accumulators of one tile, read only: f(row, col, a0, a1, b0, b1).
template <class F>
__device__ __forceinline__ void for_each_pair2(const Tile& tile, const Acc& a, const Acc& b,
                                               F f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < tile.nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * h;
        f(tile.r0 + g + 8 * h, tile.c0 + 8 * j + 2 * t, make_float2(a.re[j][q], a.im[j][q]),
          make_float2(a.re[j][q + 1], a.im[j][q + 1]), make_float2(b.re[j][q], b.im[j][q]),
          make_float2(b.re[j][q + 1], b.im[j][q + 1]));
      }
    }
  }
}

__device__ __forceinline__ float4 ld4(const float2* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float2* p, float2 a, float2 b) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 lo2(float4 v) { return make_float2(v.x, v.y); }
__device__ __forceinline__ float2 hi2(float4 v) { return make_float2(v.z, v.w); }

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.x = fmaf(-a.y, b.y, acc.x);
  acc.y = fmaf(a.x, b.y, acc.y);
  acc.y = fmaf(a.y, b.x, acc.y);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cscale(float s, float2 a) {
  return make_float2(s * a.x, s * a.y);
}

// acc <- [A, B] = A B - B A over this warp's tile. Needs at most one tile per
// warp (np <= 64). Called by every thread of the block; ends with a barrier,
// after which A and B may be overwritten while acc keeps the result.
__device__ __forceinline__ void bracket(const float2* A, const float2* B, int np, int ld,
                                        bool has, const Tile& tile, Acc& acc) {
  zero(acc);
  if (has) {
    tile_product<false>(A, B, np, ld, tile, acc);
    tile_product<true>(B, A, np, ld, tile, acc);
  }
  __syncthreads();
}

// The step's generators at all G Gauss points, an entry pair per call of
// store(e, G_g at e and e + 1 for g < G), over the block's threads. The loop
// over entry pairs is software-pipelined: the next pair's static and first
// operator tables (2 G 16-byte loads) are in flight while this pair is
// combined; operators 2 .. k, where there are any, are loaded in the pair's
// own iteration, G loads at a time.
template <int G, class Store>
__device__ __forceinline__ void build(const float2* tab, const float* cs, int k, int pp,
                                      Store store) {
  const float4* t4 = reinterpret_cast<const float4*>(tab);
  const int q4 = pp / 2;     // float4 elements (entry pairs) per table
  const int m1 = min(k, 1);  // the second table in flight: R_1 (R_0 again if k = 0, unused)
  int e = threadIdx.x;       // this thread's entry pair, as a float4 index
  if (e >= q4) return;
  float4 r[2 * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    r[2 * g] = __ldg(t4 + (size_t)g * (k + 1) * q4 + e);
    r[2 * g + 1] = __ldg(t4 + (size_t)(g * (k + 1) + m1) * q4 + e);
  }
  for (; e < q4; e += kThreads) {
    const int en = min(e + kThreads, q4 - 1);
    float4 nx[2 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      nx[2 * g] = __ldg(t4 + (size_t)g * (k + 1) * q4 + en);
      nx[2 * g + 1] = __ldg(t4 + (size_t)(g * (k + 1) + m1) * q4 + en);
    }
    float4 acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] = r[2 * g];
      if (k > 0) {
        const float c = cs[g * k];
        const float4 o = r[2 * g + 1];
        acc[g] = make_float4(fmaf(c, o.x, acc[g].x), fmaf(c, o.y, acc[g].y),
                             fmaf(c, o.z, acc[g].z), fmaf(c, o.w, acc[g].w));
      }
    }
    for (int j = 2; j <= k; ++j) {
      float4 o[G];
#pragma unroll
      for (int g = 0; g < G; ++g) o[g] = __ldg(t4 + (size_t)(g * (k + 1) + j) * q4 + e);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = cs[g * k + j - 1];
        acc[g] = make_float4(fmaf(c, o[g].x, acc[g].x), fmaf(c, o[g].y, acc[g].y),
                             fmaf(c, o[g].z, acc[g].z), fmaf(c, o[g].w, acc[g].w));
      }
    }
    store(2 * e, acc);
#pragma unroll
    for (int m = 0; m < 2 * G; ++m) r[m] = nx[m];
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 2) member_sweep_kernel(SweepParams p) {
  extern __shared__ float4 smem_raw[];
  float2* smem = reinterpret_cast<float2*>(smem_raw);
  const int n = p.n, k = p.k, np = padded(n), ld = row_stride(n), pp = np * np;
  const int tid = threadIdx.x, warp = tid / 32, hq = tid % 4;
  const size_t msz = (size_t)np * ld;
  const size_t mats_elems = matrix_elems(n);
  float2* vecs = SMEM ? smem + mats_elems : smem;
  float2* mats = SMEM ? smem : p.scratch + (size_t)blockIdx.x * mats_elems;
  float2* b0 = mats;
  float2* b1 = mats + msz;
  float2* b2 = mats + 2 * msz;
  float* csh = reinterpret_cast<float*>(vecs + 3 * np);  // two steps' coefficients
  const int gauss = p.magnus, gk = gauss * k;
  const bool herm = p.hermitian != 0;  // Magnus-2 only (see the header)
  const bool has = warp < tile_count(np);  // Magnus-3: this warp's output tile
  const Tile tile = warp_tile(np, warp);

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    __syncthreads();  // the previous member is done with every buffer
    if (tid < n) {
      vecs[tid] = make_float2(p.y0r[(size_t)tid * p.B + b], p.y0i[(size_t)tid * p.B + b]);
    }
    if (tid < gk) csh[tid] = p.coef[(size_t)tid * p.B + b];
    int yi = 0;  // the state lives in vector buffer yi of 3
    __syncthreads();

    for (int s = 0; s < p.T; ++s) {
      // the next step's coefficients, stored once this step's build is done
      float cnext = 0.0f;
      if (tid < gk && s + 1 < p.T) cnext = p.coef[((size_t)(s + 1) * gk + tid) * p.B + b];
      const float* cs = csh + (s & 1) * gk;
      const float2* tab = p.table + (size_t)s * gauss * (k + 1) * pp;
      const float2* M;

      if (p.magnus == 2) {
        build<2>(tab, cs, k, pp, [&](int e, const float4 (&g)[2]) {  // G1, G2
          const int at = (e / np) * ld + e % np;
          *reinterpret_cast<float4*>(b0 + at) = g[0];
          *reinterpret_cast<float4*>(b1 + at) = g[1];
        });
        __syncthreads();
        if (tid < gk) csh[((s + 1) & 1) * gk + tid] = cnext;
        // M = c1 (G1 + G2) + c2 [G2, G1], tile by tile into b2
        for (int w = warp; w < tile_count(np); w += kWarps) {
          const Tile tl = warp_tile(np, w);
          Acc acc;
          zero(acc);
          tile_product<false>(b1, b0, np, ld, tl, acc);
          if (herm) {  // b2 <- P = G2 G1
            for_each_pair(tl, acc, [&](int row, int col, float2& v0, float2& v1) {
              st4(b2 + row * ld + col, v0, v1);
            });
            continue;
          }
          tile_product<true>(b0, b1, np, ld, tl, acc);
          for_each_pair(tl, acc, [&](int row, int col, float2& v0, float2& v1) {
            const int at = row * ld + col;
            const float4 g1 = ld4(b0 + at), g2 = ld4(b1 + at);
            st4(b2 + at, cadd(cscale(p.c1, cadd(lo2(g1), lo2(g2))), cscale(p.c2, v0)),
                cadd(cscale(p.c1, cadd(hi2(g1), hi2(g2))), cscale(p.c2, v1)));
          });
        }
        __syncthreads();
        if (herm) {  // b2 <- c1 (G1 + G2) + c2 (P - P^H), whole (i, j), (j, i) pairs
          for (int e = tid; e < n * n; e += kThreads) {
            const int i = e / n, j = e % n;
            if (i > j) continue;
            const float2 pij = b2[i * ld + j], pji = b2[j * ld + i];
            const float2 cij = make_float2(pij.x - pji.x, pij.y + pji.y);
            const float2 cji = make_float2(pji.x - pij.x, pji.y + pij.y);
            b2[i * ld + j] = cadd(cscale(p.c1, cadd(b0[i * ld + j], b1[i * ld + j])),
                                  cscale(p.c2, cij));
            b2[j * ld + i] = cadd(cscale(p.c1, cadd(b0[j * ld + i], b1[j * ld + i])),
                                  cscale(p.c2, cji));
          }
          __syncthreads();
        }
        M = b2;
      } else {
        // a1 = dt G2, a2 = c0dt (G3 - G1), a3 = c1dt (G3 - 2 G2 + G1)
        build<3>(tab, cs, k, pp, [&](int e, const float4 (&g)[3]) {
          const int at = (e / np) * ld + e % np;
          const float2 g1a = lo2(g[0]), g1b = hi2(g[0]), g2a = lo2(g[1]), g2b = hi2(g[1]);
          const float2 g3a = lo2(g[2]), g3b = hi2(g[2]);
          st4(b0 + at, cscale(p.dtf, g2a), cscale(p.dtf, g2b));
          st4(b1 + at, cscale(p.c0dt, csub(g3a, g1a)), cscale(p.c0dt, csub(g3b, g1b)));
          st4(b2 + at, cscale(p.c1dt, cadd(csub(g3a, cscale(2.0f, g2a)), g1a)),
              cscale(p.c1dt, cadd(csub(g3b, cscale(2.0f, g2b)), g1b)));
        });
        __syncthreads();
        if (tid < gk) csh[((s + 1) & 1) * gk + tid] = cnext;
        Acc c1, acc;
        bracket(b0, b1, np, ld, has, tile, c1);  // C1 = [a1, a2], kept
        if (has) {  // X = 2 a3 + C1 over a3
          for_each_pair(tile, c1, [&](int row, int col, float2& v0, float2& v1) {
            const int at = row * ld + col;
            const float4 a3 = ld4(b2 + at);
            st4(b2 + at, cadd(cscale(2.0f, lo2(a3)), v0), cadd(cscale(2.0f, hi2(a3)), v1));
          });
        }
        __syncthreads();
        bracket(b2, b0, np, ld, has, tile, acc);  // [X, a1] = 60 C2
        if (has) {  // Y over X, Z = a2 + C2 over a2, M so far = a1 + a3/12 over a1
          for_each_pair2(tile, c1, acc, [&](int row, int col, float2 c10, float2 c11,
                                             float2 d0, float2 d1) {
            const int at = row * ld + col;
            const float4 x = ld4(b2 + at), a1 = ld4(b0 + at), a2 = ld4(b1 + at);
            const float2 a30 = cscale(0.5f, csub(lo2(x), c10));
            const float2 a31 = cscale(0.5f, csub(hi2(x), c11));
            st4(b2 + at, cadd(csub(cscale(-20.0f, lo2(a1)), a30), c10),
                cadd(csub(cscale(-20.0f, hi2(a1)), a31), c11));
            st4(b1 + at, cadd(lo2(a2), cscale(1.0f / 60.0f, d0)),
                cadd(hi2(a2), cscale(1.0f / 60.0f, d1)));
            st4(b0 + at, cadd(lo2(a1), cscale(1.0f / 12.0f, a30)),
                cadd(hi2(a1), cscale(1.0f / 12.0f, a31)));
          });
        }
        __syncthreads();
        bracket(b2, b1, np, ld, has, tile, acc);  // [Y, Z]
        if (has) {  // M = M so far + [Y, Z] / 240
          for_each_pair(tile, acc, [&](int row, int col, float2& v0, float2& v1) {
            const int at = row * ld + col;
            const float4 m = ld4(b0 + at);
            st4(b0 + at, cadd(lo2(m), cscale(1.0f / 240.0f, v0)),
                cadd(hi2(m), cscale(1.0f / 240.0f, v1)));
          });
        }
        __syncthreads();
        M = b0;
      }

      // y <- sum_{j <= order} M^j y / j!: four threads per row, one barrier per order
      const float2* y = vecs + yi * np;
      const float2* in = y;
      for (int q = 0; q < p.order; ++q) {
        const float inv = (float)(1.0 / (double)(p.order - q));
        float2* out = vecs + ((yi + 1 + (q & 1)) % 3) * np;
        for (int r0 = 0; r0 < n; r0 += kThreads / 4) {  // uniform over the block
          const int r = r0 + tid / 4;
          float2 a0 = make_float2(0.0f, 0.0f), a1 = a0, a2 = a0, a3 = a0;
          if (r < n) {  // columns hq, hq + 4, ...: four chains, loads in flight together
            const float2* row = M + (size_t)r * ld;
            int c = hq;
            for (; c + 12 < n; c += 16) {
              cmac(a0, row[c], in[c]);
              cmac(a1, row[c + 4], in[c + 4]);
              cmac(a2, row[c + 8], in[c + 8]);
              cmac(a3, row[c + 12], in[c + 12]);
            }
            for (; c < n; c += 4) cmac(a0, row[c], in[c]);
          }
          float2 acc = cadd(cadd(a0, a1), cadd(a2, a3));
          acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 1);
          acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 1);
          acc.x += __shfl_xor_sync(0xffffffffu, acc.x, 2);
          acc.y += __shfl_xor_sync(0xffffffffu, acc.y, 2);
          if (r < n && hq == 0) {
            const float2 yr = y[r];
            out[r] = make_float2(fmaf(inv, acc.x, yr.x), fmaf(inv, acc.y, yr.y));
          }
        }
        __syncthreads();  // out is complete; in and M are no longer read
        in = out;
      }
      yi = (yi + 1 + ((p.order - 1) & 1)) % 3;
    }
    if (tid < n) {
      const float2 y = vecs[yi * np + tid];
      p.outr[(size_t)tid * p.B + b] = y.x;
      p.outi[(size_t)tid * p.B + b] = y.y;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one block: matrices and vectors when the
// matrices live in shared memory, the vectors alone otherwise.
size_t member_sweep_smem_bytes(int n, int k, int in_shared) {
  return sizeof(float2) * ((in_shared ? matrix_elems(n) : 0) + vector_elems(n, k));
}

// Blocks of the shared-memory kernel that one SM holds at these arguments,
// from the CUDA occupancy calculator; 0 on error.
int member_sweep_blocks_per_sm(int n, int k) {
  const size_t smem = member_sweep_smem_bytes(n, k, 1);
  if (cudaFuncSetAttribute(member_sweep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, member_sweep_kernel<true>, kThreads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// float2 elements of one block's matrices (the wrapper sizes the scratch with it).
size_t member_sweep_matrix_elems(int n) { return matrix_elems(n); }

// float2 elements of the rotated tables (padded to np x np).
size_t member_sweep_table_elems(int n, int k, int T, int magnus) {
  return (size_t)T * magnus * (k + 1) * padded(n) * padded(n);
}

// Fill the rotated tables, then run `grid` blocks of 256 threads over the B
// members, both on `stream`. With in_shared the matrices live in shared memory
// (grid = B); otherwise in `scratch`, grid * member_sweep_matrix_elems float2.
// Returns the CUDA error code of the launches (0 = cudaSuccess); faults during
// the run surface at the next synchronization.
int member_sweep_launch(const float* statr, const float* stati, const float* opsr,
                        const float* opsi, const double* omega, const float* coef,
                        const float* y0r, const float* y0i, float* outr, float* outi,
                        float2* table, float2* scratch, int n, int k, int T, int B, int order,
                        int magnus, int hermitian, int in_shared, int grid, double dt, double t0,
                        double node0, double node1, double node2, float c1, float c2, float dtf,
                        float c0dt, float c1dt, void* stream) {
  if (n < 1 || n > kMaxN || (magnus != 2 && magnus != 3) || (magnus == 3 && n > kMaxN3) ||
      k < 0 || 3 * k > kThreads || T < 1 || B < 1 || order < 1 || grid < 1 ||
      (!in_shared && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  TableParams tp{statr, stati, opsr, opsi, omega, table, n, padded(n), k, T, magnus, dt, t0,
                 {node0, node1, node2}};
  member_tables_kernel<<<T * magnus, kThreads, 0, st>>>(tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  SweepParams sp{table, coef, y0r, y0i, outr, outi, scratch, n, k, T, B, order, magnus,
                 hermitian, c1, c2, dtf, c0dt, c1dt};
  const size_t smem = member_sweep_smem_bytes(n, k, in_shared);
  if (in_shared) {
    err = cudaFuncSetAttribute(member_sweep_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    member_sweep_kernel<true><<<grid, kThreads, smem, st>>>(sp);
  } else {
    member_sweep_kernel<false><<<grid, kThreads, smem, st>>>(sp);
  }
  return (int)cudaGetLastError();
}

const char* member_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
