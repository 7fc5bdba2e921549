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
// With `hermitian` (anti-Hermitian generators, G = -iH) every bracket is one
// product: [A, B] = P - P^H with P = A B.
//
// Design. Ordinary complex arithmetic in true space: the TPU kernel's
// transposed space, real (2n, 2n) representation and wide (2n, n) @ (n, 2n)
// product exist to fill a 128 x 128 matrix unit and are not carried.
//
// - Two __global__ functions. member_tables_kernel fills the rotated tables
//   R (T, n_gauss, k+1, n, n) once per launch: they depend on the step, never
//   on the member, and their phases cos/sin(fmod(omega tau, 2 pi)) are formed
//   from float64 tau. member_sweep_kernel then gives each member one block of
//   256 threads for the whole time loop and reads the step's tables from L2.
// - A member's matrices (3 for Magnus-2, 5 for Magnus-3, complex64, row
//   stride n | 1) stay in shared memory for the whole solve whenever they fit
//   (Magnus-3 at n = 64: 5 x 33 KB; Magnus-2 up to n = 96). Above that the
//   same code runs on a per-block scratch in device memory (a persistent grid
//   of 2 blocks per SM, so the scratch stays small and mostly in L2).
//   Magnus-3 reuses buffers so that five suffice: a bracket's result is held
//   in registers across a barrier and may overwrite one of its operands.
// - Products are register-blocked: the block is a 16 x 16 thread grid and a
//   thread owns a 4 x 4 tile of each 64 x 64 output panel, so one inner
//   iteration loads 4 + 4 complex operands from shared memory for 16 complex
//   multiply-adds. Both products of a bracket accumulate into the same
//   registers. Rows are read as broadcasts and columns as consecutive
//   float2, so neither conflicts on banks; the odd row stride makes the
//   Horner mat-vec (one thread per row) conflict-free too.
// - Ragged edges are masked: any n up to 128 (row and column indices are
//   clamped for loads and masked for stores), any B (one block per member,
//   no padding lanes).
//
// What bounds it on this card. Operations: a complex n x n product is 8 n^3
// float32 operations; at n = 64 a Magnus-3 step does 6 of them (12.6 MFLOP)
// against ~200 KB of table reads from L2 and 12 bytes of coefficients from
// device memory. Plain FP32 multiply-adds (no TF32 tensor-core products).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 128;      // state dimension cap
constexpr int kMaxN3 = 64;      // cap for Magnus-3 (in-place brackets need one output panel)
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kPanel = 64;      // output panel edge: 16 threads x 4 entries
constexpr double kTwoPi = 6.283185307179586;

struct TableParams {
  const float* statr;  // (n, n)
  const float* stati;
  const float* opsr;  // (k, n, n)
  const float* opsi;
  const double* omega;  // (n, n) frame frequency differences
  float2* table;        // (T, n_gauss, k + 1, n, n)
  int n, k, T, gauss;
  double dt, t0;
  double node[3];  // Gauss nodes in (0, 1)
};

struct SweepParams {
  const float2* table;  // (T, n_gauss, k + 1, n, n)
  const float* coef;    // (T, n_gauss, k, B)
  const float* y0r;     // (n, B)
  const float* y0i;
  float* outr;  // (n, B)
  float* outi;
  float2* scratch;  // per-block matrices when they do not fit in shared memory
  int n, k, T, B, order, magnus, hermitian;
  float c1, c2;             // Magnus-2: dt / 2, p2 dt^2
  float dtf, c0dt, c1dt;    // Magnus-3: dt, (sqrt(15)/3) dt, (10/3) dt
};

__host__ __device__ inline int row_stride(int n) { return n | 1; }
__host__ __device__ inline int matrix_count(int magnus) { return magnus == 3 ? 5 : 3; }
__host__ __device__ inline int padded_rows(int n) { return (n + 31) / 32 * 32; }

// float2 elements of one block's matrices
__host__ __device__ inline size_t matrix_elems(int n, int magnus) {
  return (size_t)matrix_count(magnus) * n * row_stride(n);
}

// float2 elements of one block's vectors: v, the Horner partial sums, and the
// step's coefficients (3 k floats, rounded up)
__host__ __device__ inline size_t vector_elems(int n, int k) {
  const int nr = padded_rows(n);
  return (size_t)n + (size_t)(kThreads / nr) * nr + (size_t)(3 * k + 1) / 2 + 1;
}

__global__ void member_tables_kernel(TableParams p) {
  const int sg = blockIdx.x;  // step * n_gauss + gauss point
  const int s = sg / p.gauss, g = sg % p.gauss;
  const double tau = p.t0 + ((double)s + p.node[g]) * p.dt;
  const int nn = p.n * p.n;
  float2* out = p.table + (size_t)sg * (p.k + 1) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const double ph = fmod(p.omega[e] * tau, kTwoPi);
    const float cp = (float)cos(ph), sp = (float)sin(ph);
    float ar = p.statr[e], ai = p.stati[e];
    out[e] = make_float2(ar * cp - ai * sp, ar * sp + ai * cp);
    for (int j = 0; j < p.k; ++j) {
      ar = p.opsr[(size_t)j * nn + e];
      ai = p.opsi[(size_t)j * nn + e];
      out[(size_t)(1 + j) * nn + e] = make_float2(ar * cp - ai * sp, ar * sp + ai * cp);
    }
  }
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

// acc (+ or -)= a * b
template <bool NEG>
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  if (NEG) {
    acc.x = fmaf(-a.x, b.x, acc.x);
    acc.x = fmaf(a.y, b.y, acc.x);
    acc.y = fmaf(-a.x, b.y, acc.y);
    acc.y = fmaf(-a.y, b.x, acc.y);
  } else {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
  }
}

// acc[r][c] (+ or -)= sum_m A[row_r, m] B[m, col_c] for this thread's 4 x 4
// tile; ro[r] = row_r * ld and co[c] = col_c are clamped into the matrix.
template <bool NEG>
__device__ __forceinline__ void panel_product(const float2* A, const float2* B, int n, int ld,
                                              const int (&ro)[4], const int (&co)[4],
                                              float2 (&acc)[4][4]) {
#pragma unroll 2
  for (int m = 0; m < n; ++m) {
    float2 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[ro[r] + m];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[m * ld + co[c]];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) cmac<NEG>(acc[r][c], a[r], b[c]);
    }
  }
}

// f(i, j) for every matrix entry, the block's threads as a 16 x 16 grid
// (consecutive threads on consecutive columns)
template <class F>
__device__ __forceinline__ void for_each_entry(int n, F f) {
  for (int i = threadIdx.x / 16; i < n; i += 16) {
    for (int j = threadIdx.x % 16; j < n; j += 16) f(i, j);
  }
}

// OUT <- [A, B] = A B - B A (with herm: P - P^H, P = A B, for anti-Hermitian
// A and B). OUT may be one of the operands only when n <= kPanel: the single
// panel's results wait in registers until every thread has read its operands.
// Ends with a barrier.
__device__ __forceinline__ void commutator(const float2* A, const float2* B, float2* OUT, int n, int ld,
                           bool herm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i0 = 0; i0 < n; i0 += kPanel) {
    for (int j0 = 0; j0 < n; j0 += kPanel) {
      int ro[4], co[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ro[r] = min(i0 + ty + 16 * r, n - 1) * ld;
        co[r] = min(j0 + tx + 16 * r, n - 1);
      }
      float2 acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = make_float2(0.0f, 0.0f);
      }
      panel_product<false>(A, B, n, ld, ro, co, acc);
      if (!herm) panel_product<true>(B, A, n, ld, ro, co, acc);
      __syncthreads();  // every thread has read its operands
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          if (i < n && j < n) OUT[i * ld + j] = acc[r][c];
        }
      }
    }
  }
  __syncthreads();
  if (herm) {  // OUT holds P; each thread finishes whole (i, j), (j, i) pairs
    for_each_entry(n, [&](int i, int j) {
      if (i > j) return;
      const float2 pij = OUT[i * ld + j], pji = OUT[j * ld + i];
      OUT[i * ld + j] = make_float2(pij.x - pji.x, pij.y + pji.y);
      OUT[j * ld + i] = make_float2(pji.x - pij.x, pji.y + pij.y);
    });
    __syncthreads();
  }
}

// G_g[e] for table entry e at Gauss point g: R_0 + sum_j c_j R_{1+j}
__device__ __forceinline__ float2 generator_entry(const float2* tab, const float* csh, int g, int k,
                                                  int nn, int e) {
  const float2* t = tab + (size_t)g * (k + 1) * nn;
  float2 acc = t[e];
  for (int j = 0; j < k; ++j) {
    const float c = csh[g * k + j];
    const float2 o = t[(size_t)(1 + j) * nn + e];
    acc.x = fmaf(c, o.x, acc.x);
    acc.y = fmaf(c, o.y, acc.y);
  }
  return acc;
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads) member_sweep_kernel(SweepParams p) {
  extern __shared__ float2 smem[];
  const int n = p.n, k = p.k, nn = n * n, ld = row_stride(n);
  const int tid = threadIdx.x;
  const size_t msz = (size_t)n * ld;
  float2* vecs = SMEM ? smem + matrix_elems(n, p.magnus) : smem;
  float2* mats = SMEM ? smem : p.scratch + (size_t)blockIdx.x * matrix_elems(n, p.magnus);
  float2* b0 = mats;
  float2* b1 = mats + msz;
  float2* b2 = mats + 2 * msz;
  float2* b3 = mats + 3 * msz;  // Magnus-3 only
  float2* b4 = mats + 4 * msz;

  // Horner mat-vec: thread (hi, hp) sums row hi over the hp-th part of the columns
  const int nr = padded_rows(n), nparts = kThreads / nr;
  const int hi = tid % nr, hp = tid / nr;
  const int chunk = (n + nparts - 1) / nparts;
  const int j_lo = min(hp * chunk, n), j_hi = min(j_lo + chunk, n);
  const bool h_active = hp < nparts && hi < n;
  float2* v = vecs;
  float2* partial = vecs + n;
  float* csh = reinterpret_cast<float*>(partial + (size_t)nparts * nr);
  const int gauss = p.magnus;
  const bool herm = p.hermitian != 0;

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    float2 y = make_float2(0.0f, 0.0f);
    if (tid < n) y = make_float2(p.y0r[(size_t)tid * p.B + b], p.y0i[(size_t)tid * p.B + b]);

    for (int s = 0; s < p.T; ++s) {
      __syncthreads();  // the previous step is done with every buffer
      if (tid < gauss * k) csh[tid] = p.coef[((size_t)s * gauss * k + tid) * p.B + b];
      __syncthreads();
      const float2* tab = p.table + (size_t)s * gauss * (k + 1) * nn;
      const float2* M;

      if (p.magnus == 2) {
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j, e = i * n + j;
          b0[at] = generator_entry(tab, csh, 0, k, nn, e);
          b1[at] = generator_entry(tab, csh, 1, k, nn, e);
        });
        __syncthreads();
        commutator(b1, b0, b2, n, ld, herm);  // [G2, G1]
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j;
          b2[at] = cadd(cscale(p.c1, cadd(b0[at], b1[at])), cscale(p.c2, b2[at]));
        });
        M = b2;
      } else {
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j, e = i * n + j;
          const float2 g1 = generator_entry(tab, csh, 0, k, nn, e);
          const float2 g2 = generator_entry(tab, csh, 1, k, nn, e);
          const float2 g3 = generator_entry(tab, csh, 2, k, nn, e);
          b0[at] = cscale(p.c0dt, csub(g3, g1));                                    // a2
          b1[at] = cscale(p.dtf, g2);                                               // a1
          b2[at] = cscale(p.c1dt, cadd(csub(g3, cscale(2.0f, g2)), g1));            // a3
        });
        __syncthreads();
        commutator(b1, b0, b3, n, ld, herm);  // C1 = [a1, a2]
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j;
          const float2 a1 = b1[at], a3 = b2[at], c1 = b3[at];
          b4[at] = cadd(a1, cscale(1.0f / 12.0f, a3));                // M so far
          b3[at] = cadd(csub(cscale(-20.0f, a1), a3), c1);            // Y
          b2[at] = cadd(cscale(2.0f, a3), c1);                        // X
        });
        __syncthreads();
        commutator(b2, b1, b2, n, ld, herm);  // [X, a1], in place over X
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j;
          b0[at] = cadd(b0[at], cscale(1.0f / 60.0f, b2[at]));  // Z = a2 + C2
        });
        __syncthreads();
        commutator(b3, b0, b1, n, ld, herm);  // [Y, Z] over a1, which is dead
        for_each_entry(n, [&](int i, int j) {
          const int at = i * ld + j;
          b4[at] = cadd(b4[at], cscale(1.0f / 240.0f, b1[at]));
        });
        M = b4;
      }

      // y <- sum_{j <= order} M^j y / j!
      if (tid < n) v[tid] = y;
      float2 vt = y;
      for (int kk = p.order; kk >= 1; --kk) {
        const float inv = (float)(1.0 / (double)kk);
        __syncthreads();  // M and v are complete
        if (h_active) {
          float2 acc = make_float2(0.0f, 0.0f);
          const float2* row = M + (size_t)hi * ld;
          for (int j = j_lo; j < j_hi; ++j) cmac<false>(acc, row[j], v[j]);
          partial[hp * nr + hi] = acc;
        }
        __syncthreads();  // partial sums are complete; v is no longer read
        if (tid < n) {
          float2 w = partial[tid];
          for (int q = 1; q < nparts; ++q) w = cadd(w, partial[q * nr + tid]);
          vt = make_float2(fmaf(inv, w.x, y.x), fmaf(inv, w.y, y.y));
          v[tid] = vt;
        }
      }
      y = vt;
    }
    if (tid < n) {
      p.outr[(size_t)tid * p.B + b] = y.x;
      p.outi[(size_t)tid * p.B + b] = y.y;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one block: matrices and vectors when the
// matrices live in shared memory, the vectors alone otherwise.
size_t member_sweep_smem_bytes(int n, int k, int magnus, int in_shared) {
  return sizeof(float2) * ((in_shared ? matrix_elems(n, magnus) : 0) + vector_elems(n, k));
}

// float2 elements of one block's matrices (the wrapper sizes the scratch with it).
size_t member_sweep_matrix_elems(int n, int magnus) { return matrix_elems(n, magnus); }

// float2 elements of the rotated tables.
size_t member_sweep_table_elems(int n, int k, int T, int magnus) {
  return (size_t)T * magnus * (k + 1) * n * n;
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
  TableParams tp{statr, stati, opsr, opsi, omega, table, n, k, T, magnus, dt, t0,
                 {node0, node1, node2}};
  member_tables_kernel<<<T * magnus, kThreads, 0, st>>>(tp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  SweepParams sp{table, coef, y0r, y0i, outr, outi, scratch, n, k, T, B, order, magnus,
                 hermitian, c1, c2, dtf, c0dt, c1dt};
  const size_t smem = member_sweep_smem_bytes(n, k, magnus, in_shared);
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
