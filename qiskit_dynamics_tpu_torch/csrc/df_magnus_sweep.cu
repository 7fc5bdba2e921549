// Fixed-step Magnus-2/3 sweep in native FP64, for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/df_sweep_pallas.py:78
// (_kernel, Pallas, launched by sweep_expm_magnus_df_pallas) and the XLA
// engine of qiskit_dynamics_tpu/ops/df_sweep.py (sweep_expm_magnus_df): both
// run the sweep in double-float32 because the TPU has no FP64. This card has
// FP64, so the same arithmetic runs here in float64/complex128, one kernel for
// both engines. Wrapper and plain version: qiskit_dynamics_tpu_torch/ops/df_sweep.py.
//
// What it computes. For every sweep member b and every step s of a possibly
// non-uniform grid, at the Gauss nodes tau_g = t_s + x_g dt_s (g < nn, nn = 2 or 3):
//   G_g = P(tau_g) o (S + sum_j c[s, g, j, b] O_j),  P(tau)[i,m] = exp(i omega[i,m] tau),
// the Magnus rule
//   nn = 2:  M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1]
//   nn = 3:  a1 = dt G_2, a2 = c0 dt (G_3 - G_1), a3 = c1 dt ((G_3 - G_2) + (G_1 - G_2)),
//            l = [a1, a2] - (20 a1 + a3),  r = a2 + [2 a3 + [a1, a2], a1] / 60,
//            M = a1 + a3 / 12 + [l, r] / 240
// (the rules of df_sweep_pallas.py:174-239), then y <- sum_{j <= order} M^j y / j!
// by the Horner mat-vec v = y; v = y + (M v) / j, j = order..1 (:241-251); the
// propagator is never formed. With `herm` (anti-Hermitian generators, which
// every commutator of the rules then is too) each commutator is one product:
// [X, Y] = C - C^H with C = X Y. Marked steps store y into a trajectory.
// The frame phases are formed here in float64, cos/sin(fmod(omega tau, 2 pi)),
// once per Gauss node per step per block, from the caller's float64 node times.
//
// Mapping (the pattern of csrc/sweep_magnus2.cu, four threads to a row). One
// block holds MB <= 8 members and 4 n MB threads; thread (i, q, b) owns the
// columns c = q (mod 4) of row i of member b (lane order: b fastest, then q,
// then i, so the four threads of a row sit in one warp). Each member's
// matrices live in shared memory as [row][col][member] planes of doubles (real
// and imaginary apart), member index fastest, row stride padded to MB mod 16
// doubles so that the threads of a half-warp hit distinct banks reading their
// own rows, a transposed column, or one entry per member (a broadcast over
// rows and over q). A Horner mat-vec sums a quarter of the row in each thread
// and adds the quarters with two warp shuffles. Matrices: 3 for
// Magnus-2, 5 for Magnus-3, 6 for Magnus-3 with `herm` (the transposed reads of
// C - C^H need C complete before it is overwritten). The static operator and
// the operators are read from device memory (one copy shared by all members,
// so they stay in L1). The state entry y[i] stays in a register; the Horner
// vector is exchanged through shared memory, double buffered. The lanes
// [b0, b0 + nb) of a row of length ldb are this launch's members; the last
// block computes on a copy of its last member and stores nothing for the rest.
//
// What bounds it on this card. Operations. At the main row (n = 16, k = 2,
// Magnus-3 with `herm`, order 12) a member-step is three n^3 complex products
// (32.8 kFLOP each), twelve mat-vecs (2.1 kFLOP each), the generator builds and
// the rule's elementwise terms: 1.43e5 FP64 operations against 96 bytes of
// coefficients. The 9.8e4 of the products could run at 67 TFLOP/s on the FP64
// tensor cores, the rest at 34 TFLOP/s, so 10,000 members x 500 steps take at
// least 13.9 ms and their 240 MB of coefficients ~0.07 ms at 3.35 TB/s. This
// simple design reads four shared-memory doubles per complex multiply-add and
// holds 8 members (226 KB) per SM at n = 16, so shared-memory latency and FP64
// latency, not the FP64 rate, limit it (the first version, one thread per row
// with 4 warps per SM, ran 48x its bound); register tiles and DMMA (FP64
// tensor cores) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxThreads = 512;
constexpr int kSplit = 4;   // threads per (row, member)
constexpr int kMaxMb = 8;   // a row's kSplit threads share a warp: kSplit * mb <= 32
constexpr double kTwoPi = 6.283185307179586;

struct Params {
  const double2* stat;  // (n, n) complex128
  const double2* ops;   // (k, n, n)
  const double* omega;  // (n, n)
  const double* taus;   // (T, nn) absolute node times
  const double* sc;     // (T, 3) step constants: (dt/2, p2 dt^2, -) or (dt, c0 dt, c1 dt)
  const double* coef;   // (T, nn, k, ldb)
  const int* slots;     // (T,) trajectory slot after each step (-1: none), or null
  const double2* y0;    // (n, ldb)
  double2* out;         // (n, ldb)
  double2* evals;       // (n_eval, n, ldb), or null
  int n, k, T, nn, order, herm, mb, b0, nb, ldb;
};

// Row stride of a [row][col][member] plane, in doubles: n*mb padded to = mb (mod 16).
__host__ __device__ inline int row_stride(int n, int mb) {
  const int rs = n * mb;
  return rs + (((mb - rs) % 16) + 16) % 16;
}

__host__ __device__ inline int matrices(int nn, int herm) {
  return nn == 2 ? 3 : (herm ? 6 : 5);
}

// Shared-memory doubles of one block: phase tables, coefficients, matrix
// planes, two vector buffers.
__host__ __device__ inline size_t smem_doubles(int n, int k, int nn, int herm, int mb) {
  return (size_t)2 * nn * n * n + (size_t)nn * k * mb +
         (size_t)matrices(nn, herm) * 2 * n * row_stride(n, mb) + (size_t)4 * n * mb;
}

struct Plane {  // a complex [row][col][member] plane in shared memory
  double* r;
  double* i;
};

struct Me {  // this thread: the columns q (mod kSplit) of row `row` of member `b`
  int n, rs, mb, row, q, b;
  __device__ int at(int i, int c) const { return i * rs + c * mb + b; }
};

// Z[row, c] = (X @ Y)[row, c] for this thread's columns, summed over the inner
// index in order.
__device__ __forceinline__ void product_row(const Me& me, Plane X, Plane Y, Plane Z) {
  for (int c = me.q; c < me.n; c += kSplit) {
    double ar = 0.0, ai = 0.0;
    for (int m = 0; m < me.n; ++m) {
      const int a = me.at(me.row, m), y = me.at(m, c);
      const double xr = X.r[a], xi = X.i[a], yr = Y.r[y], yi = Y.i[y];
      ar += xr * yr - xi * yi;
      ai += xr * yi + xi * yr;
    }
    Z.r[me.at(me.row, c)] = ar;
    Z.i[me.at(me.row, c)] = ai;
  }
}

// (X @ Y - Y @ X)[row, c]
__device__ __forceinline__ double2 commutator_entry(const Me& me, Plane X, Plane Y, int c) {
  double ar = 0.0, ai = 0.0;
  for (int m = 0; m < me.n; ++m) {
    const int xa = me.at(me.row, m), yb = me.at(m, c);
    ar += X.r[xa] * Y.r[yb] - X.i[xa] * Y.i[yb];
    ai += X.r[xa] * Y.i[yb] + X.i[xa] * Y.r[yb];
  }
  for (int m = 0; m < me.n; ++m) {
    const int ya = me.at(me.row, m), xb = me.at(m, c);
    ar -= Y.r[ya] * X.r[xb] - Y.i[ya] * X.i[xb];
    ai -= Y.r[ya] * X.i[xb] + Y.i[ya] * X.r[xb];
  }
  return make_double2(ar, ai);
}

// (C - C^H)[row, c] for a complete C
__device__ __forceinline__ double2 anti_part(const Me& me, Plane C, int c) {
  const int e = me.at(me.row, c), t = me.at(c, me.row);
  return make_double2(C.r[e] - C.r[t], C.i[e] + C.i[t]);
}

__global__ void __launch_bounds__(kMaxThreads) df_magnus_sweep_kernel(Params p) {
  extern __shared__ double smem[];
  const int n = p.n, k = p.k, nn = p.nn, nsq = n * n, mb = p.mb;
  const int rs = row_stride(n, mb);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const Me me{n, rs, mb, tid / (kSplit * mb), (tid / mb) % kSplit, tid % mb};
  const int row = me.row, q0 = me.q;
  // the lanes of this warp that exist (the last warp of a block may be partial;
  // it holds whole groups of a row's kSplit threads)
  const int warp_base = tid & ~31;
  const int warp_lanes = min(32, nthreads - warp_base);
  const unsigned warp_mask = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
  const int end = p.b0 + p.nb;
  const int lane = p.b0 + blockIdx.x * mb + me.b;
  const bool valid = lane < end;
  const int lane_ld = valid ? lane : end - 1;
  const int ldb = p.ldb;

  double* cph = smem;                       // cos of the frame phases, (nn, n, n)
  double* sph = cph + (size_t)nn * nsq;     // sin
  double* csh = sph + (size_t)nn * nsq;     // coefficients (nn, k, mb)
  double* mat = csh + (size_t)nn * k * mb;  // matrix planes
  const size_t msz = (size_t)n * rs;
  Plane m[6];  // only the first matrices(nn, herm) are used
#pragma unroll
  for (int q = 0; q < 6; ++q) m[q] = Plane{mat + 2 * q * msz, mat + (2 * q + 1) * msz};
  double* vec = mat + (size_t)2 * matrices(nn, p.herm) * msz;
  const int vsz = n * mb;
  Plane va{vec, vec + vsz}, vb{vec + 2 * vsz, vec + 3 * vsz};
  const int own = row * mb + me.b;  // this thread's entry of a vector plane

  double2 y = p.y0[(size_t)row * ldb + lane_ld];

  for (int s = 0; s < p.T; ++s) {
    __syncthreads();  // the previous step is done with every table and plane
    for (int idx = tid; idx < nn * nsq; idx += nthreads) {
      const double tau = p.taus[s * nn + idx / nsq];
      const double ph = fmod(p.omega[idx % nsq] * tau, kTwoPi);
      double sv, cv;
      sincos(ph, &sv, &cv);
      cph[idx] = cv;
      sph[idx] = sv;
    }
    for (int idx = tid; idx < nn * k * mb; idx += nthreads) {
      const int gj = idx / mb, l = min(p.b0 + (int)blockIdx.x * mb + idx % mb, end - 1);
      csh[idx] = p.coef[((size_t)s * nn * k + gj) * ldb + l];
    }
    const double sc0 = p.sc[3 * s], sc1 = p.sc[3 * s + 1], sc2 = p.sc[3 * s + 2];
    __syncthreads();

    // generators at the Gauss nodes, row `row`: G_g = P_g o (S + sum_j c_gj O_j)
    for (int c = q0; c < n; c += kSplit) {
      const int idx = row * n + c;
      const double2 st = __ldg(&p.stat[idx]);
      double2 g[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q >= nn) break;
        double accr = st.x, acci = st.y;
        for (int j = 0; j < k; ++j) {
          const double cf = csh[(q * k + j) * mb + me.b];
          const double2 op = __ldg(&p.ops[(size_t)j * nsq + idx]);
          accr += cf * op.x;
          acci += cf * op.y;
        }
        const double cp = cph[q * nsq + idx], sp = sph[q * nsq + idx];
        g[q] = make_double2(accr * cp - acci * sp, accr * sp + acci * cp);
      }
      const int e = me.at(row, c);
      if (nn == 2) {
        m[0].r[e] = g[0].x;
        m[0].i[e] = g[0].y;
        m[1].r[e] = g[1].x;
        m[1].i[e] = g[1].y;
      } else {  // a1, a2, a3 straight from the three node values
        m[0].r[e] = sc0 * g[1].x;
        m[0].i[e] = sc0 * g[1].y;
        m[1].r[e] = sc1 * (g[2].x - g[0].x);
        m[1].i[e] = sc1 * (g[2].y - g[0].y);
        m[2].r[e] = sc2 * ((g[2].x - g[1].x) + (g[0].x - g[1].x));
        m[2].i[e] = sc2 * ((g[2].y - g[1].y) + (g[0].y - g[1].y));
      }
    }
    __syncthreads();

    Plane M;
    if (nn == 2) {
      if (p.herm) {  // m2 = G2 G1; M = dt/2 (G1 + G2) + p2 dt^2 (m2 - m2^H), into G2
        product_row(me, m[1], m[0], m[2]);
        __syncthreads();
        for (int c = q0; c < n; c += kSplit) {
          const int e = me.at(row, c);
          const double2 kc = anti_part(me, m[2], c);
          m[1].r[e] = sc0 * (m[0].r[e] + m[1].r[e]) + sc1 * kc.x;
          m[1].i[e] = sc0 * (m[0].i[e] + m[1].i[e]) + sc1 * kc.y;
        }
        M = m[1];
      } else {
        for (int c = q0; c < n; c += kSplit) {
          const int e = me.at(row, c);
          const double2 kc = commutator_entry(me, m[1], m[0], c);
          m[2].r[e] = sc0 * (m[0].r[e] + m[1].r[e]) + sc1 * kc.x;
          m[2].i[e] = sc0 * (m[0].i[e] + m[1].i[e]) + sc1 * kc.y;
        }
        M = m[2];
      }
    } else if (p.herm) {
      // m0..m2 = a1..a3; m3, m4, m5 scratch
      product_row(me, m[0], m[1], m[3]);  // C1 = a1 a2
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m4 = [a1, a2] = C1 - C1^H
        const int e = me.at(row, c);
        const double2 kc = anti_part(me, m[3], c);
        m[4].r[e] = kc.x;
        m[4].i[e] = kc.y;
      }
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m3 = 2 a3 + [a1, a2]; m4 = left
        const int e = me.at(row, c);
        const double k1r = m[4].r[e], k1i = m[4].i[e];
        m[3].r[e] = 2.0 * m[2].r[e] + k1r;
        m[3].i[e] = 2.0 * m[2].i[e] + k1i;
        m[4].r[e] = k1r - (20.0 * m[0].r[e] + m[2].r[e]);
        m[4].i[e] = k1i - (20.0 * m[0].i[e] + m[2].i[e]);
      }
      __syncthreads();
      product_row(me, m[3], m[0], m[5]);  // C2 = (2 a3 + [a1, a2]) a1
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m1 = right = a2 + (C2 - C2^H) / 60
        const int e = me.at(row, c);
        const double2 kc = anti_part(me, m[5], c);
        m[1].r[e] = m[1].r[e] + kc.x * (1.0 / 60.0);
        m[1].i[e] = m[1].i[e] + kc.y * (1.0 / 60.0);
      }
      __syncthreads();
      product_row(me, m[4], m[1], m[3]);  // C3 = left right
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // M = a1 + a3 / 12 + (C3 - C3^H) / 240, into m5
        const int e = me.at(row, c);
        const double2 kc = anti_part(me, m[3], c);
        m[5].r[e] = (m[0].r[e] + m[2].r[e] * (1.0 / 12.0)) + kc.x * (1.0 / 240.0);
        m[5].i[e] = (m[0].i[e] + m[2].i[e] * (1.0 / 12.0)) + kc.y * (1.0 / 240.0);
      }
      M = m[5];
    } else {
      for (int c = q0; c < n; c += kSplit) {  // m3 = [a1, a2]
        const int e = me.at(row, c);
        const double2 kc = commutator_entry(me, m[0], m[1], c);
        m[3].r[e] = kc.x;
        m[3].i[e] = kc.y;
      }
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m4 = 2 a3 + [a1, a2]; m3 = left
        const int e = me.at(row, c);
        const double k1r = m[3].r[e], k1i = m[3].i[e];
        m[4].r[e] = 2.0 * m[2].r[e] + k1r;
        m[4].i[e] = 2.0 * m[2].i[e] + k1i;
        m[3].r[e] = k1r - (20.0 * m[0].r[e] + m[2].r[e]);
        m[3].i[e] = k1i - (20.0 * m[0].i[e] + m[2].i[e]);
      }
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m1 = right = a2 + [m4, a1] / 60
        const int e = me.at(row, c);
        const double2 kc = commutator_entry(me, m[4], m[0], c);
        m[1].r[e] = m[1].r[e] + kc.x * (1.0 / 60.0);
        m[1].i[e] = m[1].i[e] + kc.y * (1.0 / 60.0);
      }
      __syncthreads();
      for (int c = q0; c < n; c += kSplit) {  // m4 = [left, right]
        const int e = me.at(row, c);
        const double2 kc = commutator_entry(me, m[3], m[1], c);
        m[4].r[e] = kc.x;
        m[4].i[e] = kc.y;
      }
      // M = a1 + a3 / 12 + [left, right] / 240, in place (own entries only)
      for (int c = q0; c < n; c += kSplit) {
        const int e = me.at(row, c);
        m[4].r[e] = (m[0].r[e] + m[2].r[e] * (1.0 / 12.0)) + m[4].r[e] * (1.0 / 240.0);
        m[4].i[e] = (m[0].i[e] + m[2].i[e] * (1.0 / 12.0)) + m[4].i[e] * (1.0 / 240.0);
      }
      M = m[4];
    }

    // y <- expm(M) y by the Horner mat-vec; the four threads of a row each
    // sum a quarter of it and end with the same bits (the shuffles add the
    // same two operands in every lane)
    if (q0 == 0) {
      va.r[own] = y.x;
      va.i[own] = y.y;
    }
    Plane cur = va, nxt = vb;
    double2 v = y;
    for (int j = p.order; j >= 1; --j) {
      const double inv = 1.0 / (double)j;
      __syncthreads();  // M and the current vector are complete
      double wr = 0.0, wi = 0.0;
      for (int c = q0; c < n; c += kSplit) {
        const int e = me.at(row, c), x = c * mb + me.b;
        wr += M.r[e] * cur.r[x] - M.i[e] * cur.i[x];
        wi += M.r[e] * cur.i[x] + M.i[e] * cur.r[x];
      }
      for (int lanes = mb; lanes < kSplit * mb; lanes *= 2) {
        wr += __shfl_xor_sync(warp_mask, wr, lanes);
        wi += __shfl_xor_sync(warp_mask, wi, lanes);
      }
      v = make_double2(y.x + wr * inv, y.y + wi * inv);
      if (q0 == 0) {
        nxt.r[own] = v.x;
        nxt.i[own] = v.y;
      }
      const Plane t = cur;
      cur = nxt;
      nxt = t;
    }
    y = v;

    if (p.slots != nullptr && valid && q0 == 0) {
      const int slot = p.slots[s];
      if (slot >= 0) p.evals[((size_t)slot * n + row) * ldb + lane] = y;
    }
  }
  if (valid && q0 == 0) p.out[(size_t)row * ldb + lane] = y;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block (the wrapper sizes mb with it).
size_t df_magnus_sweep_smem_bytes(int n, int k, int nn, int herm, int mb) {
  return sizeof(double) * smem_doubles(n, k, nn, herm, mb);
}

// Launch ceil(nb / mb) blocks of 4 n mb threads on `stream` over the lanes
// [b0, b0 + nb) of rows of length ldb. Returns the CUDA error code of the
// launch (0 = cudaSuccess); faults during the run surface at the next
// synchronization.
int df_magnus_sweep_launch(const void* stat, const void* ops, const double* omega,
                           const double* taus, const double* sc, const double* coef,
                           const int* slots, const void* y0, void* out, void* evals, int n, int k,
                           int T, int nn, int order, int herm, int mb, int b0, int nb, int ldb,
                           void* stream) {
  if (n < 1 || n > kMaxN || k < 0 || T < 1 || (nn != 2 && nn != 3) || order < 1 || mb < 1 ||
      mb > kMaxMb || (mb & (mb - 1)) != 0 || kSplit * n * mb > kMaxThreads || b0 < 0 ||
      nb < 1 || b0 + nb > ldb) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{(const double2*)stat, (const double2*)ops, omega, taus, sc, coef, slots,
           (const double2*)y0, (double2*)out, (double2*)evals,
           n, k, T, nn, order, herm ? 1 : 0, mb, b0, nb, ldb};
  const size_t smem = df_magnus_sweep_smem_bytes(n, k, nn, herm, mb);
  cudaError_t err = cudaFuncSetAttribute(
      df_magnus_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  df_magnus_sweep_kernel<<<(nb + mb - 1) / mb, kSplit * n * mb, smem, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}

const char* df_magnus_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
