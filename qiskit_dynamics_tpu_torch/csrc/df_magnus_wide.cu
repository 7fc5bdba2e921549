// Fixed-step Magnus-2/3 sweep in native FP64 above n = 32, for Hopper (sm_90a).
//
// The second sweep of kernel B8: csrc/df_magnus_sweep.cu runs n <= 32 (one
// warp per member, products on the FP64 tensor cores, planes padded to 32);
// this file runs 32 < n <= 256, the solve dimensions of vectorized Lindblad
// models of dim 6 to 16. Together they replace the TPU kernel
// qiskit_dynamics_tpu/ops/df_sweep_pallas.py:78 (_kernel, Pallas, launched by
// sweep_expm_magnus_df_pallas) and the XLA engine of
// qiskit_dynamics_tpu/ops/df_sweep.py, which take any n. Wrapper and plain
// version: qiskit_dynamics_tpu_torch/ops/df_sweep.py (kernel_for picks the
// file by n).
//
// What it computes: df_magnus_sweep.cu's step rule and Horner action, with
// the frame phases formed in the kernel instead of from tables.
//
// What bounds it on this card. Operations: per member-step three (Magnus-2:
// one) commutators of 8 n^3 FP64 operations each (two products without
// `herm`), the Horner mat-vecs (8 n^2 each) and n^2 phase evaluations per
// node. This first design runs its products on the FP64 pipes, not the
// tensor cores, and its planes leave shared memory above n = 45.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 32;       // df_magnus_sweep.cu takes n up to here
constexpr int kWideMaxN = 256;
constexpr int kWideThreads = 256;
constexpr int kWidePlanes = 7;  // n x n planes of a member
constexpr size_t kWideSharedLimit = 232448;  // dynamic shared memory a block may use
constexpr double kTwoPi = 6.283185307179586;

// Design. The same step rule for any n up to kWideMaxN, with the plain version's
// operations: a block of kWideThreads threads runs one member at a time
// (persistent blocks walk over the members). The member's matrices are
// row-major n x n planes in shared memory while kWidePlanes of them fit a
// block (n <= 45), else in the block's region of a device work buffer; the
// state, the Horner vectors and the step's coefficients are in shared memory.
// A thread owns the entries e = tid, tid + kWideThreads, ... of every plane:
// the generator build (phases cos/sin(fmod(omega tau, 2 pi)) formed in place,
// no tables), the elementwise terms of the rule and the products (each entry
// a dot product over m in order, FP64 fused multiply-adds) touch only those,
// and a block barrier separates a product from the reads of its result. The
// Horner mat-vec gives a thread the rows i = tid, tid + kWideThreads, ...
struct WideParams {
  const double2* stat;  // (n, n)
  const double2* ops;   // (k, n, n)
  const double* omega;  // (n, n)
  const double* taus;   // (T, nn) absolute node times
  const double* sc;     // (T, 3) step constants
  const double* coef;   // (T, nn, k, ldb)
  const int* slots;     // (T,) or null
  const double2* y0;    // (n, ldb)
  double2* out;         // (n, ldb)
  double2* evals;       // (n_eval, n, ldb), or null
  double2* work;        // (blocks, kWidePlanes, n, n), or null: the planes in shared memory
  int n, k, T, nn, order, herm, b0, nb, ldb;
};

// Z = X Y, or with `minus` X Y - Y X, at the thread's entries; then a barrier.
__device__ __forceinline__ void wide_product(const double2* X, const double2* Y, double2* Z,
                                             int n, bool minus) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    double zr = 0.0, zi = 0.0;
    for (int m = 0; m < n; ++m) {
      const double2 x = X[i * n + m], y = Y[m * n + j];
      zr = fma(x.x, y.x, zr);
      zr = fma(-x.y, y.y, zr);
      zi = fma(x.x, y.y, zi);
      zi = fma(x.y, y.x, zi);
      if (minus) {
        const double2 u = Y[i * n + m], v = X[m * n + j];
        zr = fma(-u.x, v.x, zr);
        zr = fma(u.y, v.y, zr);
        zi = fma(-u.x, v.y, zi);
        zi = fma(-u.y, v.x, zi);
      }
    }
    Z[e] = make_double2(zr, zi);
  }
  __syncthreads();
}

// Z = [X, Y]: with `herm` C = X Y into `tmp`, then C - C^H; else X Y - Y X.
__device__ __forceinline__ void wide_comm(const double2* X, const double2* Y, double2* Z,
                                          double2* tmp, int n, bool herm) {
  if (!herm) {
    wide_product(X, Y, Z, n, true);
    return;
  }
  wide_product(X, Y, tmp, n, false);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    const double2 c = tmp[e], ct = tmp[j * n + i];
    Z[e] = make_double2(c.x - ct.x, c.y + ct.y);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kWideThreads) df_magnus_wide_kernel(WideParams p) {
  extern __shared__ double2 wsmem[];
  const int n = p.n, k = p.k, nn = p.nn, nsq = n * n, nk = nn * k, tid = threadIdx.x;
  double2* y = wsmem;  // three vectors of n: the state and the Horner double buffer
  double* cbuf = reinterpret_cast<double*>(wsmem + 3 * n);
  double2* P = p.work != nullptr ? p.work + (size_t)blockIdx.x * kWidePlanes * nsq
                                 : wsmem + 3 * n + (nk + 1) / 2;
  double2 *P0 = P, *P1 = P + nsq, *P2 = P + 2 * nsq, *P3 = P + 3 * nsq, *P4 = P + 4 * nsq,
          *P5 = P + 5 * nsq, *P6 = P + 6 * nsq;
  const bool herm = p.herm != 0;

  for (int mi = blockIdx.x; mi < p.nb; mi += gridDim.x) {
    const int member = p.b0 + mi;
    for (int i = tid; i < n; i += blockDim.x) y[i] = p.y0[(size_t)i * p.ldb + member];
    for (int s = 0; s < p.T; ++s) {
      for (int l = tid; l < nk; l += blockDim.x)
        cbuf[l] = p.coef[((size_t)s * nk + l) * p.ldb + member];
      const double sc0 = p.sc[3 * s], sc1 = p.sc[3 * s + 1], sc2 = p.sc[3 * s + 2];
      __syncthreads();  // the coefficients and the state are in; every plane is free

      // the generators G_g = P(tau_g) o (S + sum_j c_j O_j) into P0, P1 (, P2)
      for (int g = 0; g < nn; ++g) {
        const double tau = p.taus[s * nn + g];
        double2* Z = g == 0 ? P0 : (g == 1 ? P1 : P2);
        for (int e = tid; e < nsq; e += blockDim.x) {
          double2 a = p.stat[e];
          for (int j = 0; j < k; ++j) {
            const double c = cbuf[g * k + j];
            const double2 o = p.ops[(size_t)j * nsq + e];
            a.x = fma(c, o.x, a.x);
            a.y = fma(c, o.y, a.y);
          }
          double sv, cv;
          sincos(fmod(p.omega[e] * tau, kTwoPi), &sv, &cv);
          Z[e] = make_double2(cv * a.x - sv * a.y, cv * a.y + sv * a.x);
        }
      }
      __syncthreads();

      const double2* M;
      if (nn == 2) {  // M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1], into P0
        wide_comm(P1, P0, P2, P3, n, herm);
        for (int e = tid; e < nsq; e += blockDim.x) {
          const double2 g1 = P0[e], g2 = P1[e], c = P2[e];
          P0[e] = make_double2((g1.x + g2.x) * sc0 + c.x * sc1, (g1.y + g2.y) * sc0 + c.y * sc1);
        }
        M = P0;
      } else {
        for (int e = tid; e < nsq; e += blockDim.x) {  // P0 = a1, P1 = a2, P2 = a3
          const double2 g1 = P0[e], g2 = P1[e], g3 = P2[e];
          P0[e] = make_double2(g2.x * sc0, g2.y * sc0);
          P1[e] = make_double2((g3.x - g1.x) * sc1, (g3.y - g1.y) * sc1);
          P2[e] = make_double2(((g3.x - g2.x) + (g1.x - g2.x)) * sc2,
                               ((g3.y - g2.y) + (g1.y - g2.y)) * sc2);
        }
        __syncthreads();
        wide_comm(P0, P1, P3, P5, n, herm);  // P3 = [a1, a2]
        for (int e = tid; e < nsq; e += blockDim.x) {  // P4 = 2 a3 + [a1, a2]
          const double2 a3 = P2[e], c1 = P3[e];
          P4[e] = make_double2(2.0 * a3.x + c1.x, 2.0 * a3.y + c1.y);
        }
        __syncthreads();
        wide_comm(P4, P0, P6, P5, n, herm);  // P6 = [2 a3 + [a1, a2], a1]
        for (int e = tid; e < nsq; e += blockDim.x) {
          const double2 a1 = P0[e], a2 = P1[e], a3 = P2[e], c1 = P3[e], c2 = P6[e];
          P1[e] = make_double2(a2.x + c2.x * (1.0 / 60.0), a2.y + c2.y * (1.0 / 60.0));  // right
          P3[e] = make_double2(c1.x - (20.0 * a1.x + a3.x), c1.y - (20.0 * a1.y + a3.y));  // left
          P0[e] = make_double2(a1.x + a3.x * (1.0 / 12.0), a1.y + a3.y * (1.0 / 12.0));
        }
        __syncthreads();
        wide_comm(P3, P1, P6, P5, n, herm);  // P6 = [left, right]
        for (int e = tid; e < nsq; e += blockDim.x) {  // M = a1 + a3 / 12 + [left, right] / 240
          const double2 s3 = P0[e], c3 = P6[e];
          P0[e] = make_double2(s3.x + c3.x * (1.0 / 240.0), s3.y + c3.y * (1.0 / 240.0));
        }
        M = P0;
      }
      __syncthreads();  // M is complete

      // y <- sum_j M^j y / j! by v = y + (M v) / j, j = order .. 1
      double2* vin = y;
      for (int j = p.order; j >= 1; --j) {
        const double inv = 1.0 / (double)j;
        double2* vout = y + n * (j % 2 == p.order % 2 ? 1 : 2);
        for (int i = tid; i < n; i += blockDim.x) {
          double wr = 0.0, wi = 0.0;
          for (int m = 0; m < n; ++m) {
            const double2 a = M[i * n + m], x = vin[m];
            wr = fma(a.x, x.x, wr);
            wr = fma(-a.y, x.y, wr);
            wi = fma(a.x, x.y, wi);
            wi = fma(a.y, x.x, wi);
          }
          vout[i] = make_double2(y[i].x + wr * inv, y[i].y + wi * inv);
        }
        __syncthreads();
        vin = vout;
      }
      for (int i = tid; i < n; i += blockDim.x) {
        const double2 v = vin[i];
        y[i] = v;
        if (p.slots != nullptr) {
          const int slot_s = p.slots[s];
          if (slot_s >= 0) p.evals[((size_t)slot_s * n + i) * p.ldb + member] = v;
        }
      }
      // the next step's first barrier orders these writes before any read of y
    }
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) p.out[(size_t)i * p.ldb + member] = y[i];
    __syncthreads();  // the next member overwrites y
  }
}

// A launch of the wide kernel over nb members: blocks, dynamic shared memory
// and whether the planes are in device memory; blocks = 0 where it cannot run.
struct WideShape {
  int blocks;
  size_t smem;
  bool in_device;
};

WideShape wide_shape(int n, int k, int nn, int nb) {
  WideShape sh{0, 0, false};
  int device = 0, sms = 0;
  if (n < 1 || n > kWideMaxN || nb < 1 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return sh;
  const size_t small = sizeof(double2) * (3 * (size_t)n + ((size_t)nn * k + 1) / 2);
  const size_t planes = sizeof(double2) * (size_t)kWidePlanes * n * n;
  sh.in_device = small + planes > kWideSharedLimit;
  sh.smem = sh.in_device ? small : small + planes;
  // two blocks an SM where the planes are in device memory (each block's
  // region of the work buffer stays in L2), else as many as fit, up to 4
  size_t per_sm = sh.in_device ? 2 : kWideSharedLimit / (sh.smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
  const long long resident = (long long)sms * (long long)per_sm;
  sh.blocks = (int)(nb < resident ? nb : resident);
  return sh;
}

}  // namespace

extern "C" {

// Bytes of the device work buffer of a launch of the wide kernel (n > 32)
// over nb members: 0 where its planes are in shared memory, -1 where it
// cannot run.
long long df_magnus_wide_work_bytes(int n, int k, int nn, int nb) {
  const WideShape sh = wide_shape(n, k, nn, nb);
  if (sh.blocks < 1) return -1;
  return sh.in_device ? (long long)sh.blocks * kWidePlanes * n * n * (long long)sizeof(double2)
                      : 0;
}

// The sweep above n = 32 over the lanes [b0, b0 + nb) of rows of length ldb,
// on `stream`, from the untabled operators: persistent blocks of kWideThreads,
// one member at a time. Returns the CUDA error code of the launch.
int df_magnus_wide_launch(const void* stat, const void* ops, const double* omega,
                          const double* taus, const double* sc, const double* coef,
                          const int* slots, const void* y0, void* out, void* evals, void* work,
                          int n, int k, int T, int nn, int order, int herm, int b0, int nb,
                          int ldb, void* stream) {
  if (n <= kMaxN || n > kWideMaxN || k < 0 || T < 1 || (nn != 2 && nn != 3) || order < 1 ||
      b0 < 0 || nb < 1 || b0 + nb > ldb) {
    return (int)cudaErrorInvalidValue;
  }
  const WideShape sh = wide_shape(n, k, nn, nb);
  if (sh.blocks < 1 || (sh.in_device && work == nullptr)) return (int)cudaErrorInvalidValue;
  WideParams p{(const double2*)stat, (const double2*)ops, omega, taus, sc, coef, slots,
               (const double2*)y0, (double2*)out, (double2*)evals,
               sh.in_device ? (double2*)work : nullptr, n, k, T, nn, order, herm ? 1 : 0, b0, nb,
               ldb};
  cudaError_t err = cudaFuncSetAttribute(df_magnus_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  df_magnus_wide_kernel<<<sh.blocks, kWideThreads, sh.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* df_magnus_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
