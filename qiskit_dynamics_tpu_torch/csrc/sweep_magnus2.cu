// Fixed-step Magnus-2 sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/sweep_solver.py::_kernel
// (Pallas, launched by sweep_expm_magnus2). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/sweep_solver.py.
//
// What it computes. For every sweep member b, T fixed steps of size dt:
//   G_g = P(tau_g) o (S + sum_j c_{b,j,g} O_j),  P(tau)[i,m] = exp(i omega[i,m] tau),
//   tau_g = t0 + (s + c_g) dt at the two Gauss points c_1, c_2,
//   M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1],
//   y <- sum_{j <= order} M^j y / j!  (Horner: v = y; v = y + (M v)/j, j = order..1),
// optionally storing y after marked steps into a trajectory. Three modes give
// the same polynomial rounded differently: "matrix" (commutator from two
// matmuls), "matrix_herm" (one matmul, [G_2, G_1] = P - P^H with P = G_2 G_1,
// valid for anti-Hermitian G), "matvec" (M never formed: each Horner term
// applies M v as four mat-vecs).
//
// Mapping. One block holds MB members (mb, chosen by the wrapper) and n*MB
// threads; thread (i, b) = threadIdx.x / MB, threadIdx.x % MB owns row i of
// member b. Each member's G_1, G_2 and M (or P) live in shared memory as
// [row][col][member] planes with the member index fastest; the row stride is
// padded so that the threads of a warp, which hold consecutive (row, member)
// pairs, hit distinct banks both when they read one entry per member (a
// broadcast over rows) and when they read their own row or a transposed
// column. The state entry y[i] of member b stays in a register of thread
// (i, b); the Horner vector is exchanged through shared memory.
//
// Phases in float64. The time grid is shared by every member, so the frame
// phases cos/sin(fmod(omega tau, 2 pi)) are formed once per Gauss point per
// step per block, from float64 tau, and rounded to float32 in shared memory.
// This replaces the TPU kernel's f32 (hi, lo) pairs (ops/trig_reduce.py,
// split_omega_host): Hopper has native FP64.
//
// Arithmetic order. The library is built with -fmad=false and every float
// operation is written in the order of the plain version (and of the Pallas
// kernel): sequential sums over the inner index, (a_r b_r - a_i b_i) and
// (a_r b_i + a_i b_r) per complex product, generator = combination first,
// rotation second. On the card the two agree to the last bit.
//
// What bounds it on this card. Per member and step, "matrix_herm" at n = 16,
// k = 2, order 8 does ~59k float32 operations (one n^3 complex matmul, eight
// n^2 mat-vecs, the generator builds) and reads ~4 B of coefficients: it is
// bound by operations (the bytes, ~33 MB for a 10,240-member 200-step sweep,
// take ~0.01 ms at 3.35 TB/s). Every operand of the matmuls comes from
// shared memory (two 4-byte loads per real multiply-add pair), so the
// practical limit of this simple design is the shared-memory load rate, not
// the FP32 rate; register blocking of the products and tensor-core (wgmma)
// batching are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 32;  // the state dimension cap (the router sends larger n elsewhere)
constexpr double kTwoPi = 6.283185307179586;
constexpr double kGaussC1 = 0.21132486540518713;  // 1/2 - sqrt(3)/6
constexpr double kGaussC2 = 0.7886751345948129;   // 1/2 + sqrt(3)/6

enum Mode { kMatrix = 0, kMatrixHerm = 1, kMatvec = 2 };

struct Params {
  const float* statr;  // (n, n)
  const float* stati;
  const float* opsr;  // (k, n, n)
  const float* opsi;
  const double* omega;  // (n, n) frame frequency differences
  const float* coef;    // (T, 2, k, B)
  const int* slots;     // (T,) trajectory slot per step (-1: not kept), or null
  const float* y0r;     // (n, B)
  const float* y0i;
  float* outr;  // (n, B)
  float* outi;
  float* evalr;  // (n_eval, n, B), or null
  float* evali;
  int n, k, T, B, order, mode, mb;
  double dt, t0;
  float c1, c2;  // (f32)(dt / 2), (f32)(p2 dt^2)
};

// Row stride of a [row][col][member] plane: n*mb padded to = mb (mod 32).
__host__ __device__ inline int row_stride(int n, int mb) {
  const int rs = n * mb;
  return rs + (((mb - rs) % 32) + 32) % 32;
}

// Shared-memory floats of one block: operator tables, phase tables,
// coefficients, matrix planes, vector planes.
__host__ __device__ inline size_t smem_floats(int n, int k, int mb, int mode) {
  const size_t nn = (size_t)n * n;
  const int mats = mode == kMatvec ? 2 : 3;
  return 2 * (k + 1) * nn + 4 * nn + (size_t)2 * k * mb +
         (size_t)mats * 2 * n * row_stride(n, mb) + (size_t)6 * n * mb;
}

struct Plane {  // a complex [row][col][member] plane in shared memory
  float* r;
  float* i;
};

__global__ void sweep_magnus2_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, k = p.k, nn = n * n, mb = p.mb, B = p.B;
  const int rs = row_stride(n, mb);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = tid / mb, b = tid % mb;
  const int lane = blockIdx.x * mb + b;
  const bool valid = lane < B;
  const int lane_ld = valid ? lane : B - 1;  // ragged last block: compute on a copy, store nothing

  float* sr = smem;                 // static, (n, n)
  float* si = sr + nn;
  float* opr = si + nn;             // operators, (k, n, n)
  float* opi = opr + (size_t)k * nn;
  float* cs = opi + (size_t)k * nn;  // cos/sin at Gauss points 1, 2: 4 (n, n)
  float* csh = cs + 4 * nn;          // coefficients (2, k, mb)
  float* mat = csh + 2 * k * mb;
  const size_t msz = (size_t)n * rs;
  Plane g1{mat, mat + msz}, g2{mat + 2 * msz, mat + 3 * msz};
  Plane pm{mat + 4 * msz, mat + 5 * msz};  // P / M (matrix modes)
  float* vec = mat + (size_t)(p.mode == kMatvec ? 4 : 6) * msz;
  const int vsz = n * mb;
  // vectors, [row][member]: two Horner buffers (matrix modes) or v, u1, u2 (matvec)
  Plane va{vec, vec + vsz}, vb{vec + 2 * vsz, vec + 3 * vsz}, vc{vec + 4 * vsz, vec + 5 * vsz};

  for (int idx = tid; idx < nn; idx += nthreads) {
    sr[idx] = p.statr[idx];
    si[idx] = p.stati[idx];
    for (int j = 0; j < k; ++j) {
      opr[j * nn + idx] = p.opsr[j * nn + idx];
      opi[j * nn + idx] = p.opsi[j * nn + idx];
    }
  }
  float yr = p.y0r[(size_t)row * B + lane_ld];
  float yi = p.y0i[(size_t)row * B + lane_ld];
  const int at_own = row * mb + b;  // this thread's entry of a vector plane

  for (int s = 0; s < p.T; ++s) {
    __syncthreads();  // the previous step is done with every table and plane
    const double tau1 = p.t0 + ((double)s + kGaussC1) * p.dt;
    const double tau2 = p.t0 + ((double)s + kGaussC2) * p.dt;
    for (int idx = tid; idx < nn; idx += nthreads) {
      const double ph1 = fmod(p.omega[idx] * tau1, kTwoPi);
      const double ph2 = fmod(p.omega[idx] * tau2, kTwoPi);
      cs[idx] = (float)cos(ph1);
      cs[nn + idx] = (float)sin(ph1);
      cs[2 * nn + idx] = (float)cos(ph2);
      cs[3 * nn + idx] = (float)sin(ph2);
    }
    for (int idx = tid; idx < 2 * k * mb; idx += nthreads) {
      const int gj = idx / mb, bb = idx % mb;  // gj = g * k + j
      const int l = min(blockIdx.x * mb + bb, B - 1);
      csh[idx] = p.coef[((size_t)s * 2 * k + gj) * B + l];
    }
    __syncthreads();

    // generators: row `row` of G_1 and G_2 for member b
    for (int g = 0; g < 2; ++g) {
      const Plane& G = g == 0 ? g1 : g2;
      const float* cosg = cs + 2 * g * nn;
      const float* sing = cosg + nn;
      for (int m = 0; m < n; ++m) {
        const int idx = row * n + m;
        float accr = sr[idx], acci = si[idx];
        for (int j = 0; j < k; ++j) {
          const float c = csh[(g * k + j) * mb + b];
          accr = accr + c * opr[j * nn + idx];
          acci = acci + c * opi[j * nn + idx];
        }
        const float cp = cosg[idx], sp = sing[idx];
        G.r[row * rs + m * mb + b] = accr * cp - acci * sp;
        G.i[row * rs + m * mb + b] = accr * sp + acci * cp;
      }
    }
    __syncthreads();

    if (p.mode == kMatvec) {
      // commutator-free: each Horner term applies M v as four mat-vecs
      va.r[at_own] = yr;
      va.i[at_own] = yi;
      for (int kk = p.order; kk >= 1; --kk) {
        const float inv = (float)(1.0 / (double)kk);
        __syncthreads();  // v is complete
        float u1r = 0.0f, u1i = 0.0f, u2r = 0.0f, u2i = 0.0f;
        for (int m = 0; m < n; ++m) {
          const int e = row * rs + m * mb + b, v = m * mb + b;
          const float xr = va.r[v], xi = va.i[v];
          u1r = u1r + (g1.r[e] * xr - g1.i[e] * xi);
          u1i = u1i + (g1.r[e] * xi + g1.i[e] * xr);
        }
        for (int m = 0; m < n; ++m) {
          const int e = row * rs + m * mb + b, v = m * mb + b;
          const float xr = va.r[v], xi = va.i[v];
          u2r = u2r + (g2.r[e] * xr - g2.i[e] * xi);
          u2i = u2i + (g2.r[e] * xi + g2.i[e] * xr);
        }
        vb.r[at_own] = u1r;
        vb.i[at_own] = u1i;
        vc.r[at_own] = u2r;
        vc.i[at_own] = u2i;
        __syncthreads();  // u1, u2 are complete; nobody reads v any more
        float t1r = 0.0f, t1i = 0.0f, ar = 0.0f, ai = 0.0f;
        for (int m = 0; m < n; ++m) {  // t1 = G2 u1
          const int e = row * rs + m * mb + b, v = m * mb + b;
          const float xr = vb.r[v], xi = vb.i[v];
          t1r = t1r + (g2.r[e] * xr - g2.i[e] * xi);
          t1i = t1i + (g2.r[e] * xi + g2.i[e] * xr);
        }
        for (int m = 0; m < n; ++m) {  // G1 u2
          const int e = row * rs + m * mb + b, v = m * mb + b;
          const float xr = vc.r[v], xi = vc.i[v];
          ar = ar + (g1.r[e] * xr - g1.i[e] * xi);
          ai = ai + (g1.r[e] * xi + g1.i[e] * xr);
        }
        va.r[at_own] = yr + inv * (p.c1 * (u1r + u2r) + p.c2 * (t1r - ar));
        va.i[at_own] = yi + inv * (p.c1 * (u1i + u2i) + p.c2 * (t1i - ai));
        __syncthreads();  // every thread is done reading u1, u2
      }
      yr = va.r[at_own];
      yi = va.i[at_own];
    } else {
      // M into the `pm` plane (matrix) or into G_2's plane (matrix_herm)
      if (p.mode == kMatrixHerm) {
        for (int c = 0; c < n; ++c) {  // P = G2 @ G1, row `row`
          float accr = 0.0f, acci = 0.0f;
          for (int m = 0; m < n; ++m) {
            const int a = row * rs + m * mb + b, bm = m * rs + c * mb + b;
            accr = accr + (g2.r[a] * g1.r[bm] - g2.i[a] * g1.i[bm]);
            acci = acci + (g2.r[a] * g1.i[bm] + g2.i[a] * g1.r[bm]);
          }
          pm.r[row * rs + c * mb + b] = accr;
          pm.i[row * rs + c * mb + b] = acci;
        }
        __syncthreads();  // P is complete
        for (int c = 0; c < n; ++c) {
          const int e = row * rs + c * mb + b, et = c * rs + row * mb + b;
          const float sumr = g1.r[e] + g2.r[e], sumi = g1.i[e] + g2.i[e];
          g2.r[e] = p.c1 * sumr + p.c2 * (pm.r[e] - pm.r[et]);
          g2.i[e] = p.c1 * sumi + p.c2 * (pm.i[e] + pm.i[et]);
        }
      } else {
        for (int c = 0; c < n; ++c) {
          float accr = 0.0f, acci = 0.0f;  // (G2 @ G1)[row, c]
          for (int m = 0; m < n; ++m) {
            const int a = row * rs + m * mb + b, bm = m * rs + c * mb + b;
            accr = accr + (g2.r[a] * g1.r[bm] - g2.i[a] * g1.i[bm]);
            acci = acci + (g2.r[a] * g1.i[bm] + g2.i[a] * g1.r[bm]);
          }
          float mr = p.c2 * accr, mi = p.c2 * acci;
          accr = 0.0f;
          acci = 0.0f;  // (G1 @ G2)[row, c]
          for (int m = 0; m < n; ++m) {
            const int a = row * rs + m * mb + b, bm = m * rs + c * mb + b;
            accr = accr + (g1.r[a] * g2.r[bm] - g1.i[a] * g2.i[bm]);
            acci = acci + (g1.r[a] * g2.i[bm] + g1.i[a] * g2.r[bm]);
          }
          mr = mr + (-p.c2) * accr;
          mi = mi + (-p.c2) * acci;
          const int e = row * rs + c * mb + b;
          pm.r[e] = mr + p.c1 * (g1.r[e] + g2.r[e]);
          pm.i[e] = mi + p.c1 * (g1.i[e] + g2.i[e]);
        }
      }
      const Plane& M = p.mode == kMatrixHerm ? g2 : pm;
      va.r[at_own] = yr;
      va.i[at_own] = yi;
      Plane cur = va, nxt = vb;
      for (int kk = p.order; kk >= 1; --kk) {
        const float inv = (float)(1.0 / (double)kk);
        __syncthreads();  // M and the current vector are complete
        float wr = 0.0f, wi = 0.0f;
        for (int m = 0; m < n; ++m) {
          const int e = row * rs + m * mb + b, v = m * mb + b;
          wr = wr + (M.r[e] * cur.r[v] - M.i[e] * cur.i[v]);
          wi = wi + (M.r[e] * cur.i[v] + M.i[e] * cur.r[v]);
        }
        nxt.r[at_own] = yr + inv * wr;
        nxt.i[at_own] = yi + inv * wi;
        const Plane t = cur;
        cur = nxt;
        nxt = t;
      }
      yr = cur.r[at_own];
      yi = cur.i[at_own];
    }

    if (p.slots != nullptr) {
      const int slot = p.slots[s];
      if (slot >= 0 && valid) {
        const size_t g = ((size_t)slot * n + row) * B + lane;
        p.evalr[g] = yr;
        p.evali[g] = yi;
      }
    }
  }
  if (valid) {
    p.outr[(size_t)row * B + lane] = yr;
    p.outi[(size_t)row * B + lane] = yi;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block (the wrapper sizes mb with it).
size_t sweep_magnus2_smem_bytes(int n, int k, int mb, int mode) {
  return sizeof(float) * smem_floats(n, k, mb, mode);
}

// Launch ceil(B / mb) blocks of n * mb threads on `stream`. Returns the CUDA
// error code of the launch (0 = cudaSuccess); faults during the run surface
// at the next synchronization.
int sweep_magnus2_launch(const float* statr, const float* stati, const float* opsr,
                         const float* opsi, const double* omega, const float* coef,
                         const int* slots, const float* y0r, const float* y0i, float* outr,
                         float* outi, float* evalr, float* evali, int n, int k, int T, int B,
                         int order, int mode, int mb, double dt, double t0, float c1, float c2,
                         void* stream) {
  if (n < 1 || n > kMaxN || k < 0 || T < 1 || B < 1 || mb < 1 || n * mb > 1024 ||
      mode < kMatrix || mode > kMatvec || order < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{statr, stati, opsr, opsi, omega, coef, slots, y0r, y0i, outr, outi, evalr, evali,
           n, k, T, B, order, mode, mb, dt, t0, c1, c2};
  const size_t smem = sweep_magnus2_smem_bytes(n, k, mb, mode);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_magnus2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_magnus2_kernel<<<(B + mb - 1) / mb, n * mb, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* sweep_magnus2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
