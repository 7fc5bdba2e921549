// Lockstep-adaptive Dormand-Prince 5(4) sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/adaptive_sweep.py::_kernel
// (Pallas, launched by sweep_dopri5_lockstep). Wrapper and eager twin:
// qiskit_dynamics_tpu_torch/ops/adaptive_sweep.py.
//
// What it computes. For every sweep member b of a tile, dopri5 on
//   y_b' = P(t) o (S + sum_j c_jb(t) O_j) y_b,   c_jb(t) = Re[E_jb(t) e^{i w_j t}],
//   P(t)[i,m] = exp(i omega[i,m] t),
// with ONE step controller per tile ("lockstep"): the error norm is the rms
// over the state, max over the tile's members; step factor
// clip(0.9 err^-1/5, 0.2, 10) (shrink-only on rejection); FSAL; a stall
// guard; steps clipped to envelope cells and to eval times; an optional
// record of accepted steps; the tile's output is NaN-poisoned when its step
// budget runs out. State and stage arithmetic are float32 (real/imag
// planes); time, step sizes and every phase argument (omega t, w t) are
// float64, reduced with fmod before cos/sin (the TPU kernel needed f32
// (hi, lo) pairs for this; Hopper has native FP64).
//
// Mapping. One thread block per tile (tile_b members share one controller);
// each thread owns tile_b / blockDim members. Every step the block reduces
// max(err) through shared memory, and every thread derives the same accept,
// step size and float64 time from it, so control flow is block-uniform.
// Padding members are copies of a real member (the wrapper's lane expansion),
// never garbage: the max over the tile reads them.
//
// What bounds it on this card. Per stage and member the RHS is n^2 (k+1)
// complex multiply-adds (FP32 FMA issue: ~4 n^2 (k+2) FMAs with the
// coefficient folding below), and the state, work state and seven stages
// (9 n complex values per member, ~11 MB at 10k members x n=16) live in a
// global scratch buffer that stays in the 50 MB L2, so the stage loops also
// pay L2 traffic. With 10k members at tile_b=512 the grid has only 20 blocks
// for 132 SMs, so most SMs idle: the first-order limit is occupancy.
//
// Arithmetic order. The library is built with -fmad=false (no multiply-add
// contraction) and every float operation below is written in the order the
// eager twin performs it, so kernel and twin round identically; the phases
// use cos/sin of the same float64 arguments. Without this the twin
// comparison is noisy: the step controller reads f32 error estimates, and
// one-ulp differences move step sizes by ~1e-5 at atol = rtol = 1e-3. FMA
// contraction was worth 3% of kernel time at 10k members x n = 16 on an
// H100 SXM (700 W).
//
// What the design does about it. The frame-rotated tables P(t) o S and
// P(t) o O_j depend only on the tile's shared time, so they are formed ONCE
// per stage into shared memory (float64 cos/sin, rounded to f32) and read by
// every thread as broadcasts; no per-member (n, n) generator is ever stored
// (the Pallas kernel's gr/gi scratch). The scratch is laid out
// (tile, slot, re/im, n, member) with the member index fastest, so each
// warp's loads and stores are coalesced. Splitting tiles over more blocks
// (or clusters), register-resident stages for small n, and tensor-core
// batching are left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 64;        // compiled cap on the state dimension n
constexpr int kSlots = 9;        // y, w, k0..k6
constexpr double kTwoPi = 6.283185307179586;
constexpr double kEps32x4 = 4.0 * 1.1920929e-7;  // stall guard: 4 f32 ulps

// DOPRI5 tableau (ops/rk_tableaus.py)
__constant__ double kA[6][5] = {
    {0.0, 0.0, 0.0, 0.0, 0.0},
    {0.2, 0.0, 0.0, 0.0, 0.0},
    {0.075, 0.225, 0.0, 0.0, 0.0},
    {0.9777777777777777, -3.7333333333333334, 3.5555555555555554, 0.0, 0.0},
    {2.9525986892242035, -11.595793324188385, 9.822892851699436, -0.2908093278463649, 0.0},
    {2.8462752525252526, -10.757575757575758, 8.906422717743473, 0.2784090909090909,
     -0.2735313036020583},
};
__constant__ double kB[6] = {0.09114583333333333, 0.0, 0.44923629829290207,
                             0.6510416666666666, -0.322376179245283, 0.13095238095238096};
__constant__ double kC[6] = {0.0, 0.2, 0.3, 0.8, 0.8888888888888888, 1.0};
__constant__ double kE[7] = {-0.0012326388888888888, 0.0, 0.0042527702905061394,
                             -0.03697916666666667, 0.05086379716981132, -0.0419047619047619,
                             0.025};

struct Params {
  const float* statr;  // (n, n)
  const float* stati;
  const float* opsr;   // (k, n, n)
  const float* opsi;
  const double* omega;  // (n, n) frame frequency differences
  const double* freqs;  // (k,) angular carrier frequencies
  const float* envr;    // (k, n_env, B)
  const float* envi;
  const double* eval_ts;  // (n_eval,) elapsed times, or null
  const float* y0r;       // (n, B)
  const float* y0i;
  float* outr;  // (n, B)
  float* outi;
  float* evalr;  // (n_eval, n, B), zero-initialized, or null
  float* evali;
  double* rec;     // (n_tiles, max_steps), zero-initialized, or null
  float* scratch;  // (n_tiles, kSlots, 2, n, tile_b)
  int n, k, n_env, n_eval, B, tile_b, max_steps, record;
  double t0, dur, env_dt, atol, rtol, h0;
};

// min/max that propagate NaN (as jnp.minimum/maximum and torch do)
__device__ __forceinline__ double nmin(double a, double b) { return (isnan(a) || a < b) ? a : b; }
__device__ __forceinline__ double nmax(double a, double b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float nmaxf(float a, float b) { return (isnan(a) || a > b) ? a : b; }

__device__ __forceinline__ float* plane(float* tile, int slot, int part, int n, int tile_b) {
  return tile + (size_t)(slot * 2 + part) * n * tile_b;
}

// Envelope cell of an elapsed time: clamp(x, 0, n_env - 1) as an int (NaN -> 0).
__device__ __forceinline__ int cell_of(double x, int n_env) {
  if (isnan(x)) return 0;
  return (int)fmin(fmax(x, 0.0), (double)(n_env - 1));
}

// Shared-memory layout (floats): tabr, tabi ((k+1) n^2 each), cw, sw (k each),
// csh (k tile_b), red (blockDim).
struct Smem {
  float* tabr;
  float* tabi;
  float* cw;
  float* sw;
  float* csh;
  float* red;
};

// k_dst <- G(t0 + te) w for the tile's members, using envelope cell `cell`.
// Called by every thread of the block (it synchronizes).
__device__ void rhs_stage(const Params& p, const Smem& sm, float* tile, int dst_slot, double te,
                          int cell) {
  const int n = p.n, k = p.k, nn = n * n, tile_b = p.tile_b;
  const double ta = p.t0 + te;
  __syncthreads();  // every thread is done reading the previous tables
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    const double ph = fmod(p.omega[idx] * ta, kTwoPi);
    const float c = (float)cos(ph), s = (float)sin(ph);
    const float ar = p.statr[idx], ai = p.stati[idx];
    sm.tabr[idx] = ar * c - ai * s;
    sm.tabi[idx] = ar * s + ai * c;
    for (int j = 0; j < k; ++j) {
      const float br = p.opsr[j * nn + idx], bi = p.opsi[j * nn + idx];
      sm.tabr[(j + 1) * nn + idx] = br * c - bi * s;
      sm.tabi[(j + 1) * nn + idx] = br * s + bi * c;
    }
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const double ph = fmod(p.freqs[j] * ta, kTwoPi);
    sm.cw[j] = (float)cos(ph);
    sm.sw[j] = (float)sin(ph);
  }
  __syncthreads();

  const float* wr = plane(tile, 1, 0, n, tile_b);
  const float* wi = plane(tile, 1, 1, n, tile_b);
  float* kr = plane(tile, dst_slot, 0, n, tile_b);
  float* ki = plane(tile, dst_slot, 1, n, tile_b);
  const size_t lane0 = (size_t)blockIdx.x * tile_b;
  for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
    for (int j = 0; j < k; ++j) {
      const size_t e = ((size_t)j * p.n_env + cell) * p.B + lane0 + b;
      sm.csh[j * tile_b + b] = p.envr[e] * sm.cw[j] - p.envi[e] * sm.sw[j];
    }
    for (int i = 0; i < n; ++i) {
      float accr = 0.0f, acci = 0.0f;
      for (int m = 0; m < n; ++m) {
        const int idx = i * n + m;
        float gr = sm.tabr[idx], gi = sm.tabi[idx];
        for (int j = 0; j < k; ++j) {
          const float cj = sm.csh[j * tile_b + b];
          gr += cj * sm.tabr[(j + 1) * nn + idx];
          gi += cj * sm.tabi[(j + 1) * nn + idx];
        }
        const float xr = wr[m * tile_b + b], xi = wi[m * tile_b + b];
        accr += gr * xr - gi * xi;
        acci += gr * xi + gi * xr;
      }
      kr[i * tile_b + b] = accr;
      ki[i * tile_b + b] = acci;
    }
  }
}

// w <- y + sum_q (f32)(h coef[q]) k_q, skipping the zero tableau entries.
__device__ void combine(const Params& p, float* tile, const double* coef, int n_terms, double h) {
  const int n = p.n, tile_b = p.tile_b;
  float c[6];
  for (int q = 0; q < n_terms; ++q) c[q] = (float)(h * coef[q]);
  for (int part = 0; part < 2; ++part) {
    const float* y = plane(tile, 0, part, n, tile_b);
    float* w = plane(tile, 1, part, n, tile_b);
    for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
      for (int i = 0; i < n; ++i) {
        const int at = i * tile_b + b;
        float acc = y[at];
        for (int q = 0; q < n_terms; ++q) {
          if (coef[q] != 0.0) acc += c[q] * plane(tile, 2 + q, part, n, tile_b)[at];
        }
        w[at] = acc;
      }
    }
  }
}

__global__ void adaptive_sweep_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, k = p.k, nn = n * n, tile_b = p.tile_b, B = p.B;
  Smem sm;
  sm.tabr = smem;
  sm.tabi = sm.tabr + (k + 1) * nn;
  sm.cw = sm.tabi + (k + 1) * nn;
  sm.sw = sm.cw + k;
  sm.csh = sm.sw + k;
  sm.red = sm.csh + k * tile_b;

  float* tile = p.scratch + (size_t)blockIdx.x * kSlots * 2 * n * tile_b;
  const size_t lane0 = (size_t)blockIdx.x * tile_b;
  float* yr = plane(tile, 0, 0, n, tile_b);
  float* yi = plane(tile, 0, 1, n, tile_b);
  float* wr = plane(tile, 1, 0, n, tile_b);
  float* wi = plane(tile, 1, 1, n, tile_b);
  float* k0r = plane(tile, 2, 0, n, tile_b);
  float* k0i = plane(tile, 2, 1, n, tile_b);
  float* k6r = plane(tile, 8, 0, n, tile_b);
  float* k6i = plane(tile, 8, 1, n, tile_b);

  for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      const size_t g = (size_t)i * B + lane0 + b;
      yr[i * tile_b + b] = wr[i * tile_b + b] = p.y0r[g];
      yi[i * tile_b + b] = wi[i * tile_b + b] = p.y0i[g];
    }
  }
  // initial FSAL stage f(t0, y0), envelope cell 0
  rhs_stage(p, sm, tile, 2, 0.0, 0);

  const double inv_env_dt = 1.0 / p.env_dt;
  const float atol = (float)p.atol, rtol = (float)p.rtol;
  double s = 0.0, h_prop = p.h0;  // elapsed time; proposed step
  int steps = 0, eidx = 0, aidx = 0;
  bool bad = false;

  while ((p.dur - s) > 0.0 && steps < p.max_steps) {
    double h = nmin(h_prop, p.dur - s);
    double target = 0.0;
    const bool have_target = eidx < p.n_eval;
    if (p.n_eval > 0) {
      // clip the step to the next trajectory time so an accepted step lands on it
      target = p.eval_ts[min(eidx, p.n_eval - 1)];
      if (have_target) h = nmin(h, nmax(target - s, 0.0));
    }
    int step_cell = 0;
    if (p.n_env > 1) {
      // clip to the next envelope-cell boundary; every stage of the step reads
      // the cell at the step midpoint (smooth RHS within each step)
      const double cell_f = floor(s * inv_env_dt + 1e-4);
      h = nmin(h, (cell_f + 1.0) * p.env_dt - s);
      step_cell = cell_of((s + 0.5 * h) * inv_env_dt, p.n_env);
    }

    // stages 1..5 (stage 0 is the FSAL stage already in slot 2)
    for (int st = 1; st < 6; ++st) {
      combine(p, tile, kA[st], st, h);
      rhs_stage(p, sm, tile, 2 + st, s + kC[st] * h, step_cell);
    }
    // 5th-order solution into w, then the FSAL stage f(t + h, y_new) into slot 8
    combine(p, tile, kB, 6, h);
    rhs_stage(p, sm, tile, 8, s + h, step_cell);

    // error estimate: rms over the state per member, max over the tile
    float he[7];
    for (int q = 0; q < 7; ++q) he[q] = (float)(h * kE[q]);  // kE[1] == 0 is skipped below
    float local = 0.0f;
    for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
      float sum = 0.0f;
      for (int i = 0; i < n; ++i) {
        const int at = i * tile_b + b;
        float er = 0.0f, ei = 0.0f;
        for (int q = 0; q < 7; ++q) {
          if (kE[q] != 0.0) {
            er += he[q] * plane(tile, 2 + q, 0, n, tile_b)[at];
            ei += he[q] * plane(tile, 2 + q, 1, n, tile_b)[at];
          }
        }
        const float ay = sqrtf(yr[at] * yr[at] + yi[at] * yi[at]);
        const float aw = sqrtf(wr[at] * wr[at] + wi[at] * wi[at]);
        const float scale = atol + rtol * fmaxf(ay, aw);
        sum += (er * er + ei * ei) / (scale * scale);
      }
      local = nmaxf(local, sum);
    }
    sm.red[threadIdx.x] = local;
    __syncthreads();
    for (int off = blockDim.x / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) sm.red[threadIdx.x] = nmaxf(sm.red[threadIdx.x], sm.red[threadIdx.x + off]);
      __syncthreads();
    }
    const float err_norm = sqrtf(sm.red[0] / (float)n);
    __syncthreads();  // red[0] is read by all before the next step rewrites it

    // stall guard: a step within a few f32 ulps of t cannot be refined further
    const bool stalled = h <= kEps32x4 * fmax(1.0, s);
    const bool accept = (err_norm <= 1.0f) || stalled;
    bad = bad || (stalled && err_norm > 1.0f && err_norm > 100.0f);
    if (accept) {
      for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
        for (int i = 0; i < n; ++i) {
          const int at = i * tile_b + b;
          yr[at] = wr[at];
          yi[at] = wi[at];
          k0r[at] = k6r[at];
          k0i[at] = k6i[at];
        }
      }
      if (p.record) {
        if (threadIdx.x == 0) p.rec[(size_t)blockIdx.x * p.max_steps + aidx] = h;
        ++aidx;
      }
    }
    const double s_new = accept ? s + h : s;

    if (p.n_env > 1) {
      // the FSAL stage used the old cell's envelope; after a cell crossing the
      // next stage 0 must use the new cell (w holds y_new == y on accept)
      const int new_cell = cell_of(floor(s_new * inv_env_dt + 1e-4), p.n_env);
      if (accept && new_cell != step_cell && (p.dur - s_new) > 0.0) {
        rhs_stage(p, sm, tile, 2, s_new, new_cell);
      }
    }
    if (p.n_eval > 0) {
      const double eps = kEps32x4 * fmax(1.0, target);
      if (have_target && accept && s_new >= target - eps) {
        for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
          for (int i = 0; i < n; ++i) {
            const size_t g = ((size_t)eidx * n + i) * B + lane0 + b;
            p.evalr[g] = yr[i * tile_b + b];
            p.evali[g] = yi[i * tile_b + b];
          }
        }
        ++eidx;
      }
    }

    const double safe_err = nmax((double)err_norm, 1e-10);
    double factor = nmin(nmax(0.9 * exp(-0.2 * log(safe_err)), 0.2), 10.0);
    if (!accept) factor = nmin(factor, 1.0);
    double h_new = h * factor;
    if ((p.n_env > 1 || p.n_eval > 0) && accept && h < h_prop) {
      // a boundary-clipped accepted step keeps at least the pre-clip proposal
      h_new = nmax(h_prop, h_new);
    }
    h_prop = h_new;
    s = s_new;
    ++steps;
  }

  // NaN-poison the tile if the budget ran out, a stalled step was forced
  // through far out of tolerance, or an eval time was missed
  const bool ok = (p.dur - s) <= 0.0 && !bad && eidx >= p.n_eval;
  const float poison = ok ? 1.0f : nanf("");
  for (int b = threadIdx.x; b < tile_b; b += blockDim.x) {
    for (int i = 0; i < n; ++i) {
      const size_t g = (size_t)i * B + lane0 + b;
      p.outr[g] = yr[i * tile_b + b] * poison;
      p.outi[g] = yi[i * tile_b + b] * poison;
      for (int e = 0; e < p.n_eval; ++e) {
        const size_t ge = ((size_t)e * n + i) * B + lane0 + b;
        p.evalr[ge] *= poison;
        p.evali[ge] *= poison;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch one block per tile on `stream`. Returns the CUDA error code of the
// launch (0 = cudaSuccess); the kernel itself reports faults at the next
// synchronization.
int adaptive_sweep_launch(const float* statr, const float* stati, const float* opsr,
                          const float* opsi, const double* omega, const double* freqs,
                          const float* envr, const float* envi, const double* eval_ts,
                          const float* y0r, const float* y0i, float* outr, float* outi,
                          float* evalr, float* evali, double* rec, float* scratch, int n, int k,
                          int n_env, int n_eval, int B, int tile_b, int max_steps, int record,
                          double t0, double dur, double env_dt, double atol, double rtol,
                          double h0, int threads, void* stream) {
  if (n < 1 || n > kMaxN || B % tile_b != 0 || tile_b % threads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{statr, stati, opsr, opsi, omega, freqs, envr, envi, eval_ts, y0r, y0i,
           outr, outi, evalr, evali, rec, scratch, n, k, n_env, n_eval, B, tile_b,
           max_steps, record, t0, dur, env_dt, atol, rtol, h0};
  const size_t smem =
      sizeof(float) * ((size_t)2 * (k + 1) * n * n + 2 * k + (size_t)k * tile_b + threads);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        adaptive_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  adaptive_sweep_kernel<<<B / tile_b, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

const char* adaptive_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
