// Lockstep-adaptive Dormand-Prince 5(4) sweep kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/adaptive_sweep.py::_kernel
// (Pallas, launched by sweep_dopri5_lockstep). Wrapper, launch shape and
// eager twin: qiskit_dynamics_tpu_torch/ops/adaptive_sweep.py.
//
// What it computes. For every sweep member b of a tile, dopri5 on
//   y_b' = P(t) o (S + sum_j c_jb(t) O_j) y_b,   c_jb(t) = Re[E_jb(t) e^{i w_j t}],
//   P(t)[i,m] = exp(i omega[i,m] t),
// with ONE step controller per tile ("lockstep"): the error norm is the rms
// over the state, max over the tile's members; step factor
// clip(0.9 err^-1/5, 0.2, 10) (shrink-only on rejection); FSAL; a stall
// guard; steps clipped to envelope cells and to eval times; an optional
// record of accepted steps, and optional counts of the steps attempted and
// accepted, summed over tiles; the tile's output is NaN-poisoned when its step
// budget runs out. State and stage arithmetic are float32 (real/imag
// pairs); time, step sizes and every phase argument (omega t, w t) are
// float64, reduced with fmod before cos/sin (the TPU kernel needed f32
// (hi, lo) pairs for this; Hopper has native FP64).
//
// What bounds it on this card. Per stage and member the RHS is n^2 (k+1)
// complex table reads and n^2 (4k + 8) float32 operations; the bound at the
// main row (10,240 lanes of n = 16, tile_b = 512, ~126 accepted steps) is
// ~0.5 ms of FP32 work at the card's multiply-add rate. Built without
// multiply-add contraction (below), every multiply and add is an instruction
// of its own, so the issue floor is twice that; and the step loop is
// sequential per tile, with per step a table pass, a cluster exchange and
// the controller's float64 arithmetic on the critical path. What the SMs
// can overlap is the stage work of the members each holds.
//
// Mapping. A tile of tile_b members is one thread-block cluster of G blocks
// (G = 1, 2, 4, 8 or 16); each block owns tile_b / G members. A member is a
// group of P lanes of one warp (P a power of two); lane l owns the rows
// i = l, l + P, ... (R rows, P R >= n; lanes past n are masked). A lane keeps
// its rows of y, w and the seven stages k0..k6 in registers for the whole
// call, so the stage combinations and the accept copy touch no memory; a
// stage's mat-vec takes w_m from the lane that owns row m by shuffle (no
// block barrier inside a stage). Where tile_b / G members at P lanes exceed
// a block, each lane group runs V members one after the other and keeps
// their state in a global scratch buffer between table passes. The main
// row's n = 16 has an instantiation with n compile-time (offsets, lanes and
// trip counts constant, the mat-vec unrolled).
//
// Tables. A step's stage times are known once h is chosen, so the cluster
// forms the frame-rotated tables P(t) o S, P(t) o O_j of all six new stages
// in one pass (S stages per pass where six do not fit in shared memory: n >
// 27 at k = 2): each block forms 1/G of the entries and stores them into
// every block's shared memory, behind one cluster barrier. They are laid out
// column-major ([stage][j][m][i], complex pairs), so the lanes of a warp,
// which hold different rows i, read consecutive words: no bank conflicts.
// The phase reduction is an exact fmod (fmod_two_pi) and one sincos per
// entry. The FSAL stage after an envelope-cell crossing (and the first one)
// is a pass of its own at the start of the next step.
//
// The step controller. Each lane group sums its member's error over the rows
// in row order (shuffles into every lane, one add after another), a warp takes
// the max over its members with NaN-propagating shuffles, the block over its
// warps, and the cluster's blocks trade their maxima once per step through
// distributed shared memory (one write to every peer, one cluster barrier,
// double-buffered by step parity). Thread 0 of every block then derives the
// same error norm, accept, step size and float64 time, keeping the
// controller's state in shared memory (no thread holds it in registers
// through the stages), and publishes the next step's size, cell and stage
// coefficients behind a block barrier: control flow is uniform over the
// cluster. Rank 0 writes the step record; each block writes the eval slots,
// outputs and NaN poison of its own members. Padding members are copies of a
// real member (the wrapper's lane expansion): the max reads them.
//
// Arithmetic order. The library is built with -fmad=false (no multiply-add
// contraction) and every float operation below is written in the order the
// eager twin performs it: gr = tab0 + c_0 tab1 + c_1 tab2 ... in j order, the
// mat-vec sum over m in order, the error sum over rows i in order. Shuffled
// values are exact copies and a max does not depend on its order, so kernel
// and twin round identically and their step records are equal. One ulp in
// the error norm would move a step at atol = rtol = 1e-3.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 64;        // compiled cap on the state dimension n
constexpr int kSlots = 9;        // y, w, k0..k6
constexpr int kStages = 6;       // new RHS stages per step (stage 0 is FSAL)
constexpr int kMaxCluster = 16;  // blocks per tile (16 is the non-portable size)
constexpr double kTwoPi = 6.283185307179586;
constexpr double kEps32x4 = 4.0 * 1.1920929e-7;  // stall guard: 4 f32 ulps

// error codes of the launch beside cudaError_t's (which stay below 1000)
constexpr int kErrShape = 1001;     // the launch shape is not one the kernel takes
constexpr int kErrResident = 1002;  // the card co-schedules no cluster of this shape

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
  double* rec;      // (n_tiles, max_steps), zero-initialized, or null
  float2* scratch;  // (blocks, V, kSlots, R, threads) where V > 1, else null
  int* steps_out;   // (n_tiles,) steps taken, rejected ones included, or null
  long long* clocks;  // (blocks, 4) thread 0's cycles by part, or null
  unsigned long long* step_counts;  // (2,) steps attempted and accepted, added to, or null
  int n, k, n_env, n_eval, B, tile_b, max_steps, record;
  int cluster, lanes, members, groups_v, passes_s;  // G, P, tile_b / G, V, S
  double t0, dur, env_dt, atol, rtol, h0;
};

// min/max that propagate NaN (as jnp.minimum/maximum and torch do)
__device__ __forceinline__ double nmin(double a, double b) { return (isnan(a) || a < b) ? a : b; }
__device__ __forceinline__ double nmax(double a, double b) { return (isnan(a) || a > b) ? a : b; }
__device__ __forceinline__ float nmaxf(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// Envelope cell of an elapsed time: clamp(x, 0, n_env - 1) as an int (NaN -> 0).
__device__ __forceinline__ int cell_of(double x, int n_env) {
  if (isnan(x)) return 0;
  return (int)fmin(fmax(x, 0.0), (double)(n_env - 1));
}

// fmod(x, 2 pi) (the phase reduction of the reference), computed exactly:
// the remainder is representable, so any exact method returns fmod's bits.
// q = trunc(|x| / 2pi) is the true quotient or one more (the division
// rounds, and an integer quotient is representable); the fused
// multiply-add forms |x| - q 2pi exactly (a multiple of ulp(2pi) below
// 2pi in magnitude), and one add of 2pi corrects q, exactly again.
__device__ __forceinline__ double fmod_two_pi(double x) {
  const double ax = fabs(x);
  if (!(ax >= kTwoPi) || ax > 1e15) return fmod(x, kTwoPi);  // |x| < 2pi, NaN, huge
  const double q = trunc(ax / kTwoPi);
  double r = fma(-q, kTwoPi, ax);
  if (r < 0.0) r += kTwoPi;
  return copysign(r, x);
}

// (cos, sin) of a reduced phase, each rounded to float32. One sincos gives
// the reference's cos and sin bit for bit (held by the card tests).
__device__ __forceinline__ float2 cos_sin(double ph) {
  double s, c;
  sincos(ph, &s, &c);
  return make_float2((float)c, (float)s);
}

// Elapsed time of stage st (0..6) of a step from s of size h (stage 0 is the
// FSAL stage at s after a cell crossing).
__device__ __forceinline__ double stage_time(int st, double s, double h) {
  return st == 0 ? s : st < kStages ? s + kC[st] * h : s + h;
}

// The tables of `count` stages (first, first + 1, ...) of a step into slots
// 0.. of `tab` ([slot][j][m][i] complex pairs, j = 0 the static part) and
// their carrier phases into `cs` ([slot][j] (cos, sin)). Block `rank` of the
// cluster forms the rank-th of G chunks of the entries and stores each into
// all G blocks' tables; every block forms its own carrier phases. The source
// planes are row-major (n, n); the tables column-major. The caller
// synchronizes the cluster before and after.
__device__ void form_tables(const Params& p, float2* tab, float2* cs, int first, int count,
                            double s, double h, cg::cluster_group& cluster, int rank,
                            int G) {
  const int n = p.n, k = p.k, nn = n * n;
  const int total = count * nn;
  const int chunk = (total + G - 1) / G;
  const int lo = rank * chunk, hi = min(total, lo + chunk);
  for (int idx = lo + threadIdx.x; idx < hi; idx += blockDim.x) {
    const int slot = idx / nn, e = idx - slot * nn;  // e = m n + i (column-major)
    const int m = e / n, src = (e - m * n) * n + m;  // i n + m (row-major)
    const double ta = p.t0 + stage_time(first + slot, s, h);
    const double ph = fmod_two_pi(p.omega[src] * ta);
    const float2 cs_ph = cos_sin(ph);
    const float c = cs_ph.x, sn = cs_ph.y;
    const size_t at = (size_t)slot * (k + 1) * nn + e;
    for (int j = 0; j <= k; ++j) {
      const float br = j == 0 ? p.statr[src] : p.opsr[(j - 1) * nn + src];
      const float bi = j == 0 ? p.stati[src] : p.opsi[(j - 1) * nn + src];
      const float2 v = make_float2(br * c - bi * sn, br * sn + bi * c);
      for (int g = 0; g < G; ++g) cluster.map_shared_rank(tab, g)[at + (size_t)j * nn] = v;
    }
  }
  // the carrier phases on the block's last threads, beside the entries
  for (int idx = blockDim.x - 1 - threadIdx.x; idx < count * k; idx += blockDim.x) {
    const int slot = idx / k, j = idx - slot * k;
    const double ta = p.t0 + stage_time(first + slot, s, h);
    cs[idx] = cos_sin(fmod_two_pi(p.freqs[j] * ta));
  }
}

// One lane's view of its member: the lane group, the member's lane in the
// sweep batch, the rows it owns and the warp's shuffle mask.
struct Lane {
  int lg;       // lane in the group (0..P-1)
  int P;        // lanes per member
  size_t b;     // the member's lane in the batch
  unsigned mask;
};

// k <- G(t) w for one member: tables `tab` of one stage, coefficients c (K of
// them in registers; K == 0: k of them in shared memory at `csh`). N > 0 is a
// compile-time n = P R (offsets, lanes and trip counts become constants).
template <int R, int K, int N>
__device__ __forceinline__ void rhs(const float2* __restrict__ tab, int n_rt, int k,
                                    const float (&c)[K > 0 ? K : 1], const float* csh,
                                    const float2 (&w)[R], float2 (&out)[R], const Lane& ln) {
  const int n = N > 0 ? N : n_rt, nn = n * n, P = N > 0 ? N / R : ln.P;
  int row[R];
  float accr[R], acci[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = min(r * P + ln.lg, n - 1);  // masked lanes read row n - 1 and store nothing
    accr[r] = 0.0f;
    acci[r] = 0.0f;
  }
#pragma unroll
  for (int r2 = 0; r2 < R; ++r2) {
    const int mend = min(P, n - r2 * P);  // uniform over the warp
#pragma unroll (N > 0 ? N / R : 4)
    for (int l = 0; l < mend; ++l) {
      const float xr = __shfl_sync(ln.mask, w[r2].x, l, P);
      const float xi = __shfl_sync(ln.mask, w[r2].y, l, P);
      const float2* col = tab + (r2 * P + l) * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 t0 = col[row[r]];
        float gr = t0.x, gi = t0.y;
        if constexpr (K > 0) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const float2 tj = col[(j + 1) * nn + row[r]];
            gr += c[j] * tj.x;
            gi += c[j] * tj.y;
          }
        } else {
          for (int j = 0; j < k; ++j) {
            const float cj = csh[j];
            const float2 tj = col[(j + 1) * nn + row[r]];
            gr += cj * tj.x;
            gi += cj * tj.y;
          }
        }
        accr[r] += gr * xr - gi * xi;
        acci[r] += gr * xi + gi * xr;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = make_float2(accr[r], acci[r]);
}

// The per-step control block in shared memory. Thread 0 of each block is the
// step controller: it alone keeps the controller's state (here), derives each
// step's size, envelope cell and stage coefficients and, after the cluster's
// exchange, its outcome; the other threads read them after a block barrier,
// so no thread holds the float64 control in registers through the stages.
struct Control {
  double s, h, h_prop, target;  // elapsed time, this step's size, the proposal, eval target
  int steps, eidx, aidx, bad;  // steps attempted; eval slots filled; steps accepted; poisoned
  int done, cell;              // the loop ends; this step's envelope cell
  int fsal, fsal_cell;         // stage 0 comes first (FSAL after a cell crossing), its cell
  int accept, eval_slot;       // the last step's outcome: accepted; eval slot to write, or -1
  float coef[kStages + 1][kStages];  // row st (1..5): (f32)(h kA[st][q]); row 6: (f32)(h kB[q])
  float err[7];                      // (f32)(h kE[q])
  long long clocks[4];               // thread 0's cycles: tables, stages, exchange, control
};

// Thread 0: this step's size, cell and coefficients from the controller's
// state, with the clips in the reference's order, and whether the loop ends.
__device__ void plan_step(const Params& p, Control& c) {
  c.done = !((p.dur - c.s) > 0.0 && c.steps < p.max_steps);
  if (c.done) return;
  const double s = c.s;
  double h = nmin(c.h_prop, p.dur - s);
  double target = 0.0;
  if (p.n_eval > 0) {
    // clip the step to the next trajectory time so an accepted step lands on it
    target = p.eval_ts[min(c.eidx, p.n_eval - 1)];
    if (c.eidx < p.n_eval) h = nmin(h, nmax(target - s, 0.0));
  }
  int cell = 0;
  if (p.n_env > 1) {
    // clip to the next envelope-cell boundary; every stage of the step reads
    // the cell at the step midpoint (smooth RHS within each step)
    const double inv_env_dt = 1.0 / p.env_dt;
    const double cell_f = floor(s * inv_env_dt + 1e-4);
    h = nmin(h, (cell_f + 1.0) * p.env_dt - s);
    cell = cell_of((s + 0.5 * h) * inv_env_dt, p.n_env);
  }
  c.h = h;
  c.target = target;
  c.cell = cell;
  for (int st = 1; st < kStages; ++st)
    for (int q = 0; q < st; ++q) c.coef[st][q] = (float)(h * kA[st][q]);
  for (int q = 0; q < kStages; ++q) c.coef[kStages][q] = (float)(h * kB[q]);
  for (int q = 0; q < 7; ++q) c.err[q] = (float)(h * kE[q]);
}

// Thread 0, after the exchange: accept or reject the step by the tile's error
// norm, record it, and advance the controller's state.
__device__ void finish_step(const Params& p, Control& c, float err_norm, int rank, int tile) {
  const double s = c.s, h = c.h;
  // stall guard: a step within a few f32 ulps of t cannot be refined further
  const bool stalled = h <= kEps32x4 * fmax(1.0, s);
  const bool accept = (err_norm <= 1.0f) || stalled;
  c.bad = c.bad || (stalled && err_norm > 1.0f && err_norm > 100.0f);
  if (accept) {
    if (p.record && rank == 0) p.rec[(size_t)tile * p.max_steps + c.aidx] = h;
    ++c.aidx;
  }
  const double s_new = accept ? s + h : s;
  c.fsal = 0;
  if (p.n_env > 1) {
    // the FSAL stage used the old cell's envelope; after a cell crossing the
    // next stage 0 must use the new cell (w holds y_new == y on accept)
    const int new_cell = cell_of(floor(s_new * (1.0 / p.env_dt) + 1e-4), p.n_env);
    if (accept && new_cell != c.cell && (p.dur - s_new) > 0.0) {
      c.fsal = 1;
      c.fsal_cell = new_cell;
    }
  }
  c.eval_slot = -1;
  if (p.n_eval > 0) {
    const double eps = kEps32x4 * fmax(1.0, c.target);
    if (c.eidx < p.n_eval && accept && s_new >= c.target - eps) c.eval_slot = c.eidx++;
  }
  const double safe_err = nmax((double)err_norm, 1e-10);
  double factor = nmin(nmax(0.9 * exp(-0.2 * log(safe_err)), 0.2), 10.0);
  if (!accept) factor = nmin(factor, 1.0);
  double h_new = h * factor;
  if ((p.n_env > 1 || p.n_eval > 0) && accept && h < c.h_prop) {
    // a boundary-clipped accepted step keeps at least the pre-clip proposal
    h_new = nmax(c.h_prop, h_new);
  }
  c.h_prop = h_new;
  c.s = s_new;
  ++c.steps;
  c.accept = accept;
}

// The member's coefficients c_j = Re[E_j e^{i w_j t}] of one stage from its
// envelope values `env` (K > 0, loaded once per pass) and the stage's
// carrier phases `cs`; with K == 0 the group writes the k values to its
// shared floats at csh, reading the envelope from `cell`.
template <int K>
__device__ __forceinline__ void coefficients(const Params& p, const float2* cs,
                                             const float2 (&env)[K > 0 ? K : 1], int cell,
                                             const Lane& ln, float (&c)[K > 0 ? K : 1],
                                             float* csh) {
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) c[j] = env[j].x * cs[j].x - env[j].y * cs[j].y;
  } else {
    __syncwarp(ln.mask);  // every lane is done reading the previous stage's
    for (int j = ln.lg; j < p.k; j += ln.P) {
      const size_t e = ((size_t)j * p.n_env + cell) * p.B + ln.b;
      csh[j] = p.envr[e] * cs[j].x - p.envi[e] * cs[j].y;
    }
    __syncwarp(ln.mask);
  }
}

// w <- y + sum_q coef[q] k_q over the nonzero tableau entries of `stage`
// (1..5: row stage of A; 6: B), coef[q] = (f32)(h a_q), in q order.
template <int R>
__device__ __forceinline__ void combine(float2 (&v)[kSlots][R], const float* coef, int stage) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[1][r] = v[0][r];
#pragma unroll
  for (int q = 0; q < kStages; ++q) {
    if (q < stage && (stage < kStages ? kA[stage][q] : kB[q]) != 0.0) {
      const float cq = coef[q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        v[1][r].x += cq * v[2 + q][r].x;
        v[1][r].y += cq * v[2 + q][r].y;
      }
    }
  }
}

// k_stage <- k (stage 0..6 is a runtime value; the slots stay in registers).
template <int R>
__device__ __forceinline__ void put_stage(float2 (&v)[kSlots][R], int stage, const float2 (&k)[R]) {
#pragma unroll
  for (int q = 0; q <= kStages; ++q) {
    if (q == stage) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[2 + q][r] = k[r];
    }
  }
}

// The member's sum over rows i (in order) of |err_i|^2 / scale_i^2, in every
// lane of the group; he[q] = (f32)(h kE[q]).
template <int R>
__device__ __forceinline__ float error_sum(const Params& p, const float2 (&v)[kSlots][R],
                                           const float* he, const Lane& ln) {
  const float atol = (float)p.atol, rtol = (float)p.rtol;
  float e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float er = 0.0f, ei = 0.0f;
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      if (kE[q] != 0.0) {
        er += he[q] * v[2 + q][r].x;
        ei += he[q] * v[2 + q][r].y;
      }
    }
    const float2 y = v[0][r], w = v[1][r];
    const float ay = sqrtf(y.x * y.x + y.y * y.y);
    const float aw = sqrtf(w.x * w.x + w.y * w.y);
    const float scale = atol + rtol * fmaxf(ay, aw);
    e[r] = (er * er + ei * ei) / (scale * scale);
  }
  float sum = 0.0f;
#pragma unroll
  for (int r2 = 0; r2 < R; ++r2) {
    const int mend = min(ln.P, p.n - r2 * ln.P);
    for (int l = 0; l < mend; ++l) {
      const float x = __shfl_sync(ln.mask, e[r2], l, ln.P);
      sum = (r2 == 0 && l == 0) ? x : sum + x;
    }
  }
  return sum;
}

// State of member v of this lane's group between table passes (V > 1 only).
template <int R>
__device__ __forceinline__ float2* member_state(const Params& p, int v) {
  return p.scratch + ((size_t)blockIdx.x * p.groups_v + v) * kSlots * R * blockDim.x + threadIdx.x;
}

template <int R>
__device__ __forceinline__ void load_state(const Params& p, int v, float2 (&st)[kSlots][R]) {
  if (p.groups_v == 1) return;
  const float2* at = member_state<R>(p, v);
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) st[q][r] = at[(size_t)(q * R + r) * blockDim.x];
}

template <int R>
__device__ __forceinline__ void store_state(const Params& p, int v, const float2 (&st)[kSlots][R]) {
  if (p.groups_v == 1) return;
  float2* at = member_state<R>(p, v);
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
#pragma unroll
    for (int r = 0; r < R; ++r) at[(size_t)(q * R + r) * blockDim.x] = st[q][r];
}

// Thread 0's clock: adds the cycles since the last lap to clocks[q].
__device__ __forceinline__ void lap(const Params& p, Control& c, long long& mark, int q) {
  if (p.clocks != nullptr && threadIdx.x == 0) {
    const long long now = clock64();
    c.clocks[q] += now - mark;
    mark = now;
  }
}

template <int R, int K, int N>
__global__ void __launch_bounds__(R >= 4 ? 512 : 1024) adaptive_sweep_kernel(Params p) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = p.n, k = p.k, nn = n * n, S = p.passes_s, G = p.cluster, V = p.groups_v;
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / G;
  // shared memory: the control block, tables, carrier phases, per-group
  // coefficients (K == 0), per-warp maxima, the cluster exchange
  Control& ctl = *reinterpret_cast<Control*>(smem4);
  float2* tab = reinterpret_cast<float2*>(smem4) + (sizeof(Control) + 15) / 16 * 2;
  float2* cs = tab + (size_t)S * (k + 1) * nn;
  float* csh = reinterpret_cast<float*>(cs + (size_t)S * k);
  const int groups = blockDim.x / p.lanes;
  float* red = csh + (K == 0 ? groups * k : 0);
  float* xchg = red + 32;  // [2][kMaxCluster]

  Lane ln;
  ln.P = p.lanes;
  ln.lg = threadIdx.x & (ln.P - 1);
  const int grp = threadIdx.x / ln.P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_lanes = min(32, (int)blockDim.x - (warp << 5));
  ln.mask = warp_lanes == 32 ? 0xffffffffu : (1u << warp_lanes) - 1u;
  const size_t first_lane = (size_t)tile * p.tile_b + (size_t)rank * p.members;
  float* gcsh = csh + grp * k;

  float2 st[kSlots][R];
  float c[K > 0 ? K : 1];
  float2 env[K > 0 ? K : 1];
  auto member_lane = [&](int v) { return first_lane + grp + (size_t)v * groups; };

  // y = w = y0 (rows past n zero), stages zero
  for (int v = 0; v < V; ++v) {
    ln.b = member_lane(v);
#pragma unroll
    for (int q = 0; q < kSlots; ++q)
#pragma unroll
      for (int r = 0; r < R; ++r) st[q][r] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * ln.P + ln.lg;
      if (i < n) {
        const size_t g = (size_t)i * p.B + ln.b;
        st[0][r] = st[1][r] = make_float2(p.y0r[g], p.y0i[g]);
      }
    }
    store_state<R>(p, v, st);
  }
  // the controller's state and the first step, which begins with the FSAL
  // stage f(t0, y0) at envelope cell 0
  long long mark = 0;
  if (threadIdx.x == 0) {
    ctl.s = 0.0;
    ctl.h_prop = p.h0;
    ctl.steps = ctl.eidx = ctl.aidx = ctl.bad = 0;
    ctl.fsal = 1;
    ctl.fsal_cell = 0;
    for (int q = 0; q < 4; ++q) ctl.clocks[q] = 0;
    plan_step(p, ctl);
    mark = clock64();
  }
  // every block of the cluster runs before any writes to a peer's shared memory
  cluster.sync();

  for (int iter = 0; !ctl.done; ++iter) {
    // stage 0 after a cell crossing (and first of all), then the six new
    // stages, S per table pass
    float local = 0.0f;
    for (int first = ctl.fsal ? 0 : 1, pass = 0; first <= kStages; ++pass) {
      const int count = first == 0 ? 1 : min(S, kStages + 1 - first);
      const int cell = first == 0 ? ctl.fsal_cell : ctl.cell;
      // every warp is done reading the previous pass's tables (before a
      // step's first pass the exchange's cluster barrier saw to it)
      if (pass > 0) cluster.sync();
      form_tables(p, tab, cs, first, count, ctl.s, ctl.h, cluster, rank, G);
      cluster.sync();
      lap(p, ctl, mark, 0);
      for (int v = 0; v < V; ++v) {
        ln.b = member_lane(v);
        load_state<R>(p, v, st);
        if constexpr (K > 0) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const size_t e = ((size_t)j * p.n_env + cell) * p.B + ln.b;
            env[j] = make_float2(p.envr[e], p.envi[e]);
          }
        }
#pragma unroll 1
        for (int stage = first; stage < first + count; ++stage) {
          const int slot = stage - first;
          if (stage > 0) combine<R>(st, ctl.coef[stage], stage);  // 5th-order solution at 6
          coefficients<K>(p, cs + slot * k, env, cell, ln, c, gcsh);
          float2 out[R];
          rhs<R, K, N>(tab + (size_t)slot * (k + 1) * nn, n, k, c, gcsh, st[1], out, ln);
          put_stage<R>(st, stage, out);
        }
        if (first + count > kStages) local = nmaxf(local, error_sum<R>(p, st, ctl.err, ln));
        store_state<R>(p, v, st);
      }
      lap(p, ctl, mark, 1);
      first += count;
    }

    // max over the tile: the warp's members, the block's warps, the cluster's blocks
    for (int off = 16; off >= ln.P; off >>= 1) {
      const float other = __shfl_xor_sync(ln.mask, local, off);
      if ((lane ^ off) < warp_lanes) local = nmaxf(local, other);
    }
    if (lane == 0) red[warp] = local;
    __syncthreads();
    float* slots = xchg + (iter & 1) * kMaxCluster;
    if (threadIdx.x == 0) {
      float block_max = red[0];
      for (int q = 1; q < (int)((blockDim.x + 31) >> 5); ++q) block_max = nmaxf(block_max, red[q]);
      for (int g = 0; g < G; ++g) cluster.map_shared_rank(slots, g)[rank] = block_max;
    }
    cluster.sync();
    lap(p, ctl, mark, 2);
    if (threadIdx.x == 0) {
      float tile_max = slots[0];
      for (int g = 1; g < G; ++g) tile_max = nmaxf(tile_max, slots[g]);
      finish_step(p, ctl, sqrtf(tile_max / (float)n), rank, tile);
      plan_step(p, ctl);
    }
    __syncthreads();
    if (ctl.accept) {
      for (int v = 0; v < V; ++v) {
        load_state<R>(p, v, st);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          st[0][r] = st[1][r];
          st[2][r] = st[8][r];
        }
        store_state<R>(p, v, st);
      }
    }
    if (ctl.eval_slot >= 0) {
      for (int v = 0; v < V; ++v) {
        ln.b = member_lane(v);
        load_state<R>(p, v, st);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = r * ln.P + ln.lg;
          if (i < n) {
            const size_t g = ((size_t)ctl.eval_slot * n + i) * p.B + ln.b;
            p.evalr[g] = st[0][r].x;
            p.evali[g] = st[0][r].y;
          }
        }
      }
    }
    lap(p, ctl, mark, 3);
  }

  // NaN-poison the tile if the budget ran out, a stalled step was forced
  // through far out of tolerance, or an eval time was missed
  const bool ok = (p.dur - ctl.s) <= 0.0 && !ctl.bad && ctl.eidx >= p.n_eval;
  const float poison = ok ? 1.0f : nanf("");
  for (int v = 0; v < V; ++v) {
    ln.b = member_lane(v);
    load_state<R>(p, v, st);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = r * ln.P + ln.lg;
      if (i >= n) continue;
      const size_t g = (size_t)i * p.B + ln.b;
      p.outr[g] = st[0][r].x * poison;
      p.outi[g] = st[0][r].y * poison;
      for (int e = 0; e < p.n_eval; ++e) {
        const size_t ge = ((size_t)e * n + i) * p.B + ln.b;
        p.evalr[ge] *= poison;
        p.evali[ge] *= poison;
      }
    }
  }
  if (threadIdx.x == 0) {
    if (p.steps_out != nullptr && rank == 0) p.steps_out[tile] = ctl.steps;
    if (p.step_counts != nullptr && rank == 0) {
      atomicAdd(&p.step_counts[0], (unsigned long long)ctl.steps);
      atomicAdd(&p.step_counts[1], (unsigned long long)ctl.aidx);
    }
    if (p.clocks != nullptr) {
      for (int q = 0; q < 4; ++q) p.clocks[(size_t)blockIdx.x * 4 + q] = ctl.clocks[q];
    }
  }
  // no block leaves while a peer may still write to its shared memory
  cluster.sync();
}

using Kernel = void (*)(Params);

// The instantiation for R rows per lane of P lanes, K coefficients (K = 0:
// any k) and, at the main row's n = 16 with two operators and P R = 16, a
// compile-time n.
Kernel kernel_for(int R, int k, int n, int P) {
  const bool two = k == 2;
  if (two && n == 16 && P * R == 16) {
    switch (R) {
      case 1: return &adaptive_sweep_kernel<1, 2, 16>;
      case 2: return &adaptive_sweep_kernel<2, 2, 16>;
      case 4: return &adaptive_sweep_kernel<4, 2, 16>;
      default: return nullptr;
    }
  }
  switch (R) {
    case 1: return two ? &adaptive_sweep_kernel<1, 2, 0> : &adaptive_sweep_kernel<1, 0, 0>;
    case 2: return two ? &adaptive_sweep_kernel<2, 2, 0> : &adaptive_sweep_kernel<2, 0, 0>;
    case 4: return two ? &adaptive_sweep_kernel<4, 2, 0> : &adaptive_sweep_kernel<4, 0, 0>;
    default: return nullptr;
  }
}

// Threads per block the instantiation at R rows per lane is compiled for
// (its __launch_bounds__; registers: 64 a thread at 1,024, 128 at 512).
// ops/adaptive_sweep.py's MAX_THREADS repeats it.
int max_threads_for(int R) {
  return R >= 4 ? 512 : 1024;
}

// Dynamic shared memory of one block: the control block (padded to 16
// bytes), S stages of tables and carrier phases, the per-group coefficients
// of the any-k instantiation, 32 warp maxima and the exchange (2 x
// kMaxCluster floats).
size_t smem_bytes(int n, int k, int S, int threads, int P) {
  const size_t groups = (size_t)(threads / P);
  return (sizeof(Control) + 15) / 16 * 16 +
         sizeof(float2) * (size_t)S * ((size_t)(k + 1) * n * n + k) +
         sizeof(float) * ((k == 2 ? 0 : groups * k) + 32 + 2 * kMaxCluster);
}

bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// Checks a launch shape and fills the launch configuration (grid of tiles x
// G blocks in clusters of G). Returns 0 or an error code.
int configure(int n, int k, int tile_b, int n_tiles, int G, int P, int R, int threads, int V,
              int S, Kernel* fn, cudaLaunchConfig_t* config, cudaLaunchAttribute* attribute) {
  if (n < 1 || n > kMaxN || k < 1 || tile_b < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  if (!is_pow2(G) || G > kMaxCluster || tile_b % G != 0 || !is_pow2(P) || P > 32 ||
      P * R < n || S < 1 || S > kStages || threads % P != 0 || V < 1 ||
      (tile_b / G) != (threads / P) * V) {
    return kErrShape;
  }
  *fn = kernel_for(R, k, n, P);
  if (*fn == nullptr || threads > max_threads_for(R)) return kErrShape;
  const size_t smem = smem_bytes(n, k, S, threads, P);
  cudaError_t err =
      cudaFuncSetAttribute((const void*)*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (G > 8) {
    err = cudaFuncSetAttribute((const void*)*fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned)(n_tiles * G));
  config->blockDim = dim3((unsigned)threads);
  config->dynamicSmemBytes = smem;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = (unsigned)G;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config->attrs = attribute;
  config->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

// Clusters of the launch shape (G, P, R, threads, V, S) that the card
// co-schedules (the CUDA occupancy calculator); a negative error code where
// the shape is refused.
int adaptive_sweep_active_clusters(int n, int k, int tile_b, int G, int P, int R, int threads,
                                   int V, int S) {
  Kernel fn;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int code = configure(n, k, tile_b, 1, G, P, R, threads, V, S, &fn, &config, &attribute);
  if (code != 0) return -code;
  int count = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&count, (const void*)fn, &config);
  cudaGetLastError();
  return err == cudaSuccess ? count : -(int)err;
}

// Launch one cluster of G blocks per tile on `stream`, at the launch shape
// the wrapper chose. Returns 0, a CUDA error code, kErrShape for a shape the
// kernel does not take, or kErrResident where the card co-schedules no
// cluster of it; the kernel itself reports faults at the next
// synchronization.
int adaptive_sweep_launch(const float* statr, const float* stati, const float* opsr,
                          const float* opsi, const double* omega, const double* freqs,
                          const float* envr, const float* envi, const double* eval_ts,
                          const float* y0r, const float* y0i, float* outr, float* outi,
                          float* evalr, float* evali, double* rec, float* scratch,
                          int* steps_out, long long* clocks,
                          unsigned long long* step_counts, int n, int k,
                          int n_env, int n_eval, int B, int tile_b, int max_steps, int record,
                          double t0, double dur, double env_dt, double atol, double rtol,
                          double h0, int G, int P, int R, int threads, int V, int S,
                          void* stream) {
  if (B % tile_b != 0 || (V > 1 && scratch == nullptr)) return (int)cudaErrorInvalidValue;
  Kernel fn;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;
  int code = configure(n, k, tile_b, B / tile_b, G, P, R, threads, V, S, &fn, &config, &attribute);
  if (code != 0) return code;
  // the occupancy query, once per device and shape
  static int cached[10] = {-1};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int key[10] = {device, n, k, tile_b, G, P, R, threads, V, S};
  bool hit = true;
  for (int q = 0; q < 10; ++q) hit = hit && cached[q] == key[q];
  if (!hit) {
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, (const void*)fn, &config);
    if (err != cudaSuccess) return (int)err;
    if (count < 1) return kErrResident;
    for (int q = 0; q < 10; ++q) cached[q] = key[q];
  }
  Params p{statr, stati, opsr, opsi, omega, freqs, envr, envi, eval_ts, y0r, y0i,
           outr, outi, evalr, evali, rec, reinterpret_cast<float2*>(scratch), steps_out,
           clocks, step_counts, n, k, n_env, n_eval, B, tile_b, max_steps, record,
           G, P, tile_b / G, V, S, t0, dur, env_dt, atol, rtol, h0};
  config.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&config, fn, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block at (n, k, S stages per pass, threads,
// P lanes per member): ops/adaptive_sweep.py's shared_bytes repeats it.
long long adaptive_sweep_smem_bytes(int n, int k, int S, int threads, int P) {
  return (long long)smem_bytes(n, k, S, threads, P);
}

const char* adaptive_sweep_error_string(int code) {
  if (code == kErrShape) return "the launch shape is not one the kernel takes";
  if (code == kErrResident) return "the card co-schedules no cluster of this launch shape";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
