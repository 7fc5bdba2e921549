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
//
// What bounds it on this card. Operations, by count: at the df32 row (n = 16,
// k = 2, Magnus-3 with `herm`, order 12, 10,000 members x 500 steps) a
// member-step is three n^3 complex products (32.8 kFLOP each) at the FP64
// tensor cores' 67 TFLOP/s, and twelve mat-vecs (2.1 kFLOP each), the
// generator builds and the rule's elementwise terms at 34 TFLOP/s: at least
// 13.9 ms (chip_smoke.df_bound). In practice latency and the load/store path
// stand beside the rate: a member's step is a chain of dependent work (the
// build's table reads from L2, three products, twelve mat-vecs) that one warp
// alone runs in ~8.8 us on an H100, and at the row 16 warps per SM share the
// load/store path with ~37 KB of table reads per member-step. The first
// designs of this kernel (four threads per row and member, four shared loads
// per complex multiply-add, a block barrier in every Horner iteration, frame
// phases recomputed in every block, one 16-warp block per SM) took 163 ms
// there.
//
// Design.
// - One warp per member. The members of a block share nothing, so a member's
//   products, elementwise passes and Horner iterations synchronize with
//   __syncwarp only; a block is just mb warps (the wrapper's launch_shape
//   sizes mb so that a small launch spreads over as many SMs as it has
//   members).
// - The products on the FP64 tensor cores: mma.sync m8n8k4 (DMMA, IEEE FP64
//   fused multiply-adds). Lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and
//   C[l / 4][2 (l % 4) + {0, 1}] of a tile. A complex product is four real
//   ones on the same fragments (Re += Ar Br - Ai Bi, Im += Ar Bi + Ai Br, the
//   sign on the A fragment, which is exact), so each 16-byte load of a
//   complex entry feeds four DMMAs; no 3-multiplication trick (it loses
//   digits in C - C^H). A warp forms a row of 8 x 8 tiles at a time. n is
//   padded with zeros to NP = 8, 16, 24 or 32 (one instantiation each);
//   zeros stay zero through every step.
// - Matrices are complex planes of NP x NP in shared memory, unpadded, with
//   the columns of row r XOR-swizzled (swz): the 16-byte accesses of a
//   quarter-warp to fragments, owned entries and their transposes all fall
//   on distinct bank groups. Each lane owns the entries of the accumulator
//   layout (NP^2 / 32 of them); elementwise passes touch only owned entries
//   (and, for C - C^H, the transposed ones, after a __syncwarp).
// - Three planes per member: Magnus-3 keeps a3 and one temporary at the
//   owned entries, in registers at NP <= 16 (two more planes above); the
//   product C2 is stored over its operand 2 a3 + [a1, a2] (each row of tiles
//   is read only for itself), and a1 + a3 / 12 takes a3's place once left is
//   formed. At the df32 row a member needs 12.8 KB and 128 registers: 16
//   members (warps) per SM, so a launch of 2,048 members is one wave.
// - The Horner action from registers: at NP <= 16 each lane holds its row
//   part of M (a row is spread over 32 / NP lanes, summed by xor shuffles
//   that give every lane the same bits); the vector goes through a
//   warp-private double buffer, one __syncwarp per iteration.
// - Frame-rotated tables once per call (df_tables_kernel, a first
//   __global__): W[s, g, j] = P(tau_{s,g}) o O_j (O_0 = S) with the phases
//   cos/sin(fmod(omega tau, 2 pi)) in float64, so a generator entry is
//   W_0 + sum_j c_j W_j, k multiply-adds read from L2. Layout by size (the
//   wrapper's rotated_tables): these "rotated" tables while T x nn x (k + 1)
//   x NP^2 x 16 B is at most 40 MiB (18.4 MB at the df32 row), else a (T, nn,
//   NP, NP) table of (cos, sin) beside the padded operators (k + 1, NP, NP),
//   and the build forms P o (S + sum_j c_j O_j) (2-5% slower at the row). Both
//   are stored in lane order, so a warp reads 512 contiguous bytes per owned
//   entry, and the build issues a node's loads for all owned entries at once.
// - The next step's coefficients are loaded while the current step runs.
//
// Any B: the lanes [b0, b0 + nb) of rows of length ldb are this launch's
// members; a warp past the end of the last block returns at once.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxMembers = 8;  // warps (members) per block
constexpr double kTwoPi = 6.283185307179586;

__host__ __device__ constexpr int padded(int n) { return (n + 7) / 8 * 8; }

// complex planes of NP x NP per member: three, and at NP > 16 two more for
// Magnus-3's owned matrices (a3 and a temporary), which live in registers below
__host__ __device__ constexpr int planes(int np, int nn) {
  return 3 + ((nn == 3 && np > 16) ? 2 : 0);
}

// 16-byte slots of one member: planes, two Horner vectors, nn k coefficients
// (doubles, rounded up to whole slots)
__host__ __device__ constexpr size_t member_slots(int n, int k, int nn) {
  return (size_t)planes(padded(n), nn) * padded(n) * padded(n) + 2 * (size_t)padded(n) +
         ((size_t)nn * k + 1) / 2;
}

// Column swizzle of row r: s(r) = 5 (r & 1) ^ (r & 6), within each group of 8
// columns. A quarter-warp's 16-byte accesses then fall on 8 distinct bank
// groups for the A fragment (rows 2a, 2a + 1 x 4 columns), the B fragment
// (4 rows x columns 2m, 2m + 1), the owned entries (rows 2a, 2a + 1 x
// columns {0, 2, 4, 6} + j) and their transposes.
__host__ __device__ constexpr int swz(int r) { return ((r & 1) ? 5 : 0) ^ (r & 6); }

// Index of entry (r, c) in the tables' lane order: owned entry o of lane l
// at o * 32 + l, so that a warp's load of one owned entry is 512 contiguous bytes
__host__ __device__ inline int lane_order(int np, int r, int c) {
  const int ti = r >> 3, lr = r & 7, tj = c >> 3, lq = (c & 7) >> 1, j = c & 1;
  return ((((ti * (np / 8) + tj) << 1) | j) << 5) | (lr << 2) | lq;
}

// ---------------------------------------------------------------------------
// The frame-rotated tables, once per call
// ---------------------------------------------------------------------------
struct TableParams {
  const double2* stat;  // (n, n) complex128
  const double2* ops;   // (k, n, n)
  const double* omega;  // (n, n)
  const double* taus;   // (T, nn) absolute node times
  double2* opsp;        // out: (k + 1, np, np) operators, S first, zero padded
  double2* tab;         // out: rotated (T, nn, k + 1, np, np), or (T, nn, np, np) (cos, sin);
                        // each np x np table in lane order (lane_order)
  int n, k, T, nn, np, rotated;
};

__global__ void df_tables_kernel(TableParams p) {
  const int n = p.n, np = p.np, nsq = np * np, k1 = p.k + 1;
  const long stride = (long)gridDim.x * blockDim.x;
  const long first = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long idx = first; idx < (long)k1 * nsq; idx += stride) {
    const int j = (int)(idx / nsq), e = (int)(idx % nsq), r = e / np, c = e % np;
    double2 v = make_double2(0.0, 0.0);
    if (r < n && c < n) v = j == 0 ? p.stat[r * n + c] : p.ops[((size_t)(j - 1) * n + r) * n + c];
    p.opsp[(size_t)j * nsq + lane_order(np, r, c)] = v;
  }
  const long total = (long)p.T * p.nn * nsq;
  for (long idx = first; idx < total; idx += stride) {
    const long sg = idx / nsq;  // step * nn + node
    const int e = (int)(idx % nsq), r = e / np, c = e % np;
    double cv = 0.0, sv = 0.0;
    const bool inside = r < n && c < n;
    if (inside) {
      const double ph = fmod(p.omega[r * n + c] * p.taus[sg], kTwoPi);
      sincos(ph, &sv, &cv);
    }
    const int at = lane_order(np, r, c);
    if (!p.rotated) {
      p.tab[(size_t)sg * nsq + at] = make_double2(cv, sv);
      continue;
    }
    double2* w = p.tab + (size_t)sg * k1 * nsq + at;
    for (int j = 0; j < k1; ++j) {
      double2 o = make_double2(0.0, 0.0);
      if (inside) o = j == 0 ? p.stat[r * n + c] : p.ops[((size_t)(j - 1) * n + r) * n + c];
      w[(size_t)j * nsq] = make_double2(cv * o.x - sv * o.y, cv * o.y + sv * o.x);
    }
  }
}

// ---------------------------------------------------------------------------
// Planes, owned entries and the DMMA product
// ---------------------------------------------------------------------------
// 16-byte slot of entry (r, c) of a swizzled NP x NP plane
template <int NP>
__device__ __forceinline__ int slot(int r, int c) {
  return r * NP + (c ^ swz(r));
}

// A lane's addressing. Owned entry o (o < NP^2 / 32) is entry j = o & 1 of
// accumulator tile t = o >> 1 = ti NT + tj: row 8 ti + l / 4, column
// 8 tj + 2 (l % 4) + j.
template <int NP>
struct Frag {
  static constexpr int NT = NP / 8;
  int lane;
  int own0, tr0, tr1;  // owned entry (j = 0; j = 1 is own0 ^ 1) and its transposes, tile (0, 0)
  int a0, b0;          // fragment slots in a group of 8: A at k-columns 0..3 (4..7: a0 ^ 4),
                       // B at k-rows 0..3 (4..7: (b0 ^ 4) + 4 NP)

  __device__ explicit Frag(int l) : lane(l) {
    const int lr = l >> 2, lq = l & 3;
    own0 = lr * NP + ((2 * lq) ^ swz(lr));
    tr0 = (2 * lq) * NP + (lr ^ swz(2 * lq));
    tr1 = (2 * lq + 1) * NP + (lr ^ swz(2 * lq + 1));
    a0 = lr * NP + (lq ^ swz(lr));
    b0 = lq * NP + (lr ^ swz(lq));
  }
  __device__ __forceinline__ int own(int o) const {
    const int t = o >> 1;
    return (own0 ^ (o & 1)) + 8 * (t / NT) * NP + 8 * (t % NT);
  }
  __device__ __forceinline__ int glob(int o) const { return (o << 5) | lane; }
  __device__ __forceinline__ int tr(int o) const {
    const int t = o >> 1;
    return ((o & 1) ? tr1 : tr0) + 8 * (t % NT) * NP + 8 * (t / NT);
  }
};

// A matrix the lane touches only at its owned entries: registers, or a plane.
template <int NP, bool REGS>
struct Owned;

template <int NP>
struct Owned<NP, true> {
  double2 v[NP * NP / 32];
  __device__ explicit Owned(double2*) {}
  __device__ __forceinline__ double2& at(const Frag<NP>&, int o) { return v[o]; }
};

template <int NP>
struct Owned<NP, false> {
  double2* p;
  __device__ explicit Owned(double2* plane) : p(plane) {}
  __device__ __forceinline__ double2& at(const Frag<NP>& f, int o) { return p[f.own(o)]; }
};

// d += a b on one m8n8k4 tile in FP64
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// out(o, z) for every owned entry o of Z = X Y (COMM: X Y - Y X), X and Y
// swizzled planes, one row of tiles at a time. Without COMM, Z may be stored
// over X: row tile ti of X is read only for row tile ti of Z, and each row is
// stored after a __syncwarp.
template <int NP, bool COMM, class Out>
__device__ __forceinline__ void product(const double2* X, const double2* Y, const Frag<NP>& f,
                                        Out out) {
  constexpr int NT = NP / 8;
#pragma unroll
  for (int ti = 0; ti < NT; ++ti) {
    double cr[NT][2], ci[NT][2];
#pragma unroll
    for (int t = 0; t < NT; ++t) cr[t][0] = cr[t][1] = ci[t][0] = ci[t][1] = 0.0;
#pragma unroll
    for (int pass = 0; pass < (COMM ? 2 : 1); ++pass) {
      const double2* A = pass == 0 ? X : Y;
      const double2* B = pass == 0 ? Y : X;
      const double sgn = pass == 0 ? 1.0 : -1.0;
#pragma unroll 2
      for (int kk = 0; kk < NP; kk += 4) {
        const int g8 = kk & ~7;  // the group of 8 columns (A) or rows (B)
        const double2 a = A[((kk & 4) ? f.a0 ^ 4 : f.a0) + 8 * ti * NP + g8];
        const double ar = sgn * a.x, ai = sgn * a.y;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const double2 b = B[((kk & 4) ? (f.b0 ^ 4) + 4 * NP : f.b0) + g8 * NP + 8 * t];
          dmma(cr[t], ar, b.x);   // Re += Ar Br
          dmma(cr[t], -ai, b.y);  //      - Ai Bi
          dmma(ci[t], ar, b.y);   // Im += Ar Bi
          dmma(ci[t], ai, b.x);   //      + Ai Br
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int j = 0; j < 2; ++j) out(((ti * NT + t) << 1) | j, make_double2(cr[t][j], ci[t][j]));
    }
  }
}

// (C - C^H) at owned entry o of the complete plane C
template <int NP>
__device__ __forceinline__ double2 anti(const double2* C, const Frag<NP>& f, int o) {
  const double2 c = C[f.own(o)], t = C[f.tr(o)];
  return make_double2(c.x - t.x, c.y + t.y);
}

// ---------------------------------------------------------------------------
// The sweep
// ---------------------------------------------------------------------------
struct SweepParams {
  const double2* opsp;  // (k + 1, np, np)
  const double2* tab;   // rotated (T, nn, k + 1, np, np) or (cos, sin) (T, nn, np, np)
  const double* sc;     // (T, 3) step constants: (dt/2, p2 dt^2, -) or (dt, c0 dt, c1 dt)
  const double* coef;   // (T, nn, k, ldb)
  const int* slots;     // (T,) trajectory slot after each step (-1: none), or null
  const double2* y0;    // (n, ldb)
  double2* out;         // (n, ldb)
  double2* evals;       // (n_eval, n, ldb), or null
  int n, k, T, nn, order, herm, rotated, mb, b0, nb, ldb;
};

template <int NP>
__global__ void __launch_bounds__(32 * kMaxMembers, NP <= 16 ? 2 : 1)
    df_magnus_sweep_kernel(SweepParams p) {
  constexpr int NSQ = NP * NP, NO = NSQ / 32;
  constexpr bool kRegs = NP <= 16;
  constexpr int LPR = NP <= 8 ? 4 : (NP <= 16 ? 2 : 1);  // Horner lanes per row
  constexpr int CPL = NP / LPR;                          // Horner columns per lane
  extern __shared__ double2 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int member = p.b0 + blockIdx.x * p.mb + warp;
  if (member >= p.b0 + p.nb) return;  // the whole warp
  const int n = p.n, k = p.k, nn = p.nn, nk = nn * k, ldb = p.ldb;

  double2* P0 = smem + (size_t)warp * member_slots(n, k, nn);
  double2* P1 = P0 + NSQ;
  double2* P2 = P1 + NSQ;
  double2* vbuf = P0 + (size_t)planes(NP, nn) * NSQ;  // two vectors of NP
  double* cbuf = reinterpret_cast<double*>(vbuf + 2 * NP);
  const Frag<NP> f(lane);

  // Horner lanes: row hrow, columns hc0 .. hc0 + CPL - 1
  const int hrow = lane / LPR, hc0 = (lane % LPR) * CPL;
  const bool hrow_ok = hrow < NP;  // NP = 24 leaves lanes 24..31 without a row
  const bool head = lane % LPR == 0;
  // at NP = 16 the second lane of a row reads its columns rotated by 4, so
  // that the two halves' vector reads fall on distinct banks
  const int hrot = LPR == 2 ? 4 * (lane % LPR) : 0;
  auto hcol = [&](int m) { return hc0 + (LPR == 2 ? ((m + hrot) & (CPL - 1)) : m); };
  double2 y = make_double2(0.0, 0.0);
  if (hrow < n) y = p.y0[(size_t)hrow * ldb + member];
  if (head && hrow_ok) vbuf[hrow] = y;
  int cur = 0;

  const int kt = p.rotated ? k + 1 : 1;  // tables per node and step
  double cnext = 0.0;
  if (lane < nk) cnext = __ldg(&p.coef[(size_t)lane * ldb + member]);

  for (int s = 0; s < p.T; ++s) {
    if (lane < nk) cbuf[lane] = cnext;
    for (int l = lane + 32; l < nk; l += 32) cbuf[l] = __ldg(&p.coef[((size_t)s * nk + l) * ldb + member]);
    if (lane < nk && s + 1 < p.T) cnext = __ldg(&p.coef[((size_t)(s + 1) * nk + lane) * ldb + member]);
    const double sc0 = __ldg(&p.sc[3 * s]), sc1 = __ldg(&p.sc[3 * s + 1]),
                 sc2 = __ldg(&p.sc[3 * s + 2]);
    __syncwarp();  // the coefficients are in; the previous step is done with every plane

    // G_g at every owned entry, into the owned entries of plane Z; a table's
    // loads are independent across the entries, so they are in flight together
    const double2* tab_s = p.tab + (size_t)s * nn * kt * NSQ;
    auto build = [&](int g, double2* Z) {
      const double* cf = cbuf + g * k;
      const double2* w = p.rotated ? tab_s + (size_t)g * kt * NSQ : p.opsp;
      double2 acc[NO];
#pragma unroll
      for (int o = 0; o < NO; ++o) acc[o] = __ldg(w + f.glob(o));
      for (int j = 0; j < k; ++j) {
        const double c = cf[j];
        const double2* wj = w + (size_t)(j + 1) * NSQ;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const double2 x = __ldg(wj + f.glob(o));
          acc[o].x = fma(c, x.x, acc[o].x);
          acc[o].y = fma(c, x.y, acc[o].y);
        }
      }
      if (p.rotated) {
#pragma unroll
        for (int o = 0; o < NO; ++o) Z[f.own(o)] = acc[o];
      } else {  // P o (S + sum_j c_j O_j)
        const double2* ph = tab_s + (size_t)g * NSQ;
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const double2 q = __ldg(ph + f.glob(o)), a = acc[o];
          Z[f.own(o)] = make_double2(q.x * a.x - q.y * a.y, q.x * a.y + q.y * a.x);
        }
      }
    };
    auto store = [&f](double2* Z) {
      return [Z, &f](int o, double2 z) { Z[f.own(o)] = z; };
    };

    const double2* M;
    if (nn == 2) {
      build(0, P1);  // P0 = G_2, P1 = G_1
      build(1, P0);
      __syncwarp();
      if (p.herm) {  // M = dt/2 (G_1 + G_2) + p2 dt^2 (C - C^H), C = G_2 G_1, into P0
        product<NP, false>(P0, P1, f, store(P2));
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) {
          const int e = f.own(o);
          const double2 g2 = P0[e], g1 = P1[e], kc = anti<NP>(P2, f, o);
          P0[e] = make_double2((g1.x + g2.x) * sc0 + kc.x * sc1, (g1.y + g2.y) * sc0 + kc.y * sc1);
        }
        M = P0;
      } else {  // M = dt/2 (G_1 + G_2) + p2 dt^2 [G_2, G_1], into P2
        product<NP, true>(P0, P1, f, [&](int o, double2 z) {
          const int e = f.own(o);
          const double2 g2 = P0[e], g1 = P1[e];
          P2[e] = make_double2((g1.x + g2.x) * sc0 + z.x * sc1, (g1.y + g2.y) * sc0 + z.y * sc1);
        });
        M = P2;
      }
    } else {
      // P0 = a1, P1 = a2, E = a3 (owned entries); T a temporary
      Owned<NP, kRegs> E(P2 + NSQ), T(P2 + 2 * NSQ);
      build(0, P2);
      build(1, P0);
      build(2, P1);
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int e = f.own(o);
        const double2 g1 = P2[e], g2 = P0[e], g3 = P1[e];
        P0[e] = make_double2(sc0 * g2.x, sc0 * g2.y);
        P1[e] = make_double2(sc1 * (g3.x - g1.x), sc1 * (g3.y - g1.y));
        E.at(f, o) = make_double2(sc2 * ((g3.x - g2.x) + (g1.x - g2.x)),
                                  sc2 * ((g3.y - g2.y) + (g1.y - g2.y)));
      }
      __syncwarp();
      if (p.herm) {
        product<NP, false>(P0, P1, f, store(P2));  // C1 = a1 a2
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) T.at(f, o) = anti<NP>(P2, f, o);  // [a1, a2]
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) {  // P2 = 2 a3 + [a1, a2]; T = left; E = a1 + a3 / 12
          const int e = f.own(o);
          const double2 a1 = P0[e], a3 = E.at(f, o), k1 = T.at(f, o);
          P2[e] = make_double2(2.0 * a3.x + k1.x, 2.0 * a3.y + k1.y);
          T.at(f, o) = make_double2(k1.x - (20.0 * a1.x + a3.x), k1.y - (20.0 * a1.y + a3.y));
          E.at(f, o) = make_double2(a1.x + a3.x * (1.0 / 12.0), a1.y + a3.y * (1.0 / 12.0));
        }
        __syncwarp();
        product<NP, false>(P2, P0, f, store(P2));  // C2 = (2 a3 + [a1, a2]) a1, over its operand
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) {  // P1 = right = a2 + (C2 - C2^H) / 60; P0 = left
          const int e = f.own(o);
          const double2 a2 = P1[e], kc = anti<NP>(P2, f, o);
          P1[e] = make_double2(a2.x + kc.x * (1.0 / 60.0), a2.y + kc.y * (1.0 / 60.0));
          P0[e] = T.at(f, o);
        }
        __syncwarp();
        product<NP, false>(P0, P1, f, store(P2));  // C3 = left right
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) {  // M = a1 + a3 / 12 + (C3 - C3^H) / 240, into P0
          const double2 s3 = E.at(f, o), kc = anti<NP>(P2, f, o);
          P0[f.own(o)] =
              make_double2(s3.x + kc.x * (1.0 / 240.0), s3.y + kc.y * (1.0 / 240.0));
        }
        M = P0;
      } else {
        product<NP, true>(P0, P1, f, store(P2));  // [a1, a2]
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) {  // P2 = 2 a3 + [a1, a2]; T = left; E = a1 + a3 / 12
          const int e = f.own(o);
          const double2 a1 = P0[e], a3 = E.at(f, o), k1 = P2[e];
          P2[e] = make_double2(2.0 * a3.x + k1.x, 2.0 * a3.y + k1.y);
          T.at(f, o) = make_double2(k1.x - (20.0 * a1.x + a3.x), k1.y - (20.0 * a1.y + a3.y));
          E.at(f, o) = make_double2(a1.x + a3.x * (1.0 / 12.0), a1.y + a3.y * (1.0 / 12.0));
        }
        __syncwarp();
        product<NP, true>(P2, P0, f, [&](int o, double2 z) {  // P1 = right = a2 + [., a1] / 60
          const int e = f.own(o);
          const double2 a2 = P1[e];
          P1[e] = make_double2(a2.x + z.x * (1.0 / 60.0), a2.y + z.y * (1.0 / 60.0));
        });
        __syncwarp();
#pragma unroll
        for (int o = 0; o < NO; ++o) P0[f.own(o)] = T.at(f, o);  // P0 = left
        __syncwarp();
        product<NP, true>(P0, P1, f, [&](int o, double2 z) {  // M = E + [left, right] / 240
          const double2 s3 = E.at(f, o);
          P2[f.own(o)] = make_double2(s3.x + z.x * (1.0 / 240.0), s3.y + z.y * (1.0 / 240.0));
        });
        M = P2;
      }
    }
    __syncwarp();  // M is complete

    // y <- expm(M) y by the Horner mat-vec; vbuf[cur] holds y
    double2 mrow[kRegs ? CPL : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int m = 0; m < CPL; ++m) mrow[m] = M[slot<NP>(hrow, hcol(m))];
    }
    double2 v = y;
    for (int j = p.order; j >= 1; --j) {
      const double inv = 1.0 / (double)j;
      const double2* vin = vbuf + cur * NP;
      double wr0 = 0.0, wi0 = 0.0, wr1 = 0.0, wi1 = 0.0;
      if (hrow_ok) {
#pragma unroll
        for (int m = 0; m < CPL; m += 2) {
          const double2 x0 = vin[hcol(m)], x1 = vin[hcol(m + 1)];
          double2 m0, m1;
          if constexpr (kRegs) {
            m0 = mrow[m];
            m1 = mrow[m + 1];
          } else {
            m0 = M[slot<NP>(hrow, hcol(m))];
            m1 = M[slot<NP>(hrow, hcol(m + 1))];
          }
          wr0 = fma(m0.x, x0.x, wr0);
          wr0 = fma(-m0.y, x0.y, wr0);
          wi0 = fma(m0.x, x0.y, wi0);
          wi0 = fma(m0.y, x0.x, wi0);
          wr1 = fma(m1.x, x1.x, wr1);
          wr1 = fma(-m1.y, x1.y, wr1);
          wi1 = fma(m1.x, x1.y, wi1);
          wi1 = fma(m1.y, x1.x, wi1);
        }
      }
      double wr = wr0 + wr1, wi = wi0 + wi1;
#pragma unroll
      for (int d = 1; d < LPR; d <<= 1) {  // a + b and b + a: every lane of the row, the same bits
        wr += __shfl_xor_sync(0xffffffffu, wr, d);
        wi += __shfl_xor_sync(0xffffffffu, wi, d);
      }
      v = make_double2(y.x + wr * inv, y.y + wi * inv);
      if (head && hrow_ok) vbuf[(cur ^ 1) * NP + hrow] = v;
      __syncwarp();
      cur ^= 1;
    }
    y = v;

    if (p.slots != nullptr && head && hrow < n) {
      const int slot_s = __ldg(&p.slots[s]);
      if (slot_s >= 0) p.evals[((size_t)slot_s * n + hrow) * ldb + member] = y;
    }
  }
  if (head && hrow < n) p.out[(size_t)hrow * ldb + member] = y;
}

// One warp: Z = X Y (mode 0), X Y - Y X (mode 1) or C - C^H with C = X Y
// (mode 2), for (n, n) complex128 row-major X, Y, Z, through the sweep's
// planes, product and transposed reads. For the card tests of the fragment
// layout.
template <int NP>
__global__ void df_product_kernel(const double2* X, const double2* Y, double2* Z, int n, int mode) {
  extern __shared__ double2 smem[];
  double2* PX = smem;
  double2* PY = PX + NP * NP;
  double2* PZ = PY + NP * NP;
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < NP * NP; e += 32) {
    const int r = e / NP, c = e % NP;
    const bool inside = r < n && c < n;
    PX[slot<NP>(r, c)] = inside ? X[r * n + c] : make_double2(0.0, 0.0);
    PY[slot<NP>(r, c)] = inside ? Y[r * n + c] : make_double2(0.0, 0.0);
  }
  __syncwarp();
  const Frag<NP> f(lane);
  auto store = [&](int o, double2 z) { PZ[f.own(o)] = z; };
  if (mode == 1) {
    product<NP, true>(PX, PY, f, store);
  } else {
    product<NP, false>(PX, PY, f, store);
  }
  __syncwarp();
  if (mode == 2) {
    double2 kc[NP * NP / 32];
#pragma unroll
    for (int o = 0; o < NP * NP / 32; ++o) kc[o] = anti<NP>(PZ, f, o);
    __syncwarp();
#pragma unroll
    for (int o = 0; o < NP * NP / 32; ++o) PZ[f.own(o)] = kc[o];
    __syncwarp();
  }
  for (int e = lane; e < NP * NP; e += 32) {
    const int r = e / NP, c = e % NP;
    if (r < n && c < n) Z[r * n + c] = PZ[slot<NP>(r, c)];
  }
}

template <int NP>
int launch_sweep(const SweepParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(df_magnus_sweep_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  df_magnus_sweep_kernel<NP><<<(p.nb + p.mb - 1) / p.mb, 32 * p.mb, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NP>
int active_blocks(int mb, size_t smem) {
  if (cudaFuncSetAttribute(df_magnus_sweep_kernel<NP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess) {
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, df_magnus_sweep_kernel<NP>, 32 * mb,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

template <int NP>
int launch_product(const double2* X, const double2* Y, double2* Z, int n, int mode,
                   cudaStream_t stream) {
  const size_t smem = 3 * sizeof(double2) * NP * NP;
  cudaError_t err = cudaFuncSetAttribute(df_product_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  df_product_kernel<NP><<<1, 32, smem, stream>>>(X, Y, Z, n, mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes of one block of mb members (the wrapper's
// launch_shape reckons the same).
size_t df_magnus_sweep_smem_bytes(int n, int k, int nn, int herm, int mb) {
  (void)herm;
  return sizeof(double2) * member_slots(n, k, nn) * (size_t)mb;
}

// Blocks of mb members that one SM holds (the CUDA occupancy calculator); 0 on error.
int df_magnus_sweep_active_blocks(int n, int k, int nn, int herm, int mb) {
  const size_t smem = df_magnus_sweep_smem_bytes(n, k, nn, herm, mb);
  switch (padded(n)) {
    case 8: return active_blocks<8>(mb, smem);
    case 16: return active_blocks<16>(mb, smem);
    case 24: return active_blocks<24>(mb, smem);
    case 32: return active_blocks<32>(mb, smem);
    default: return 0;
  }
}

// Fill opsp (k + 1, np, np) and tab (rotated or (cos, sin), see above) once
// per call, on `stream`. Returns the CUDA error code of the launch.
int df_magnus_sweep_tables(const void* stat, const void* ops, const double* omega,
                           const double* taus, void* opsp, void* tab, int n, int k, int T, int nn,
                           int rotated, void* stream) {
  if (n < 1 || n > kMaxN || k < 0 || T < 1 || (nn != 2 && nn != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  TableParams p{(const double2*)stat, (const double2*)ops, omega, taus, (double2*)opsp,
                (double2*)tab, n, k, T, nn, padded(n), rotated ? 1 : 0};
  const long want = ((long)T * nn * padded(n) * padded(n) + 255) / 256;
  const int blocks = (int)(want < 1056 ? want : 1056);
  df_tables_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch ceil(nb / mb) blocks of mb warps (one member each) on `stream` over
// the lanes [b0, b0 + nb) of rows of length ldb. Returns the CUDA error code
// of the launch (0 = cudaSuccess); faults during the run surface at the next
// synchronization.
int df_magnus_sweep_launch(const void* opsp, const void* tab, const double* sc,
                           const double* coef, const int* slots, const void* y0, void* out,
                           void* evals, int n, int k, int T, int nn, int order, int herm,
                           int rotated, int mb, int b0, int nb, int ldb, void* stream) {
  if (n < 1 || n > kMaxN || k < 0 || T < 1 || (nn != 2 && nn != 3) || order < 1 || mb < 1 ||
      mb > kMaxMembers || b0 < 0 || nb < 1 || b0 + nb > ldb) {
    return (int)cudaErrorInvalidValue;
  }
  SweepParams p{(const double2*)opsp, (const double2*)tab, sc, coef, slots, (const double2*)y0,
                (double2*)out, (double2*)evals, n, k, T, nn, order, herm ? 1 : 0,
                rotated ? 1 : 0, mb, b0, nb, ldb};
  const size_t smem = df_magnus_sweep_smem_bytes(n, k, nn, herm, mb);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (padded(n)) {
    case 8: return launch_sweep<8>(p, smem, s);
    case 16: return launch_sweep<16>(p, smem, s);
    case 24: return launch_sweep<24>(p, smem, s);
    default: return launch_sweep<32>(p, smem, s);
  }
}

// Z = X Y, X Y - Y X or C - C^H (mode 0, 1, 2) of (n, n) complex128 matrices
// by the sweep's DMMA product, one warp (the card tests' check of the layout).
int df_magnus_sweep_product(const void* X, const void* Y, void* Z, int n, int mode,
                            void* stream) {
  if (n < 1 || n > kMaxN || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const double2 *x = (const double2*)X, *y = (const double2*)Y;
  double2* z = (double2*)Z;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (padded(n)) {
    case 8: return launch_product<8>(x, y, z, n, mode, s);
    case 16: return launch_product<16>(x, y, z, n, mode, s);
    case 24: return launch_product<24>(x, y, z, n, mode, s);
    default: return launch_product<32>(x, y, z, n, mode, s);
  }
}

const char* df_magnus_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
