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
// Mapping. A member's rows go to a group of GL lanes inside one warp (GL the
// power of two >= n, at least 4: two members per warp at n = 16, eight at
// n = 4); lane i of the group owns row i. The state dimension is padded to NC
// columns (n rounded up to a multiple of 4). Padded rows and columns hold
// zeros, so they add nothing; lanes past NC only join the warp's barriers.
// Every exchange inside a step (the generators' rows, P's transpose, the
// Horner vector) goes through the member's slice of shared memory behind a
// __syncwarp, or, for the Horner vector up to n = 8, by shuffles: the step
// loop holds no block barrier. A block is 1-8 warps, as many as the wrapper's
// wave count finds best; its only barrier follows the operator tables' load.
// (A member per thread at n = 4 was measured slower than 4-lane groups.)
//
// Register-blocked products. A lane keeps the row it forms in registers: its
// row of P = c2 G_2 G_1 (and then of M) in the matrix modes, its rows of G_1
// and G_2 in matvec mode. The other operand, a row of G_1 (or G_2) or the
// Horner vector, is read from shared memory as 16-byte loads at one address
// for every lane of the group: about half a shared load per complex
// multiply-add. The generators are built from the operator tables (shared
// memory, a row per lane, padded so that a quarter-warp's 16-byte loads hit
// distinct banks), with the step's first coefficients in registers.
//
// Frame phases formed once per call. The wrapper forms the float32 table of
// cos/sin(fmod(omega tau, 2 pi)) from float64 tau and omega for every step and
// Gauss point, laid out (T, 2, NC/2, n, 4) so that the rows of a column pair
// are contiguous: one 16-byte load per lane, two cache lines per warp at
// n = 16. The kernel reads it through the read-only cache; no FP64 and no
// transcendental remains in the step loop. Up to n = 8, where a step is a
// short latency chain, the next step's phases and coefficients load while
// this one runs.
//
// Arithmetic. Multiply-adds are fused (the library is built with the
// default -fmad=true), P is accumulated from c2 G_2 (and -c2 G_1 for the
// second product of "matrix") and the Horner sums run in two interleaved
// partial sums: the kernel agrees with the plain version to float32
// roundoff, not bit for bit.
//
// What bounds it on this card. Per member and step, "matrix_herm" at n = 16,
// k = 2, order 8 does ~59k float32 operations (one n^3 complex matmul, eight
// n^2 mat-vecs, the generator builds): it is bound by operations, and the
// products keep the FP32 pipes and shared memory about equally busy (a
// 16-byte broadcast load per 8 multiply-adds, plus the builds' own-row
// loads). Up to n = 8 too few members are in flight to fill the SMs (10,240
// members at n = 4 are ~10 warps per SM): a step is a latency chain there.
// The n^3 product on the tensor cores is the next step.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 32;  // the state dimension cap (the router sends larger n elsewhere)
constexpr int kMaxWarps = 8;
#ifdef B2_PROFILE
// thread 0's cycles by part of the step (a build for the timing script only):
// coefficients, generators, products and M, Horner, the rest; kept in
// registers and added to g_profile once, at the end
__device__ long long g_profile[5];
#define B2_MARK(part)                 \
  do {                                \
    const long long now = clock64();  \
    prof[part] += now - t_mark;       \
    t_mark = now;                     \
  } while (0)
#else
#define B2_MARK(part) \
  do {                \
  } while (0)
#endif

enum Mode { kMatrix = 0, kMatrixHerm = 1, kMatvec = 2 };

struct Params {
  const float* statr;  // (n, n)
  const float* stati;
  const float* opsr;  // (k, n, n)
  const float* opsi;
  const float* phases;  // (T, 2, NC/2, n, 4): cos, sin of two columns at each Gauss point
  const float* coef;    // (T, 2, k, B)
  const int* slots;     // (T,) trajectory slot per step (-1: not kept), or null
  const float* y0r;     // (n, B)
  const float* y0i;
  float* outr;  // (n, B)
  float* outi;
  float* evalr;  // (n_eval, n, B), or null
  float* evali;
  int n, k, T, B, order, mode;
  float c1, c2;  // (f32)(dt / 2), (f32)(p2 dt^2)
};

__host__ __device__ constexpr int columns(int n) { return n <= 4 ? 4 : (n + 3) / 4 * 4; }
__host__ __device__ constexpr int group_lanes(int nc) {
  return nc <= 4 ? 4 : nc <= 8 ? 8 : nc <= 16 ? 16 : 32;
}
// Row stride (floats) of an interleaved complex [row][col] table or slice:
// 8 consecutive rows' 16-byte loads at one column land on distinct banks.
__host__ __device__ constexpr int row_stride(int nc) { return nc == 4 ? 8 : 2 * nc + 4; }

// Floats of one member's slice: two NC x NC planes (G_1 / P, G_2) and two
// Horner vectors (matrix modes), or v, u1, u2 (matvec); padded to 4 (mod 32)
// so that the groups of one warp read their broadcast rows from distinct banks.
__host__ __device__ inline int member_floats(int nc, bool matvec) {
  const int base = matvec ? 6 * nc : 2 * nc * row_stride(nc) + 4 * nc;
  return base + ((4 - base) % 32 + 32) % 32;
}

__host__ __device__ inline size_t smem_floats(int nc, int k, bool matvec, int warps) {
  const size_t tab = (size_t)(k + 1) * nc * row_stride(nc);
  return tab + (size_t)warps * (32 / group_lanes(nc)) * member_floats(nc, matvec);
}

// acc += x * b, complex
__device__ __forceinline__ void cmac(float& accr, float& acci, float xr, float xi, float br,
                                     float bi) {
  accr = fmaf(xr, br, accr);
  accr = fmaf(-xi, bi, accr);
  acci = fmaf(xr, bi, acci);
  acci = fmaf(xi, br, acci);
}

// The frame rotation of two complex entries: (a_r c - a_i s, a_r s + a_i c).
__device__ __forceinline__ float4 rotate(float4 a, float4 p) {
  return make_float4(a.x * p.x - a.y * p.y, a.x * p.y + a.y * p.x, a.z * p.z - a.w * p.w,
                     a.z * p.w + a.w * p.z);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 fma4(float w, float4 o, float4 a) {
  return make_float4(fmaf(w, o.x, a.x), fmaf(w, o.y, a.y), fmaf(w, o.z, a.z), fmaf(w, o.w, a.w));
}

constexpr int kCoefRegs = 4;  // coefficients per Gauss point held in registers

// 1/j in float32, correctly rounded (as the plain version's), for the Horner
// terms j <= 16; past that __frcp_rn
__constant__ float kInv[17] = {0.0f,        1.0f,        1.0f / 2,  1.0f / 3,  1.0f / 4,
                               1.0f / 5,    1.0f / 6,    1.0f / 7,  1.0f / 8,  1.0f / 9,
                               1.0f / 10,   1.0f / 11,   1.0f / 12, 1.0f / 13, 1.0f / 14,
                               1.0f / 15,   1.0f / 16};
__device__ __forceinline__ float inverse(int j) {
  return j <= 16 ? kInv[j] : __frcp_rn((float)j);
}

// Generator entries (c, c + 1) of one row at both Gauss points:
// P_g o (S + sum_j w_{g,j} O_j) from the row's tables at trow (O_j's at
// + (j + 1) * tsz), the first kCoefRegs weights from registers, the rest at
// cf[(g * k + j) * cstride].
__device__ __forceinline__ void build_pair(const float* trow, int tsz, int c, int k,
                                           const float (&w)[2][kCoefRegs], const float* cf,
                                           size_t cstride, float4 p1, float4 p2, float4& e1,
                                           float4& e2) {
  const float4 s4 = lds4(trow + 2 * c);
  float4 a1 = s4, a2 = s4;
#pragma unroll
  for (int j = 0; j < kCoefRegs; ++j) {
    if (j < k) {
      const float4 o = lds4(trow + (j + 1) * tsz + 2 * c);
      a1 = fma4(w[0][j], o, a1);
      a2 = fma4(w[1][j], o, a2);
    }
  }
  for (int j = kCoefRegs; j < k; ++j) {
    const float4 o = lds4(trow + (j + 1) * tsz + 2 * c);
    a1 = fma4(cf[j * cstride], o, a1);
    a2 = fma4(cf[(k + j) * cstride], o, a2);
  }
  e1 = rotate(a1, p1);
  e2 = rotate(a2, p2);
}

template <int NC, bool MATVEC>
__device__ __forceinline__ void sweep(const Params& p) {
  constexpr int GL = group_lanes(NC), MPW = 32 / GL, RS = row_stride(NC);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n, k = p.k, B = p.B;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane / GL, i = lane % GL;
  const bool active = i < NC;      // lanes past the padded rows store nothing
  const int row = min(i, NC - 1);  // ... and read row NC - 1's data
  const int member0 = (blockIdx.x * warps + warp) * MPW;
  const int member = member0 + q;
  const bool valid = member < B && i < n;  // ragged last warp: compute on a copy, store nothing
  const int mem_ld = min(member, B - 1);

  // operator tables, zero-padded to NC x NC: S, then O_0 .. O_{k-1}
  float* tab = smem;
  const int tsz = NC * RS;
  for (int idx = threadIdx.x; idx < (k + 1) * NC * NC; idx += blockDim.x) {
    const int t = idx / (NC * NC), r = idx / NC % NC, c = idx % NC;
    float re = 0.0f, im = 0.0f;
    if (r < n && c < n) {
      const size_t src = ((size_t)(t - 1) * n + r) * n + c;
      re = t == 0 ? p.statr[r * n + c] : p.opsr[src];
      im = t == 0 ? p.stati[r * n + c] : p.opsi[src];
    }
    tab[t * tsz + r * RS + 2 * c] = re;
    tab[t * tsz + r * RS + 2 * c + 1] = im;
  }
  float* mine = tab + (size_t)(k + 1) * tsz + (size_t)(warp * MPW + q) * member_floats(NC, MATVEC);
  float yr = 0.0f, yi = 0.0f;
  if (i < n) {
    yr = p.y0r[(size_t)i * B + mem_ld];
    yi = p.y0i[(size_t)i * B + mem_ld];
  }
  // Up to n = 8 a step is a short serial chain, not a race for issue slots:
  // the next step's coefficients and phase row load while this one runs.
  // Above, other warps hide the loads and the registers are worth more.
  constexpr bool kPrefetch = NC <= 8;
  auto load_coef = [&](int s, float (&dst)[2][kCoefRegs]) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int j = 0; j < kCoefRegs; ++j) {
        dst[g][j] = j < k ? __ldg(p.coef + ((size_t)(s * 2 + g) * k + j) * B + mem_ld) : 0.0f;
      }
    }
  };
  float nxt[2][kPrefetch ? kCoefRegs : 1];
  if constexpr (kPrefetch) load_coef(0, nxt);
  __syncthreads();  // the tables are loaded (the only block barrier)

  const float* trow = tab + row * RS;  // this lane's row of S; O_j's at + (j + 1) * tsz
  const int prow = min(row, n - 1);   // this lane's row of the phase table
  const size_t gstride = (size_t)(NC / 2) * n * 4;  // floats per Gauss point of the table
  const float* ph0 = p.phases + (size_t)prow * 4;
  constexpr int kPre = kPrefetch ? NC / 2 : 1;
  float4 nx1[kPre], nx2[kPre];
  if constexpr (kPrefetch) {
#pragma unroll
    for (int cp = 0; cp < kPre; ++cp) {
      nx1[cp] = __ldg(reinterpret_cast<const float4*>(ph0 + (size_t)cp * n * 4));
      nx2[cp] = __ldg(reinterpret_cast<const float4*>(ph0 + gstride + (size_t)cp * n * 4));
    }
  }
#ifdef B2_PROFILE
  long long prof[5] = {0, 0, 0, 0, 0};
  long long t_mark = clock64();
#endif

  for (int s = 0; s < p.T; ++s) {
    float w[2][kCoefRegs];  // this step's first kCoefRegs coefficients per Gauss point
    if constexpr (kPrefetch) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int j = 0; j < kCoefRegs; ++j) w[g][j] = nxt[g][j];
      }
      if (s + 1 < p.T) load_coef(s + 1, nxt);
    } else {
      load_coef(s, w);
    }
    const float* cf = p.coef + (size_t)s * 2 * k * B + mem_ld;  // the weights past kCoefRegs
    __syncwarp();  // the last step's reads of the member's slice are done
    B2_MARK(0);
    const float* ph = ph0 + (size_t)s * 2 * gstride;
    float4 cur1[kPre], cur2[kPre];
    if constexpr (kPrefetch) {
#pragma unroll
      for (int cp = 0; cp < kPre; ++cp) {
        cur1[cp] = nx1[cp];
        cur2[cp] = nx2[cp];
        if (s + 1 < p.T) {
          nx1[cp] = __ldg(reinterpret_cast<const float4*>(ph + 2 * gstride + (size_t)cp * n * 4));
          nx2[cp] = __ldg(reinterpret_cast<const float4*>(ph + 3 * gstride + (size_t)cp * n * 4));
        }
      }
    }
    // the phases of columns (c, c + 1) at both Gauss points
    auto phases = [&](int c, float4& p1, float4& p2) {
      if constexpr (kPrefetch) {
        p1 = cur1[c / 2];
        p2 = cur2[c / 2];
      } else {
        p1 = __ldg(reinterpret_cast<const float4*>(ph + (size_t)(c / 2) * n * 4));
        p2 = __ldg(reinterpret_cast<const float4*>(ph + gstride + (size_t)(c / 2) * n * 4));
      }
    };

    if constexpr (MATVEC) {
      // G_1 and G_2 rows in registers; M never formed
      float g1r[NC], g1i[NC], g2r[NC], g2i[NC];
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        float4 p1, p2, e1, e2;
        phases(c, p1, p2);
        build_pair(trow, tsz, c, k, w, cf, B, p1, p2, e1, e2);
        g1r[c] = e1.x; g1i[c] = e1.y; g1r[c + 1] = e1.z; g1i[c + 1] = e1.w;
        g2r[c] = e2.x; g2i[c] = e2.y; g2r[c + 1] = e2.z; g2i[c + 1] = e2.w;
      }
      B2_MARK(1);
      B2_MARK(2);
      float* v = mine;
      float* u1 = mine + 2 * NC;
      float* u2 = mine + 4 * NC;
      if (active) *reinterpret_cast<float2*>(v + 2 * row) = make_float2(yr, yi);
      float vr = yr, vi = yi;
      for (int kk = p.order; kk >= 1; --kk) {
        const float inv = inverse(kk);
        __syncwarp();  // v is complete
        float a1r = 0.0f, a1i = 0.0f, a2r = 0.0f, a2i = 0.0f;
        float b1r = 0.0f, b1i = 0.0f, b2r = 0.0f, b2i = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float4 x = lds4(v + 2 * c);
          cmac(a1r, a1i, g1r[c], g1i[c], x.x, x.y);
          cmac(b1r, b1i, g1r[c + 1], g1i[c + 1], x.z, x.w);
          cmac(a2r, a2i, g2r[c], g2i[c], x.x, x.y);
          cmac(b2r, b2i, g2r[c + 1], g2i[c + 1], x.z, x.w);
        }
        const float u1r = a1r + b1r, u1i = a1i + b1i, u2r = a2r + b2r, u2i = a2i + b2i;
        if (active) {
          *reinterpret_cast<float2*>(u1 + 2 * row) = make_float2(u1r, u1i);
          *reinterpret_cast<float2*>(u2 + 2 * row) = make_float2(u2r, u2i);
        }
        __syncwarp();  // u1, u2 are complete; nobody reads v any more
        float t1r = 0.0f, t1i = 0.0f, t2r = 0.0f, t2i = 0.0f;  // G_2 u1
        float s1r = 0.0f, s1i = 0.0f, s2r = 0.0f, s2i = 0.0f;  // G_1 u2
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float4 x = lds4(u1 + 2 * c);
          const float4 z = lds4(u2 + 2 * c);
          cmac(t1r, t1i, g2r[c], g2i[c], x.x, x.y);
          cmac(t2r, t2i, g2r[c + 1], g2i[c + 1], x.z, x.w);
          cmac(s1r, s1i, g1r[c], g1i[c], z.x, z.y);
          cmac(s2r, s2i, g1r[c + 1], g1i[c + 1], z.z, z.w);
        }
        const float tr = t1r + t2r, ti = t1i + t2i, ar = s1r + s2r, ai = s1i + s2i;
        vr = yr + inv * (p.c1 * (u1r + u2r) + p.c2 * (tr - ar));
        vi = yi + inv * (p.c1 * (u1i + u2i) + p.c2 * (ti - ai));
        if (active) *reinterpret_cast<float2*>(v + 2 * row) = make_float2(vr, vi);
      }
      yr = vr;
      yi = vi;
    } else {
      float* A = mine;             // G_1, then c2 P (matrix_herm)
      float* Bp = mine + NC * RS;  // G_2
      float* vec = Bp + NC * RS;   // two Horner vectors
      // generators: this lane's rows of G_1 and G_2 into the member's planes
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        float4 p1, p2, e1, e2;
        phases(c, p1, p2);
        build_pair(trow, tsz, c, k, w, cf, B, p1, p2, e1, e2);
        if (active) {
          sts4(A + row * RS + 2 * c, e1);
          sts4(Bp + row * RS + 2 * c, e2);
        }
      }
      __syncwarp();  // both generators are complete
      B2_MARK(1);

      float mr[NC], mi[NC];  // this lane's row of c2 P, then of M
#pragma unroll
      for (int c = 0; c < NC; ++c) mr[c] = mi[c] = 0.0f;
      // (c2 G_2) G_1; "matrix" then adds (-c2 G_1) G_2
      for (int pass = 0; pass < (p.mode == kMatrixHerm ? 1 : 2); ++pass) {
        const float* arow = (pass == 0 ? Bp : A) + row * RS;
        const float* brows = pass == 0 ? A : Bp;
        const float sc = pass == 0 ? p.c2 : -p.c2;
        auto rows = [&](int m) {  // rows m and m + 1 of the product's sum
          const float4 a4 = lds4(arow + 2 * m);
          const float x0r = sc * a4.x, x0i = sc * a4.y, x1r = sc * a4.z, x1i = sc * a4.w;
          const float* b0 = brows + m * RS;
#pragma unroll
          for (int c = 0; c < NC; c += 2) {
            const float4 b = lds4(b0 + 2 * c);
            const float4 d = lds4(b0 + RS + 2 * c);
            cmac(mr[c], mi[c], x0r, x0i, b.x, b.y);
            cmac(mr[c + 1], mi[c + 1], x0r, x0i, b.z, b.w);
            cmac(mr[c], mi[c], x1r, x1i, d.x, d.y);
            cmac(mr[c + 1], mi[c + 1], x1r, x1i, d.z, d.w);
          }
        };
        if constexpr (NC <= 8) {  // short: unrolled, its loads issued together
#pragma unroll
          for (int m = 0; m < NC; m += 2) rows(m);
        } else {
          for (int m = 0; m < ((n + 1) & ~1); m += 2) rows(m);  // rows past n are zero
        }
      }
      if (p.mode == kMatrixHerm) {
        __syncwarp();  // every lane is done reading G_1's rows
        // c2 P over G_1's own row; M = dt/2 (G_1 + G_2) + c2 P ...
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float4 g1 = lds4(A + row * RS + 2 * c);
          const float4 g2 = lds4(Bp + row * RS + 2 * c);
          if (active) sts4(A + row * RS + 2 * c, make_float4(mr[c], mi[c], mr[c + 1], mi[c + 1]));
          mr[c] += p.c1 * (g1.x + g2.x);
          mi[c] += p.c1 * (g1.y + g2.y);
          mr[c + 1] += p.c1 * (g1.z + g2.z);
          mi[c + 1] += p.c1 * (g1.w + g2.w);
        }
        __syncwarp();  // c2 P is complete
#pragma unroll
        for (int c = 0; c < NC; ++c) {  // ... - c2 P^H
          const float2 t = *reinterpret_cast<const float2*>(A + c * RS + 2 * row);
          mr[c] -= t.x;
          mi[c] += t.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float4 g1 = lds4(A + row * RS + 2 * c);
          const float4 g2 = lds4(Bp + row * RS + 2 * c);
          mr[c] += p.c1 * (g1.x + g2.x);
          mi[c] += p.c1 * (g1.y + g2.y);
          mr[c + 1] += p.c1 * (g1.z + g2.z);
          mi[c + 1] += p.c1 * (g1.w + g2.w);
        }
      }
      B2_MARK(2);

      // Horner action with M's row in registers, the vector broadcast
      float vr = yr, vi = yi;
      if constexpr (NC <= 8) {
        // the vector from the group's lanes by shuffles: no shared round trip
        const int base = q * GL;
        for (int kk = p.order; kk >= 1; --kk) {
          const float inv = inverse(kk);
          float w0r = 0.0f, w0i = 0.0f, w1r = 0.0f, w1i = 0.0f;
#pragma unroll
          for (int c = 0; c < NC; c += 2) {
            const float x0r = __shfl_sync(0xffffffffu, vr, base + c);
            const float x0i = __shfl_sync(0xffffffffu, vi, base + c);
            const float x1r = __shfl_sync(0xffffffffu, vr, base + c + 1);
            const float x1i = __shfl_sync(0xffffffffu, vi, base + c + 1);
            cmac(w0r, w0i, mr[c], mi[c], x0r, x0i);
            cmac(w1r, w1i, mr[c + 1], mi[c + 1], x1r, x1i);
          }
          vr = yr + inv * (w0r + w1r);
          vi = yi + inv * (w0i + w1i);
        }
      } else {
        if (active) *reinterpret_cast<float2*>(vec + 2 * row) = make_float2(yr, yi);
        int buf = 0;
        for (int kk = p.order; kk >= 1; --kk) {
          const float inv = inverse(kk);
          __syncwarp();  // the current vector is complete
          const float* cur = vec + buf * 2 * NC;
          float w0r = 0.0f, w0i = 0.0f, w1r = 0.0f, w1i = 0.0f;
#pragma unroll
          for (int c = 0; c < NC; c += 2) {
            const float4 x = lds4(cur + 2 * c);
            cmac(w0r, w0i, mr[c], mi[c], x.x, x.y);
            cmac(w1r, w1i, mr[c + 1], mi[c + 1], x.z, x.w);
          }
          vr = yr + inv * (w0r + w1r);
          vi = yi + inv * (w0i + w1i);
          buf ^= 1;
          if (active) {
            *reinterpret_cast<float2*>(vec + buf * 2 * NC + 2 * row) = make_float2(vr, vi);
          }
        }
      }
      yr = vr;
      yi = vi;
    }
    B2_MARK(3);

    if (p.slots != nullptr) {
      const int slot = __ldg(p.slots + s);
      if (slot >= 0 && valid) {
        const size_t g = ((size_t)slot * n + i) * B + member;
        p.evalr[g] = yr;
        p.evali[g] = yi;
      }
    }
    B2_MARK(4);
  }
  if (valid) {
    p.outr[(size_t)i * B + member] = yr;
    p.outi[(size_t)i * B + member] = yi;
  }
#ifdef B2_PROFILE
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    for (int part = 0; part < 5; ++part) g_profile[part] += prof[part];
  }
#endif
}

template <int NC, bool MATVEC>
__global__ void __launch_bounds__(kMaxWarps * 32) sweep_magnus2_kernel(Params p) {
  sweep<NC, MATVEC>(p);
}

// Past n = 16 a matvec lane holds two rows of 2 NC floats: its registers are
// capped at 168 (blocks of at most 3 warps, 4 resident), where an SM partition
// still keeps 3 warps; at 170 or more it keeps 2.
template <int NC>
__global__ void __launch_bounds__(3 * 32, 4) sweep_magnus2_wide_matvec(Params p) {
  sweep<NC, true>(p);
}

using KernelFn = void (*)(Params);

KernelFn kernel_for(int nc, bool matvec) {
  switch (nc) {
#define B2_CASE(NC) \
  case NC:          \
    return matvec ? sweep_magnus2_kernel<NC, true> : sweep_magnus2_kernel<NC, false>;
#define B2_WIDE(NC) \
  case NC:          \
    return matvec ? sweep_magnus2_wide_matvec<NC> : sweep_magnus2_kernel<NC, false>;
    B2_CASE(4)
    B2_CASE(8)
    B2_CASE(12)
    B2_CASE(16)
    B2_WIDE(20)
    B2_WIDE(24)
    B2_WIDE(28)
    B2_WIDE(32)
#undef B2_CASE
#undef B2_WIDE
  }
  return nullptr;
}

int check_args(int n, int k, int mode, int warps) {
  if (n < 1 || n > kMaxN || k < 0 || mode < kMatrix || mode > kMatvec || warps < 1 ||
      warps > kMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block of `warps` warps.
size_t sweep_magnus2_smem_bytes(int n, int k, int mode, int warps) {
  return sizeof(float) * smem_floats(columns(n), k, mode == kMatvec, warps);
}

// The launch of B members in blocks of `warps` warps, into out[0..9]: columns
// NC, lanes per member, members per warp, warps per block, blocks, shared
// bytes per block, blocks resident per SM, registers per thread, local
// (spilled) bytes per thread. Returns a CUDA error code (0 = cudaSuccess).
int sweep_magnus2_shape(int n, int k, int mode, int B, int warps, long long* out) {
  int err = check_args(n, k, mode, warps);
  if (err != 0 || B < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  const int nc = columns(n), gl = group_lanes(nc), mpw = 32 / gl;
  const KernelFn fn = kernel_for(nc, mode == kMatvec);
  const size_t smem = sweep_magnus2_smem_bytes(n, k, mode, warps);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;  // none past the instantiation's bound on threads per block
  if (warps * 32 <= attr.maxThreadsPerBlock) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, warps * 32, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long per_block = (long long)warps * mpw;
  out[0] = nc;
  out[1] = gl;
  out[2] = mpw;
  out[3] = warps;
  out[4] = (B + per_block - 1) / per_block;
  out[5] = (long long)smem;
  out[6] = per_sm;
  out[7] = attr.numRegs;
  out[8] = (long long)attr.localSizeBytes;
  return 0;
}

// Launch the sweep over B members in blocks of `warps` warps on `stream`.
// Returns the CUDA error code of the launch (0 = cudaSuccess); faults during
// the run surface at the next synchronization.
int sweep_magnus2_launch(const float* statr, const float* stati, const float* opsr,
                         const float* opsi, const float* phases, const float* coef,
                         const int* slots, const float* y0r, const float* y0i, float* outr,
                         float* outi, float* evalr, float* evali, int n, int k, int T, int B,
                         int order, int mode, int warps, float c1, float c2, void* stream) {
  int err = check_args(n, k, mode, warps);
  if (err != 0 || T < 1 || B < 1 || order < 1) return err != 0 ? err : (int)cudaErrorInvalidValue;
  Params p{statr, stati, opsr, opsi, phases, coef, slots, y0r, y0i, outr, outi, evalr, evali,
           n, k, T, B, order, mode, c1, c2};
  const int nc = columns(n), mpw = 32 / group_lanes(nc);
  const KernelFn fn = kernel_for(nc, mode == kMatvec);
  const size_t smem = sweep_magnus2_smem_bytes(n, k, mode, warps);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)warps * mpw;
  const unsigned blocks = (unsigned)((B + per_block - 1) / per_block);
  fn<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

#ifdef B2_PROFILE
// Thread 0's cycles by part, summed over the launches since the last reset,
// into out[0..4]; reset != 0 zeroes them instead.
int sweep_magnus2_profile(long long* out, int reset) {
  if (reset) {
    const long long zero[5] = {0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(g_profile, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_profile, 5 * sizeof(long long));
}
#endif

const char* sweep_magnus2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
