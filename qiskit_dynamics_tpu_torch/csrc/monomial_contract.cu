// The perturbative step's monomials and their contraction (kernel B11), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates the Dysolve expansion at
// every step as its monomial table and one matrix product under XLA
// (qiskit_dynamics_tpu/perturbation/array_polynomial.py::compute_monomials and
// the product in the perturbative solve_sweep). Here that table and product
// were ~15.5 ms of device time a Dyson call (the gathers and multiplies that
// build a 1.7 GB float32 table, a cuBLAS SGEMM that reads it back, and the
// copy of its real lanes into complex64). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/monomial_contract.py.
//
// What it computes. A lane l is one step of one sweep member, with the
// variables c[v, l] (the step's Chebyshev coefficients; float32, (n_vars, L)
// row-major). Term k of the expansion has the label v_0 <= v_1 <= ... <= v_d
// and the monomial
//   m[k, l] = ((c[v_0, l] * c[v_1, l]) * c[v_2, l]) ... * c[v_d, l],
// multiplied left to right: the rounded products that
// ArrayPolynomial.compute_monomials forms degree by degree as "parent times
// variable", so the monomials equal the plain version's bit for bit. Then for
// the planes p (real, imaginary) and the matrix entries e < E = n^2
//   out[p, e, l] = sum_k A[p, e, k] m[k, l]   (+ start[p, e])
// in FP32 fused multiply-adds, k in order, the constant term added last as
// addmm adds it. The output is complex64 (E, L) (interleaved, what the chain
// kernel B5 reads: the Dyson step propagators) or float32 planes (2, E, L)
// (what the Taylor expm B6 reads: the Magnus exponents).
//
// What bounds it on this card. Operations: 2 M E multiply-adds a lane (Dyson
// 6 at n = 10: 209 terms, 83,600 flops) against 8 E bytes written and
// 4 n_vars read (816); the FP32 pipes, not the 3.35 TB/s of HBM. At the
// Magnus-3 shape (34 terms) the 1.64 GB written is the larger bound.
//
// Design. Nothing of the table reaches device memory. One persistent block
// per SM walks lane tiles of 128 lanes (4 consecutive lanes a thread, 32
// threads a warp); warp w holds TE entries of both planes for its 4 lanes in
// 8 TE registers. The entries of a block are all n^2 where they fit (n <= 10
// at TE = 10), so every monomial is formed once a lane; above, tiles of
// entries are the grid's second axis. A lane tile's variables are copied
// into shared memory (cp.async, one tile ahead), then every node of the
// product table is formed degree by degree as parent times variable, one
// barrier a degree, into a shared table of the tile's monomials (table mode).
// Where the table does not fit, each chunk's monomials are folded from their
// variables instead (fold mode). The coefficients, packed on the host as
// [tile][term][entry][plane], stream from L2 in chunks of up to 64 terms
// (cp.async, double buffered, one barrier a chunk; where one chunk holds
// every term it is loaded once per block). In the contraction a thread reads
// its 4 monomials as one 16-byte shared load and its 2 TE coefficients as
// warp-wide broadcasts, and issues 8 TE multiply-adds for each term. TE (2,
// 4, 8 or 10) and the warps follow n (ops/monomial_contract.py::launch_shape), the
// mode and the chunk follow the shared memory the table needs (plan), so
// every n, M, n_vars and L runs; the last tile masks its ragged lanes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kLanes = 128;  // lanes of a lane tile: 32 threads x 4
constexpr int kUnroll = 4;  // terms a step of the contraction loop
constexpr size_t kSharedLimit = 232448;  // dynamic shared memory a block may use

// the most warps of a block at TE entries a thread, so that the TE x 2 x 4
// accumulators and their operands stay in the registers of one block per SM
template <int TE> struct MaxWarps;
template <> struct MaxWarps<2> { static constexpr int value = 32; };
template <> struct MaxWarps<4> { static constexpr int value = 20; };
template <> struct MaxWarps<8> { static constexpr int value = 14; };
template <> struct MaxWarps<10> { static constexpr int value = 12; };

// cp.async of 16 (4) bytes, of which the first `bytes` are read and the rest zero
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// one term into the accumulators: a thread's 4 monomials (one 16-byte shared
// load) times its 2 TE coefficients (broadcast loads), 8 TE multiply-adds
template <int TE>
__device__ __forceinline__ void contract_term(float (&acc)[TE][2][4], const float* ms,
                                              const float* as) {
  const float4 m = *reinterpret_cast<const float4*>(ms);
  float a[2 * TE];
#pragma unroll
  for (int i = 0; i < TE / 2; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(as + 4 * i);
    a[4 * i] = v.x;
    a[4 * i + 1] = v.y;
    a[4 * i + 2] = v.z;
    a[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TE; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      acc[i][p][0] = fmaf(a[2 * i + p], m.x, acc[i][p][0]);
      acc[i][p][1] = fmaf(a[2 * i + p], m.y, acc[i][p][1]);
      acc[i][p][2] = fmaf(a[2 * i + p], m.z, acc[i][p][2]);
      acc[i][p][3] = fmaf(a[2 * i + p], m.w, acc[i][p][3]);
    }
}

struct Problem {
  const float* coeffs;  // (n_vars, L)
  const int4* nodes;    // table mode: (slot, parent slot or -1, variable, 0) by degree
  const int* levels;    // table mode: node offsets of the degrees, n_levels + 1
  const int* offsets;   // fold mode: term k's variables are vars[offsets[k] .. offsets[k + 1])
  const int* vars;
  const float* packed;  // (tiles, M, warps x TE, 2)
  const float* start;   // (2, E) or null
  float* out;
  long long L;
  int M, E, n_vars, n_nodes, n_levels, chunk, interleaved;  // chunk: the most terms a chunk
};

// shared memory, in floats: the monomials (table mode: every node of the lane
// tile; fold mode: one chunk), two chunks of coefficients and, in table mode,
// two lane tiles of variables and the nodes
__host__ __device__ inline size_t mono_floats(int n_nodes, int chunk) {
  return (size_t)(n_nodes > 0 ? n_nodes : chunk) * kLanes;
}
__host__ __device__ inline size_t coef_floats(int te, int warps, int chunk) {
  return (size_t)2 * warps * chunk * 2 * te;
}
__host__ __device__ inline size_t slab_floats(int n_nodes, int n_vars) {
  return n_nodes > 0 ? (size_t)2 * n_vars * kLanes : 0;
}
size_t smem_bytes(int te, int warps, int n_nodes, int n_vars, int chunk) {
  return (mono_floats(n_nodes, chunk) + coef_floats(te, warps, chunk) +
          slab_floats(n_nodes, n_vars)) * sizeof(float) + (size_t)n_nodes * sizeof(int4);
}

// variable v at lanes l .. l + 3, from device memory (zero past L)
__device__ __forceinline__ float4 variable4(const Problem& p, int v, long long l) {
  const float* row = p.coeffs + (long long)v * p.L;
  if (p.L % 4 == 0)
    return l < p.L ? __ldg(reinterpret_cast<const float4*>(row + l)) : make_float4(0, 0, 0, 0);
  float4 x;
  x.x = l < p.L ? __ldg(row + l) : 0.f;
  x.y = l + 1 < p.L ? __ldg(row + l + 1) : 0.f;
  x.z = l + 2 < p.L ? __ldg(row + l + 2) : 0.f;
  x.w = l + 3 < p.L ? __ldg(row + l + 3) : 0.f;
  return x;
}

// the variables of the lane tile at lane0 into slab (zero past L)
__device__ __forceinline__ void load_slab(const Problem& p, long long lane0, float* slab) {
  if (p.L % 4 == 0) {
    for (int i = threadIdx.x; i < p.n_vars * kLanes / 4; i += blockDim.x) {
      const int v = i / (kLanes / 4), j = 4 * (i % (kLanes / 4));
      const long long l = lane0 + j;
      const int bytes = l < p.L ? 16 : 0;
      cp_async16(slab + v * kLanes + j, p.coeffs + (bytes ? (long long)v * p.L + l : 0), bytes);
    }
  } else {
    for (int i = threadIdx.x; i < p.n_vars * kLanes; i += blockDim.x) {
      const int v = i / kLanes, j = i % kLanes;
      const long long l = lane0 + j;
      const int bytes = l < p.L ? 4 : 0;
      cp_async4(slab + i, p.coeffs + (bytes ? (long long)v * p.L + l : 0), bytes);
    }
  }
}

// A thread's share of a chunk's coefficients: the 16-byte piece `piece` of
// every `stride`-th term's row from term `first` on. A term's row holds
// warps x TE / 2 pieces and the block's 32 x warps threads cover `stride`
// rows at once (the rest copy nothing), so the share is fixed for the whole
// kernel.
struct CoefShare {
  int first, piece, stride, dst;  // dst: the piece's offset in its warp's rows
  template <int TE>
  __device__ static CoefShare make(int warps, int chunk) {
    const int pieces = warps * TE / 2, stride = 32 * warps / pieces;
    const int piece = threadIdx.x % pieces, first = threadIdx.x / pieces;
    return CoefShare{first < stride ? first : chunk, piece, stride,
                     (piece / (TE / 2)) * chunk * 2 * TE + (piece % (TE / 2)) * 4};
  }
};

// the coefficients of terms k0 .. k0 + kc - 1, each warp's TE entries in its own rows
template <int TE>
__device__ __forceinline__ void load_coef(const Problem& p, const CoefShare& share, int k0,
                                          int kc, int warps, float* dst) {
  const int row = 2 * warps * TE;
  const float* src = p.packed + ((size_t)blockIdx.y * p.M + k0) * row + 4 * share.piece;
  for (int k = share.first; k < kc; k += share.stride)
    cp_async16(dst + share.dst + k * 2 * TE, src + (size_t)k * row);
}

// warp w's TE entries at its 4 lanes l .. l + 3, plus the constant term, in
// the output's layout
template <int TE>
__device__ __forceinline__ void store(const Problem& p, const float (&acc)[TE][2][4], int e0,
                                      long long l) {
  if (l >= p.L) return;
  const bool full = p.L % 4 == 0;  // all four lanes live, 16-byte aligned
#pragma unroll
  for (int i = 0; i < TE; ++i) {
    const int e = e0 + i;
    if (e >= p.E) break;
    float re[4], im[4];
    const float s0 = p.start ? __ldg(p.start + e) : 0.f;
    const float s1 = p.start ? __ldg(p.start + p.E + e) : 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      re[t] = p.start ? acc[i][0][t] + s0 : acc[i][0][t];
      im[t] = p.start ? acc[i][1][t] + s1 : acc[i][1][t];
    }
    if (p.interleaved) {
      float* o = p.out + ((size_t)e * p.L + l) * 2;
      if (full) {
        __stcs(reinterpret_cast<float4*>(o), make_float4(re[0], im[0], re[1], im[1]));
        __stcs(reinterpret_cast<float4*>(o) + 1, make_float4(re[2], im[2], re[3], im[3]));
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (l + t < p.L) {
            o[2 * t] = re[t];
            o[2 * t + 1] = im[t];
          }
      }
    } else {
      float* o0 = p.out + (size_t)e * p.L + l;
      float* o1 = p.out + ((size_t)p.E + e) * p.L + l;
      if (full) {
        __stcs(reinterpret_cast<float4*>(o0), make_float4(re[0], re[1], re[2], re[3]));
        __stcs(reinterpret_cast<float4*>(o1), make_float4(im[0], im[1], im[2], im[3]));
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (l + t < p.L) {
            o0[t] = re[t];
            o1[t] = im[t];
          }
      }
    }
  }
}

template <int TE>
__global__ void __launch_bounds__(32 * MaxWarps<TE>::value)
monomial_contract_kernel(Problem p) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32, q = threadIdx.x % 32;
  const bool table = p.n_nodes > 0;
  float* mono = smem;
  float* coef = mono + mono_floats(p.n_nodes, p.chunk);
  float* slabs = coef + coef_floats(TE, warps, p.chunk);
  int4* node_s = reinterpret_cast<int4*>(slabs + slab_floats(p.n_nodes, p.n_vars));
  // chunks of `size` terms, the last one shorter
  const int chunks = (p.M + p.chunk - 1) / p.chunk, size = (p.M + chunks - 1) / chunks;
  const long long lane_tiles = (p.L + kLanes - 1) / kLanes;
  const long long tiles = (lane_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto lane0 = [&](long long t) { return (blockIdx.x + t * gridDim.x) * kLanes; };
  const CoefShare share = CoefShare::make<TE>(warps, p.chunk);
  const int coef_buf = warps * p.chunk * 2 * TE;  // floats of one chunk's coefficients

  float acc[TE][2][4];
#pragma unroll
  for (int i = 0; i < TE; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][c][t] = 0.f;
  const int e0 = (blockIdx.y * warps + w) * TE;

  if (table) {
    load_slab(p, lane0(0), slabs);
    for (int j = threadIdx.x; j < p.n_nodes; j += blockDim.x) cp_async16(node_s + j, p.nodes + j);
  }
  load_coef<TE>(p, share, 0, min(size, p.M), warps, coef);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  long long step = 0;  // chunks contracted so far: the coefficient buffer is step & 1
  for (long long t = 0; t < tiles; ++t) {
    const float* slab = slabs + (t & 1) * p.n_vars * kLanes + 4 * q;
    if (table) {
      // every node of the tile, degree by degree: parent times variable
      for (int d = 0; d < p.n_levels; ++d) {
        const int end = __ldg(p.levels + d + 1);
        for (int j = __ldg(p.levels + d) + w; j < end; j += warps) {
          const int4 node = node_s[j];
          float4 m = *reinterpret_cast<const float4*>(slab + node.z * kLanes);
          if (node.y >= 0) m = mul4(*reinterpret_cast<const float4*>(mono + node.y * kLanes + 4 * q), m);
          *reinterpret_cast<float4*>(mono + node.x * kLanes + 4 * q) = m;
        }
        __syncthreads();
      }
    }
    if (table && t + 1 < tiles) load_slab(p, lane0(t + 1), slabs + ((t + 1) & 1) * p.n_vars * kLanes);
    for (int c = 0; c < chunks; ++c, ++step) {
      const int ka = c * size, kc = min(size, p.M - ka);
      if (!table) {
        // the chunk's monomials, each term's variables multiplied left to right
        const long long l = lane0(t) + 4 * q;
        for (int kk = w; kk < kc; kk += warps) {
          const int first = __ldg(p.offsets + ka + kk), end = __ldg(p.offsets + ka + kk + 1);
          float4 m = variable4(p, __ldg(p.vars + first), l);
          for (int j = first + 1; j < end; ++j) m = mul4(m, variable4(p, __ldg(p.vars + j), l));
          *reinterpret_cast<float4*>(mono + kk * kLanes + 4 * q) = m;
        }
        __syncthreads();
      }
      // the next chunk's coefficients (the next tile's first) while this one is
      // contracted; one chunk holds every term's for the whole kernel
      if (chunks > 1 && (c + 1 < chunks || t + 1 < tiles)) {
        const int kn = c + 1 < chunks ? ka + size : 0;
        load_coef<TE>(p, share, kn, min(size, p.M - kn), warps, coef + ((step + 1) & 1) * coef_buf);
      }
      cp_async_commit();
      const float* ms = mono + (table ? ka : 0) * kLanes + 4 * q;
      const float* as = coef + (chunks > 1 ? step & 1 : 0) * coef_buf + w * p.chunk * 2 * TE;
#pragma unroll kUnroll
      for (int kk = 0; kk < kc; ++kk) contract_term<TE>(acc, ms + kk * kLanes, as + kk * 2 * TE);
      cp_async_wait_all();
      __syncthreads();
    }
    store<TE>(p, acc, e0, lane0(t) + 4 * q);
#pragma unroll
    for (int i = 0; i < TE; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][c][u] = 0.f;
  }
}

template <int TE>
cudaError_t launch(const Problem& p, int warps, int tiles, cudaStream_t stream) {
  if (warps < 1 || warps > MaxWarps<TE>::value || (long long)tiles * warps * TE < p.E)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(TE, warps, p.n_nodes, p.n_vars, p.chunk);
  if (smem > kSharedLimit) return cudaErrorInvalidValue;
  const int threads = 32 * warps;
  cudaError_t err = cudaFuncSetAttribute(monomial_contract_kernel<TE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent: as many blocks as the card keeps resident, each walking lane tiles
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, monomial_contract_kernel<TE>,
                                                           threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long lane_tiles = (p.L + kLanes - 1) / kLanes;
  const long long resident = std::max(1LL, (long long)sms * per_sm / tiles);
  const dim3 grid((unsigned)std::min(lane_tiles, resident), (unsigned)tiles);
  monomial_contract_kernel<TE><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// coeffs: float32 (n_vars, L) row-major. Table mode (n_nodes > 0): nodes,
// int32 (n_nodes, 4), each node (slot, parent slot or -1, variable, 0) sorted
// by degree, term k's monomial in slot k; levels, int32 (n_levels + 1), the
// node offsets of the degrees. Fold mode (n_nodes = 0): term k's variables
// are vars[offsets[k] .. offsets[k + 1]) (int32, at least one each). packed:
// float32 (tiles, M, warps x te, 2), the coefficients of term k for entry
// e = tile x warps x te + j and plane p at [tile][k][j][p], zero past E;
// start: float32 (2, E) or null; out: complex64 (E, L) (interleaved = 1) or
// float32 (2, E, L) (0).
int monomial_contract_launch(const void* coeffs, const void* nodes, const void* levels,
                             const void* offsets, const void* vars, const void* packed,
                             const void* start, void* out, long long L, int M, int E, int n_vars,
                             int n_nodes, int n_levels, int chunk, int te, int warps, int tiles,
                             int interleaved, void* stream) {
  if (L < 1 || M < 1 || E < 1 || n_vars < 1 || n_nodes < 0 || tiles < 1 || tiles > 65535 ||
      chunk < 1 || (n_nodes > 0 && (n_nodes < M || n_levels < 1)))
    return (int)cudaErrorInvalidValue;
  const Problem p{static_cast<const float*>(coeffs), static_cast<const int4*>(nodes),
                  static_cast<const int*>(levels),   static_cast<const int*>(offsets),
                  static_cast<const int*>(vars),     static_cast<const float*>(packed),
                  static_cast<const float*>(start),  static_cast<float*>(out),
                  L, M, E, n_vars, n_nodes, n_levels, chunk, interleaved};
  cudaStream_t st = (cudaStream_t)stream;
  switch (te) {
    case 2: return (int)launch<2>(p, warps, tiles, st);
    case 4: return (int)launch<4>(p, warps, tiles, st);
    case 8: return (int)launch<8>(p, warps, tiles, st);
    case 10: return (int)launch<10>(p, warps, tiles, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* monomial_contract_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
