// Streamed propagator-chain application, for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/chain_apply.py::_kernel
// (Pallas, launched by chain_apply_bol). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/chain_apply.py.
//
// What it computes. For every lane b, from the complex64 or complex128
// propagator stack U (T, n, n, B) and the states y0 (n, B) of the same type:
//   y_b <- U[T-1, :, :, b] ... U[1, :, :, b] U[0, :, :, b] y_b
// with y_new[i] = sum_m U[t, i, m, b] y[m], the sum taken over m in order,
// each term as (ur yr - ui yi, ur yi + ui yr). This file is built without
// multiply-add contraction (kernels/_build.py), so the plain version, which
// does the same rounded operations on real and imaginary planes, agrees
// with it bit for bit.
//
// What bounds it on this card. Bytes: every propagator entry is read once
// and used once (8 n^2 T B bytes in complex64: 1.64 GB at n = 10, T = 1,000,
// B = 2,048; twice that in complex128) for 8 operations each. The time steps
// are sequential and there are only B lanes, so what matters is how many
// bytes are in flight.
//
// Design. The sequential grid axis of the TPU kernel is a loop inside the
// block. A block owns LANES lanes (16, or 8 above n = 16) and has one thread
// per (row, lane): thread (i, l) reads row i of its lane's propagator, n
// consecutive-lane float2 loads that coalesce across the lanes, straight
// from the interleaved complex tensor (no split into planes, any strides
// over the first three axes). The state lives in shared memory, double
// buffered, so a step costs one barrier. Row t + 1 is loaded into registers
// before step t is multiplied, which keeps two steps of loads in flight per
// thread. The last block masks its ragged edge.
//
// n is a template argument (1 to 32) so that the row stays in registers.
// The complex128 instantiation (the FP64 Dysolve of ops/df_chain.py's
// counterpart) keeps the same design: a complex128 row of n = 16 already
// takes 64 registers, so above n = 16 it loads each row when it is used
// instead of one step ahead (two rows of 32 complex128 values would not fit
// the 255 registers of a thread).
//
// Above n = 32 (chain_apply_wide_kernel) a block has 32 threads per lane and
// each thread computes the rows i, i + 32, i + 64, ... of its lane's new
// state: n is a runtime value, the double-buffered state is in dynamic shared
// memory (8 lanes a block, fewer where 2 n lanes states would pass 227 KB),
// every row is read from memory as it is used, and the sum over m runs in
// order with the same rounded operations, so this path is bitwise with the
// plain version too. Above n = 4096 the wrapper raises.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 4096;
constexpr int kWideLanes = 8;           // lanes of a block above n = 32
constexpr size_t kSharedLimit = 232448;  // dynamic shared memory a block may use

template <typename R> struct Complex;
template <> struct Complex<float> { using type = float2; };
template <> struct Complex<double> { using type = double2; };

// Rows of complex128 above n = 16 are loaded when used, not one step ahead.
template <typename R, int N> struct Prefetch {
  static constexpr bool value = sizeof(R) == 4 || N <= 16;
};

template <typename R, int N, int LANES>
__global__ void __launch_bounds__(N * LANES)
chain_apply_kernel(const typename Complex<R>::type* __restrict__ props,
                   const typename Complex<R>::type* __restrict__ y0,
                   typename Complex<R>::type* __restrict__ out, int T, int B, long long st,
                   long long si, long long sj) {
  using C = typename Complex<R>::type;
  constexpr bool kAhead = Prefetch<R, N>::value;
  constexpr int kNext = kAhead ? N : 1;
  __shared__ C ybuf[2][N][LANES];
  const int l = threadIdx.x % LANES, i = threadIdx.x / LANES;
  const int b = blockIdx.x * LANES + l;
  const bool live = b < B;
  C zero;
  zero.x = 0;
  zero.y = 0;

  ybuf[0][i][l] = live ? y0[(size_t)i * B + b] : zero;
  // entry (t, i, m, b) of the stack is row[t * st + m * sj]
  const C* row = props + (long long)i * si + b;
  C u[N], un[kNext];
#pragma unroll
  for (int m = 0; m < N; ++m) u[m] = live ? __ldcs(row + m * sj) : zero;
#pragma unroll
  for (int m = 0; m < kNext; ++m) un[m] = zero;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    if (kAhead && live && t + 1 < T) {
      const C* next = row + (long long)(t + 1) * st;
#pragma unroll
      for (int m = 0; m < kNext; ++m) un[m] = __ldcs(next + m * sj);
    }
    if (!kAhead && live && t > 0) {
      const C* now = row + (long long)t * st;
#pragma unroll
      for (int m = 0; m < N; ++m) u[m] = __ldcs(now + m * sj);
    }
    R ar = 0, ai = 0;
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const C y = ybuf[cur][m][l];
      ar = ar + (u[m].x * y.x - u[m].y * y.y);
      ai = ai + (u[m].x * y.y + u[m].y * y.x);
    }
    C v;
    v.x = ar;
    v.y = ai;
    ybuf[cur ^ 1][i][l] = v;
    __syncthreads();
    cur ^= 1;
    if (kAhead) {
#pragma unroll
      for (int m = 0; m < kNext; ++m) u[m] = un[m];
    }
  }
  if (live) out[(size_t)i * B + b] = ybuf[cur][i][l];
}

// n > 32: 32 threads per lane, rows i, i + 32, ... per thread, rows read from
// memory when used; the state ybuf[2][n][lanes] in dynamic shared memory.
template <typename R>
__global__ void __launch_bounds__(32 * kWideLanes)
chain_apply_wide_kernel(const typename Complex<R>::type* __restrict__ props,
                        const typename Complex<R>::type* __restrict__ y0,
                        typename Complex<R>::type* __restrict__ out, int T, int n, int B,
                        long long st, long long si, long long sj) {
  using C = typename Complex<R>::type;
  extern __shared__ __align__(16) unsigned char ybuf_bytes[];
  const int lanes = blockDim.x / 32;
  C* ybuf = reinterpret_cast<C*>(ybuf_bytes);  // [2][n][lanes]
  const int l = threadIdx.x % lanes, i = threadIdx.x / lanes;
  const int b = blockIdx.x * lanes + l;
  const bool live = b < B;
  C zero;
  zero.x = 0;
  zero.y = 0;
  for (int r = i; r < n; r += 32) ybuf[r * lanes + l] = live ? y0[(size_t)r * B + b] : zero;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const C* y_now = ybuf + (size_t)cur * n * lanes;
    C* y_next = ybuf + (size_t)(cur ^ 1) * n * lanes;
    for (int r = i; r < n; r += 32) {
      const C* row = props + (long long)t * st + (long long)r * si + b;
      R ar = 0, ai = 0;
      for (int m = 0; m < n; ++m) {
        const C u = live ? __ldcs(row + m * sj) : zero;
        const C y = y_now[m * lanes + l];
        ar = ar + (u.x * y.x - u.y * y.y);
        ai = ai + (u.x * y.y + u.y * y.x);
      }
      C v;
      v.x = ar;
      v.y = ai;
      y_next[r * lanes + l] = v;
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int r = i; r < n; r += 32)
    if (live) out[(size_t)r * B + b] = ybuf[((size_t)cur * n + r) * lanes + l];
}

template <typename R>
cudaError_t launch_wide(const void* props, const void* y0, void* out, int T, int n, int B,
                        long long st, long long si, long long sj, cudaStream_t stream) {
  using C = typename Complex<R>::type;
  int lanes = kWideLanes;
  while (lanes > 1 && 2 * (size_t)n * lanes * sizeof(C) > kSharedLimit) lanes /= 2;
  const size_t smem = 2 * (size_t)n * lanes * sizeof(C);
  if (smem > kSharedLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chain_apply_wide_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chain_apply_wide_kernel<R><<<(B + lanes - 1) / lanes, 32 * lanes, smem, stream>>>(
      (const C*)props, (const C*)y0, (C*)out, T, n, B, st, si, sj);
  return cudaGetLastError();
}

template <typename R, int N>
cudaError_t launch(const void* props, const void* y0, void* out, int T, int B, long long st,
                   long long si, long long sj, cudaStream_t stream) {
  using C = typename Complex<R>::type;
  constexpr int LANES = N <= 16 ? 16 : 8;
  chain_apply_kernel<R, N, LANES><<<(B + LANES - 1) / LANES, N * LANES, 0, stream>>>(
      (const C*)props, (const C*)y0, (C*)out, T, B, st, si, sj);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// props: complex64 (double_precision = 0) or complex128 (1) (T, n, n, B) with
// element strides st, si, sj over the first three axes and 1 over the last;
// y0, out: contiguous (n, B) of the same type.
int chain_apply_launch(const void* props, const void* y0, void* out, int T, int n, int B,
                       long long st, long long si, long long sj, int double_precision,
                       void* stream) {
  if (T < 1 || n < 1 || n > kMaxN || B < 1) return (int)cudaErrorInvalidValue;
  const void* p = props;
  const void* y = y0;
  void* o = out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 32)
    return (int)(double_precision ? launch_wide<double>(p, y, o, T, n, B, st, si, sj, s)
                                  : launch_wide<float>(p, y, o, T, n, B, st, si, sj, s));
#define CHAIN_CASE(N)                                                     \
  case N:                                                                 \
    return (int)(double_precision ? launch<double, N>(p, y, o, T, B, st, si, sj, s) \
                                  : launch<float, N>(p, y, o, T, B, st, si, sj, s));
  switch (n) {
    CHAIN_CASE(1) CHAIN_CASE(2) CHAIN_CASE(3) CHAIN_CASE(4) CHAIN_CASE(5) CHAIN_CASE(6)
    CHAIN_CASE(7) CHAIN_CASE(8) CHAIN_CASE(9) CHAIN_CASE(10) CHAIN_CASE(11) CHAIN_CASE(12)
    CHAIN_CASE(13) CHAIN_CASE(14) CHAIN_CASE(15) CHAIN_CASE(16) CHAIN_CASE(17) CHAIN_CASE(18)
    CHAIN_CASE(19) CHAIN_CASE(20) CHAIN_CASE(21) CHAIN_CASE(22) CHAIN_CASE(23) CHAIN_CASE(24)
    CHAIN_CASE(25) CHAIN_CASE(26) CHAIN_CASE(27) CHAIN_CASE(28) CHAIN_CASE(29) CHAIN_CASE(30)
    CHAIN_CASE(31) CHAIN_CASE(32)
  }
#undef CHAIN_CASE
  return (int)cudaErrorInvalidValue;
}

const char* chain_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
