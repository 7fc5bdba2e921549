// Batched Horner expm action on batch-major step matrices, for Hopper (sm_90a).
//
// Replaces the TPU kernel qiskit_dynamics_tpu/ops/horner_pallas.py::
// _horner_kernel_loop / _horner_kernel (Pallas, one function with two bodies,
// launched by horner_apply_bm). Wrapper and plain version:
// qiskit_dynamics_tpu_torch/ops/horner_pallas.py.
//
// What it computes. For every member b, from the real and imaginary planes of
// the TRANSPOSED step matrix MT[b] = M_b^T (B, n, n) and of the state v_b
// (B, n), all float32:
//   u = v; u = v + (M u)/j for j = order..1      (u = sum_{j<=order} M^j v / j!)
// with (M u)[i] = sum_m MT[m, i] u[m].
//
// What bounds it on this card. Bytes: the function must read each matrix
// once (8 n^2 bytes per member; 1.07 GB at B = 2,048, n = 256) while its
// 8 order n^2 operations per member are ~0.4 of that time at order 8. So the
// matrix has to stay on chip across the `order` iterations. One member's
// planes at n = 256 are 512 KB: more than a block's shared memory (227 KB) and
// more than an SM's registers.
//
// Design: two __global__ functions with the same arithmetic.
//
// - horner_resident_kernel: a member is given a thread-block cluster of
//   C = 1, 2, 4 or 8 blocks (the smallest that fits). Block c keeps rows
//   [c R, (c + 1) R) of both planes of MT in its shared memory (R = ceil(n / C);
//   128 KB per block at n = 256, C = 4), read from device memory once,
//   coalesced. In every iteration each block sums its rows' share of M u for
//   all n outputs (thread (i, q) owns output i for the q-th part of the
//   block's rows and reads MT[m, i], consecutive across a warp, so no bank
//   conflicts), the blocks exchange those n partial sums through distributed
//   shared memory (double-buffered, one cluster barrier per iteration), and
//   each block forms the same next u from them, summed in rank order.
// - horner_stream_kernel: where even eight blocks cannot hold the matrix
//   (n > ~470), one block per member re-reads MT from L2 or device memory in
//   every iteration: order x the minimum traffic.
//
// The resident panel is sized by the element width (8 bytes per complex
// entry of float32 planes); any n up to 1,024, any B, any order. Blocks have
// roundup(n, 32) x parts threads, at most 1,024.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr size_t kMaxShared = 232448;    // dynamic shared memory a block may use

struct Params {
  const float* mtr;  // (B, n, n) real plane of M^T
  const float* mti;
  const float* vr;  // (B, n)
  const float* vi;
  float* ur;  // (B, n)
  float* ui;
  int B, n, order, nr, parts;
  int cluster, rows, vec4;  // resident kernel: blocks per member, rows per block, 16-byte loads
};

// float2 elements of a resident block's vectors: u, two buffers of this
// block's partial sums, the per-part partial sums
__host__ __device__ inline size_t resident_vector_elems(int n, int nr, int parts) {
  return (size_t)3 * n + (size_t)parts * nr;
}

__global__ void __launch_bounds__(kMaxThreads) horner_resident_kernel(Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = p.n, nr = p.nr, parts = p.parts, rows = p.rows, C = p.cluster;
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x;
  const int row_lo = min(c * rows, n), my_rows = min(row_lo + rows, n) - row_lo;
  float* mr = smem;                      // (rows, n): this block's rows of the real plane
  float* mi = mr + (size_t)rows * n;
  float2* u = reinterpret_cast<float2*>(mi + (size_t)rows * n);  // (n), the same in every block
  float2* mine = u + n;                  // (2, n): this block's partial sums, by iteration parity
  float2* partial = mine + 2 * n;        // (parts, nr)

  const float* __restrict__ gr = p.mtr + ((size_t)b * n + row_lo) * n;
  const float* __restrict__ gi = p.mti + ((size_t)b * n + row_lo) * n;
  const int count = my_rows * n;
  if (p.vec4) {
    const float4* __restrict__ gr4 = reinterpret_cast<const float4*>(gr);
    const float4* __restrict__ gi4 = reinterpret_cast<const float4*>(gi);
    float4* mr4 = reinterpret_cast<float4*>(mr);
    float4* mi4 = reinterpret_cast<float4*>(mi);
#pragma unroll 4
    for (int idx = tid; idx < count / 4; idx += blockDim.x) {
      mr4[idx] = gr4[idx];
      mi4[idx] = gi4[idx];
    }
  } else {
#pragma unroll 4
    for (int idx = tid; idx < count; idx += blockDim.x) {
      mr[idx] = gr[idx];
      mi[idx] = gi[idx];
    }
  }
  float2 v = make_float2(0.0f, 0.0f);
  if (tid < n) {
    v = make_float2(p.vr[(size_t)b * n + tid], p.vi[(size_t)b * n + tid]);
    u[tid] = v;
  }
  const int i = tid % nr, q = tid / nr;
  const int chunk = (rows + parts - 1) / parts;
  const int m_lo = min(q * chunk, my_rows), m_hi = min(m_lo + chunk, my_rows);
  float2 ut = v;
  int parity = 0;
  for (int kk = p.order; kk >= 1; --kk, parity ^= 1) {
    const float inv = (float)(1.0 / (double)kk);
    __syncthreads();  // u (and, the first time, the panel) is complete
    if (i < n) {
      float accr = 0.0f, acci = 0.0f;
#pragma unroll 4
      for (int m = m_lo; m < m_hi; ++m) {
        const float ar = mr[m * n + i], ai = mi[m * n + i];
        const float2 x = u[row_lo + m];
        accr = fmaf(ar, x.x, accr);
        accr = fmaf(-ai, x.y, accr);
        acci = fmaf(ar, x.y, acci);
        acci = fmaf(ai, x.x, acci);
      }
      partial[q * nr + i] = make_float2(accr, acci);
    }
    __syncthreads();  // the per-part sums are complete; u is no longer read
    float2* out = mine + parity * n;
    if (tid < n) {
      float2 w = partial[tid];
      for (int r = 1; r < parts; ++r) {
        const float2 t = partial[r * nr + tid];
        w.x += t.x;
        w.y += t.y;
      }
      out[tid] = w;
    }
    // every block's sums of this iteration are visible; the buffer of the other
    // parity is rewritten only after the next barrier, when nobody reads it
    cluster.sync();
    if (tid < n) {
      float2 w = make_float2(0.0f, 0.0f);
      for (int r = 0; r < C; ++r) {  // rank order: every block forms the same u
        const float2 t = cluster.map_shared_rank(out, r)[tid];
        w.x += t.x;
        w.y += t.y;
      }
      ut = make_float2(fmaf(inv, w.x, v.x), fmaf(inv, w.y, v.y));
      u[tid] = ut;
    }
  }
  cluster.sync();  // no block leaves while its shared memory may still be read
  if (c == 0 && tid < n) {
    p.ur[(size_t)b * n + tid] = ut.x;
    p.ui[(size_t)b * n + tid] = ut.y;
  }
}

__global__ void __launch_bounds__(kMaxThreads) horner_stream_kernel(Params p) {
  extern __shared__ float2 smem[];
  const int n = p.n, nr = p.nr, parts = p.parts;
  float2* u = smem;            // (n)
  float2* partial = smem + n;  // (parts, nr)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int i = tid % nr, q = tid / nr;
  const int chunk = (n + parts - 1) / parts;
  const int m_lo = min(q * chunk, n), m_hi = min(m_lo + chunk, n);
  const float* __restrict__ mr = p.mtr + (size_t)b * n * n;
  const float* __restrict__ mi = p.mti + (size_t)b * n * n;

  float2 v = make_float2(0.0f, 0.0f);
  if (tid < n) {
    v = make_float2(p.vr[(size_t)b * n + tid], p.vi[(size_t)b * n + tid]);
    u[tid] = v;
  }
  float2 ut = v;
  for (int kk = p.order; kk >= 1; --kk) {
    const float inv = (float)(1.0 / (double)kk);
    __syncthreads();  // u is complete
    if (i < n) {
      float accr = 0.0f, acci = 0.0f;
#pragma unroll 4
      for (int m = m_lo; m < m_hi; ++m) {
        const float ar = mr[(size_t)m * n + i], ai = mi[(size_t)m * n + i];
        const float2 x = u[m];
        accr = fmaf(ar, x.x, accr);
        accr = fmaf(-ai, x.y, accr);
        acci = fmaf(ar, x.y, acci);
        acci = fmaf(ai, x.x, acci);
      }
      partial[q * nr + i] = make_float2(accr, acci);
    }
    __syncthreads();  // the partial sums are complete; u is no longer read
    if (tid < n) {
      float2 w = partial[tid];
      for (int r = 1; r < parts; ++r) {
        const float2 t = partial[r * nr + tid];
        w.x += t.x;
        w.y += t.y;
      }
      ut = make_float2(fmaf(inv, w.x, v.x), fmaf(inv, w.y, v.y));
      u[tid] = ut;
    }
  }
  if (tid < n) {
    p.ur[(size_t)b * n + tid] = ut.x;
    p.ui[(size_t)b * n + tid] = ut.y;
  }
}

}  // namespace

extern "C" {

// Blocks per member of the resident kernel: the smallest cluster whose blocks
// can hold the matrix, or 0 where none can (the streaming kernel runs then).
int horner_apply_cluster(int n) {
  const int nr = (n + 31) / 32 * 32;
  const int parts = kMaxThreads / nr;
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    const int rows = (n + C - 1) / C;
    const size_t bytes = sizeof(float) * 2 * (size_t)rows * n +
                         sizeof(float2) * resident_vector_elems(n, nr, parts);
    if (bytes <= kMaxShared) return C;
  }
  return 0;
}

// Launch on `stream`: B clusters of the resident kernel, or B blocks of the
// streaming kernel (also with force_stream, for the tests). Returns the CUDA
// error code of the launch (0 = cudaSuccess); faults during the run surface at
// the next synchronization.
int horner_apply_launch(const float* mtr, const float* mti, const float* vr, const float* vi,
                        float* ur, float* ui, int B, int n, int order, int force_stream,
                        void* stream) {
  if (B < 1 || n < 1 || n > kMaxThreads || order < 1) return (int)cudaErrorInvalidValue;
  const int nr = (n + 31) / 32 * 32;
  const int parts = kMaxThreads / nr;
  const int C = force_stream ? 0 : horner_apply_cluster(n);
  Params p{mtr, mti, vr, vi, ur, ui, B, n, order, nr, parts, C, 0, 0};
  if (C == 0) {
    const size_t smem = sizeof(float2) * ((size_t)n + (size_t)parts * nr);
    horner_stream_kernel<<<B, nr * parts, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  }
  p.rows = (n + C - 1) / C;
  p.vec4 = n % 4 == 0 && (uintptr_t)mtr % 16 == 0 && (uintptr_t)mti % 16 == 0;
  const size_t smem = sizeof(float) * 2 * (size_t)p.rows * n +
                      sizeof(float2) * resident_vector_elems(n, nr, parts);
  cudaError_t err = cudaFuncSetAttribute(horner_resident_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)B * C);
  config.blockDim = dim3(nr * parts);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = C;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, horner_resident_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* horner_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
