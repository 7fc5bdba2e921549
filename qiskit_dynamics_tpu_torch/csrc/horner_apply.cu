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
// once (8 n^2 bytes per member; 1.07 GB at B = 2,048, n = 256: 0.32 ms at
// 3.35 TB/s) while its 8 order n^2 operations per member are ~0.4 of that
// time at order 8. So the matrix has to stay on chip across the `order`
// iterations, and the next member's matrix has to stream in while the
// current one iterates. One member's planes at n = 256 are 512 KB: more than
// one SM holds (227 KB of shared memory, 256 KB of registers). What the
// design meets instead is latency: each iteration needs the whole u of the
// previous one, so a member's `order` iterations are a chain of mat-vecs with
// an exchange between the SMs after each.
//
// Design: two __global__ functions with the same arithmetic.
//
// - horner_resident_kernel (n <= 256), persistent clusters. A member is
//   spread over a thread-block cluster of C = 1, 2, 4 or 8 blocks (the
//   smallest that fits): block c owns the output columns [c R, (c + 1) R) of
//   MT (R = ceil(n / C) rounded up to a multiple of 4) and all n rows of
//   them. The launch has only as many clusters as the card co-schedules, and
//   each walks over the members b = cluster, cluster + clusters, ....
//   - The next member's columns stream in while the current member
//     iterates: right after the block has read member b's panel out of its
//     landing buffer in shared memory, one thread issues a tensor copy (TMA)
//     of member b + clusters' columns of each plane and a bulk copy of its
//     state, completing on an mbarrier that the block waits on only when
//     member b is done (4-byte cp.async copies where n % 4 != 0).
//   - The panel is read from shared memory once per member: thread (i, q)
//     keeps MT[m, i] of the rows m = q, q + parts, ... in registers, at most
//     kRegRows = 32 complex entries (128 KB of the registers of a 512-thread
//     block at n = 256, C = 4).
//   - Every block keeps all of u, double-buffered by iteration parity, with
//     the rows of a part contiguous (16-byte loads). A column's parts are
//     neighbouring lanes and add their sums with warp shuffles, in a fixed
//     order; the lane of part 0 forms the next u[i] and stores it into every
//     block's buffer with st.async, whose bytes complete on that block's
//     mbarrier of that parity. A block waits for the n entries of a round and
//     nothing else: no block or cluster barrier per iteration (a cluster
//     barrier's release/acquire costs ~0.7 us on an H100, a round of
//     st.async ~0.35 us; scripts/cuda_cluster_exchange.cu). The state v
//     goes round the same way as the first round, which also keeps a block
//     from storing into a buffer that another block still reads.
// - horner_stream_kernel (any n; the route for n > 256): one block per
//   member re-reads MT from L2 or device memory in every iteration: order x
//   the minimum traffic. Each thread owns the outputs i, i + 1,024, ... of
//   its part of the rows, so any n whose two vectors fit in shared memory
//   runs (n <= 14,528).
//
// Any B, any order >= 1. Offsets into MT are 64-bit (B n^2 passes 2^31 at
// n = 1,024, B = 2,048).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr size_t kMaxShared = 232448;  // dynamic shared memory a block may use

// A resident block's threads each keep kRegRows complex panel entries of one
// column in registers; at most 512 threads, so each may use 128 registers.
constexpr int kRegRows = 32;
constexpr int kResidentThreads = 512;

struct Params {
  const float* mtr;  // (B, n, n) real plane of M^T
  const float* mti;
  const float* vr;  // (B, n)
  const float* vi;
  float* ur;  // (B, n)
  float* ui;
  int B, n, order;
  int nr, parts;  // streaming kernel: threads (i, q), nr columns x parts
  // resident kernel: blocks per member, columns per block, row strides of the
  // landing buffer (floats) and of u (float2), clusters launched, tensor-copy loads
  int cluster, cols, ls, us, clusters, tma;
};

// The resident kernel's launch shape at n: clusters of C blocks.
struct Shape {
  int cluster = 0, parts = 0, cols = 0, threads = 0, ls = 0, us = 0;
  size_t smem = 0;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The smallest x >= lo with x % m == r.
inline int at_least_congruent(int lo, int m, int r) { return lo + ((r - lo) % m + m) % m; }

// A resident block's shared memory: three mbarriers (32 bytes), u (2 x
// parts x us float2), then from a 128-byte boundary the landing buffer: each
// plane's n rows of ls floats (its size rounded up to 128 bytes) and the
// state's two planes (n floats each).
__host__ __device__ inline size_t landing_offset(int parts, int us) {
  return ((size_t)32 + 16 * (size_t)parts * us + 127) / 128 * 128;
}
__host__ __device__ inline size_t plane_floats(int n, int ls) {
  return ((size_t)n * ls + 31) / 32 * 32;
}

// The resident kernel's shape at n for clusters of C blocks, if it fits: n <=
// 256 (parts <= 8; at 16 parts a 512-thread block covers 32 columns, and
// eight blocks 256).
bool resident_shape(int n, int C, Shape* s) {
  int parts = 1;  // row groups of a column: a power of two, at most kRegRows rows each
  while (parts * kRegRows < n) parts *= 2;
  if (parts > 8) return false;
  // columns per block: a multiple of 4, so that every block's columns start
  // on 16 bytes (a tensor copy's box must)
  const int cols = round_up((n + C - 1) / C, 4);
  const int per_warp = 32 / parts;  // columns a warp covers
  const int threads = round_up(cols, per_warp) * parts;
  // every block owns at least one column; one block's threads
  if ((size_t)(C - 1) * cols >= (size_t)n || threads > kResidentThreads) return false;
  // row strides without bank conflicts: the parts of a warp read landing rows
  // `ls` floats apart (ls = per_warp mod 32, a multiple of 4), and u rows `us`
  // float2 apart with 16-byte loads (us = 2 mod 16)
  const int ls = at_least_congruent(cols, 32, per_warp % 32);
  const int us = at_least_congruent(kRegRows, 16, 2);
  const size_t smem =
      landing_offset(parts, us) + sizeof(float) * (2 * plane_floats(n, ls) + 2 * (size_t)n);
  if (smem > kMaxShared) return false;
  *s = Shape{C, parts, cols, threads, ls, us, smem};
  return true;
}

// The resident shape the launch takes at n: the smallest cluster that fits.
// False: the streaming kernel runs.
bool pick_resident_shape(int n, Shape* s) {
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    if (resident_shape(n, C, s)) return true;
  }
  return false;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store x at shared::cluster address `dst` asynchronously; its 8 bytes count
// towards the transaction count of the mbarrier `bar` in the same block.
__device__ __forceinline__ void store_async(unsigned dst, float2 x, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(dst), "f"(x.x), "f"(x.y), "r"(bar)
               : "memory");
}

// Expect `bytes` more in the current phase of the local mbarrier `bar`, and
// arrive on it (its one arrival per phase).
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of the local mbarrier `bar` with parity `phase` is complete.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Start the copies of member b's columns [col_lo, col_lo + my_cols) of both
// planes (n rows, row stride p.ls in the landing buffer) and of its whole
// state into a block's landing buffer. With p.tma, thread 0 issues one tensor
// copy per plane (a box of n rows x ls columns; columns past n read as zero)
// and one bulk copy per state plane, all completing on the mbarrier `landed`,
// after a block barrier (the buffer was last read through the generic
// proxy). Otherwise every thread issues 4-byte cp.async copies, one group.
__device__ __forceinline__ void issue_member_copy(const Params& p, const CUtensorMap& map_r,
                                                  const CUtensorMap& map_i, int b, int col_lo,
                                                  int my_cols, float* lr, float* li, float* lv,
                                                  unsigned landed) {
  const int n = p.n, ls = p.ls, tid = threadIdx.x, T = blockDim.x;
  if (p.tma) {
    if (tid == 0) {
      const unsigned plane = 4u * (unsigned)(n * ls), state = 4u * (unsigned)n;
      expect_bytes(landed, 2 * plane + 2 * state);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const CUtensorMap* maps[2] = {&map_r, &map_i};
      float* dst[2] = {lr, li};
      for (int k = 0; k < 2; ++k) {
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst[k])),
            "l"(reinterpret_cast<uint64_t>(maps[k])), "r"(col_lo), "r"(0), "r"(b), "r"(landed)
            : "memory");
      }
      const float* src[2] = {p.vr + (size_t)b * n, p.vi + (size_t)b * n};
      for (int k = 0; k < 2; ++k) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(lv + k * n)), "l"(src[k]), "r"(state), "r"(landed)
            : "memory");
      }
    }
    return;
  }
  const float* gr = p.mtr + (size_t)b * n * n + col_lo;
  const float* gi = p.mti + (size_t)b * n * n + col_lo;
  // thread t copies column t % my_cols of rows t / my_cols, t / my_cols + per_pass, ...
  const int per_pass = T / my_cols;
  if (tid < per_pass * my_cols) {
    const int k = tid % my_cols;
    for (int m = tid / my_cols; m < n; m += per_pass) {
      cp_async4(lr + m * ls + k, gr + (size_t)m * n + k);
      cp_async4(li + m * ls + k, gi + (size_t)m * n + k);
    }
  }
  for (int idx = tid; idx < n; idx += T) {
    cp_async4(lv + idx, p.vr + (size_t)b * n + idx);
    cp_async4(lv + n + idx, p.vi + (size_t)b * n + idx);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kResidentThreads, 1)
    horner_resident_kernel(Params p, const __grid_constant__ CUtensorMap map_r,
                           const __grid_constant__ CUtensorMap map_i) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) float4 smem4[];
  const int n = p.n, parts = p.parts, C = p.cluster, ls = p.ls, us = p.us;
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31;
  const int col_lo = min(c * p.cols, n), my_cols = min(col_lo + p.cols, n) - col_lo;
  // three mbarriers (the exchange's two, by parity, and the landing
  // buffer's), then u double-buffered by parity with entry m at
  // [m % parts][m / parts] (the entries a part reads are contiguous)
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);  // (3)
  float2* u = reinterpret_cast<float2*>(smem4 + 2);                        // (2, parts, us)
  float* lr = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                       landing_offset(parts, us));  // (n, ls): landing, real
  float* li = lr + plane_floats(n, ls);
  float* lv = li + plane_floats(n, ls);  // (2, n): landing state

  // thread (col, q): output i = col_lo + col, rows q, q + parts, ...; the
  // parts of a column are neighbouring lanes, q == 0 leads; a warp whose
  // columns are all past the block's reads nothing
  const int q = lane & (parts - 1);
  const int col = (tid >> 5) * (32 / parts) + lane / parts;
  const int i = col_lo + col;
  const bool live = (tid >> 5) * (32 / parts) < my_cols;
  const bool mine = col < my_cols, leader = mine && q == 0;
  const int held_rows = mine ? (n - q + parts - 1) / parts : 0;  // rows q + parts j < n
  const unsigned bar0 = smem_addr(bars), landed = bar0 + 16;
  // u[i]'s slot in the buffer of parity 0 (parity 1: + parts us float2)
  const unsigned slot0 = smem_addr(u + (i % parts) * us + i / parts);
  // every iteration's u arrives as one round of the exchange (the first is v)
  const unsigned bytes = 8u * (unsigned)n;  // a round: every block's leaders send all of u

  for (int idx = tid; idx < 2 * parts * us; idx += blockDim.x) u[idx] = make_float2(0.f, 0.f);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(landed) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    expect_bytes(bar0, bytes);  // the first member's first round
  }
  const int first = blockIdx.x / C;
  __syncthreads();  // the barriers are initialized
  issue_member_copy(p, map_r, map_i, first, col_lo, my_cols, lr, li, lv, landed);
  // every block runs, its barriers are initialized and its u is zero before
  // anyone stores into it
  cluster_arrive();
  cluster_wait();

  int parity = 0;       // u[parity] is the current iteration's input
  unsigned phases = 0;  // bit x: the parity of the next phase of bars[x]
  unsigned landed_phase = 0;
  for (int b = first; b < p.B; b += p.clusters) {
    const bool last_member = b + p.clusters >= p.B;
    if (p.tma) {
      wait_phase(landed, landed_phase);
      landed_phase ^= 1;
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // member b's columns have landed
    float pr[kRegRows], pim[kRegRows];
    {
      const float* from_r = lr + q * ls + col;  // rows q, q + parts, ...: parts ls floats apart
      const float* from_i = li + q * ls + col;
#pragma unroll
      for (int j = 0; j < kRegRows; ++j) {
        const bool held = j < held_rows;
        pr[j] = held ? *from_r : 0.f;
        pim[j] = held ? *from_i : 0.f;
        from_r += parts * ls;
        from_i += parts * ls;
      }
    }
    const float2 v = mine ? make_float2(lv[i], lv[n + i]) : make_float2(0.f, 0.f);
    if (leader) {  // the first round: v[i] into every block's u[parity]
      // (every block last read u[parity] in the previous member's last
      // iteration but one, or a member earlier, and sent its part of the
      // round this block waited for since)
      const unsigned dst = slot0 + 8u * (unsigned)(parity * parts * us);
      const unsigned bar = bar0 + 8 * parity;
      for (int r = 0; r < C; ++r) store_async(cluster_addr(dst, r), v, cluster_addr(bar, r));
    }
    __syncthreads();  // the landing buffer is free
    if (!last_member) {
      issue_member_copy(p, map_r, map_i, b + p.clusters, col_lo, my_cols, lr, li, lv, landed);
    }

    float2 ut = v;
    for (int kk = p.order; kk >= 1; --kk) {
      const bool last_iter = kk == 1;
      const unsigned bar = bar0 + 8 * parity, next_bar = bar0 + 8 * (parity ^ 1);
      // this iteration's u has arrived from every block's leaders
      wait_phase(bar, (phases >> parity) & 1);
      phases ^= 1u << parity;
      // the next round: this member's next iteration, or the next member's first
      if (tid == 0 && !(last_iter && last_member)) expect_bytes(next_bar, bytes);
      const float inv = (float)(1.0 / (double)kk);
      float wr = 0.f, wi = 0.f;
      if (live) {
        const float4* x4 = reinterpret_cast<const float4*>(u + (parity * parts + q) * us);
        float ar0 = 0.f, ai0 = 0.f, ar1 = 0.f, ai1 = 0.f;
#pragma unroll
        for (int j = 0; j < kRegRows; j += 2) {
          const float4 x = x4[j / 2];  // u of rows q + parts j and q + parts (j + 1)
          ar0 = fmaf(pr[j], x.x, ar0);
          ar0 = fmaf(-pim[j], x.y, ar0);
          ai0 = fmaf(pr[j], x.y, ai0);
          ai0 = fmaf(pim[j], x.x, ai0);
          ar1 = fmaf(pr[j + 1], x.z, ar1);
          ar1 = fmaf(-pim[j + 1], x.w, ar1);
          ai1 = fmaf(pr[j + 1], x.w, ai1);
          ai1 = fmaf(pim[j + 1], x.z, ai1);
        }
        wr = ar0 + ar1;
        wi = ai0 + ai1;
        for (int off = parts / 2; off >= 1; off >>= 1) {  // the column's parts, in a fixed order
          wr += __shfl_xor_sync(0xffffffffu, wr, off);
          wi += __shfl_xor_sync(0xffffffffu, wi, off);
        }
      }
      ut = make_float2(fmaf(inv, wr, v.x), fmaf(inv, wi, v.y));
      if (!last_iter && leader) {  // the next u[i], into every block's u of the other parity
        const unsigned dst = slot0 + 8u * (unsigned)((parity ^ 1) * parts * us);
        for (int r = 0; r < C; ++r) store_async(cluster_addr(dst, r), ut, cluster_addr(next_bar, r));
      }
      parity ^= 1;
    }
    if (leader) {
      p.ur[(size_t)b * n + i] = ut.x;
      p.ui[(size_t)b * n + i] = ut.y;
    }
  }
  // no block leaves while another may still read from or store into its
  // shared memory
  cluster_arrive();
  cluster_wait();
}

__global__ void __launch_bounds__(kMaxThreads) horner_stream_kernel(Params p) {
  extern __shared__ float2 smem[];
  const int n = p.n, cols = p.nr, parts = p.parts;
  float2* u = smem;            // (n)
  float2* partial = smem + n;  // (parts, n)
  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int ic = tid % cols, q = tid / cols;
  const int chunk = (n + parts - 1) / parts;
  const int m_lo = min(q * chunk, n), m_hi = min(m_lo + chunk, n);
  const float* __restrict__ mr = p.mtr + (size_t)b * n * n;
  const float* __restrict__ mi = p.mti + (size_t)b * n * n;
  const float* __restrict__ vr = p.vr + (size_t)b * n;
  const float* __restrict__ vi = p.vi + (size_t)b * n;

  for (int i = tid; i < n; i += T) u[i] = make_float2(vr[i], vi[i]);
  for (int kk = p.order; kk >= 1; --kk) {
    const float inv = (float)(1.0 / (double)kk);
    __syncthreads();  // u is complete
    for (int i = ic; i < n; i += cols) {
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
      partial[(size_t)q * n + i] = make_float2(accr, acci);
    }
    __syncthreads();  // the partial sums are complete; u is no longer read
    for (int i = tid; i < n; i += T) {
      float2 w = partial[i];
      for (int r = 1; r < parts; ++r) {
        const float2 t = partial[(size_t)r * n + i];
        w.x += t.x;
        w.y += t.y;
      }
      u[i] = make_float2(fmaf(inv, w.x, vr[i]), fmaf(inv, w.y, vi[i]));
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += T) {
    p.ur[(size_t)b * n + i] = u[i].x;
    p.ui[(size_t)b * n + i] = u[i].y;
  }
}

// The streaming kernel's threads (cols columns x parts) and shared memory at n.
void stream_shape(int n, int* cols, int* parts, size_t* smem) {
  *cols = n < kMaxThreads ? round_up(n, 32) : kMaxThreads;
  *parts = kMaxThreads / *cols;
  *smem = sizeof(float2) * (size_t)n * (1 + *parts);
}

cudaLaunchConfig_t cluster_config(const Shape& s, int clusters, cudaLaunchAttribute* attribute) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)clusters * s.cluster);
  config.blockDim = dim3(s.threads);
  config.dynamicSmemBytes = s.smem;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = s.cluster;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return config;
}

// The resident kernel's dynamic shared memory for shape s.
cudaError_t set_shared_memory(const Shape& s) {
  return cudaFuncSetAttribute(horner_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)s.smem);
}

// Clusters of the resident kernel's shape s that the card co-schedules (the
// CUDA occupancy calculator), or 0 with the error in *err.
int active_clusters(const Shape& s, cudaError_t* err) {
  *err = set_shared_memory(s);
  if (*err != cudaSuccess) return 0;
  cudaLaunchAttribute attribute;
  cudaLaunchConfig_t config = cluster_config(s, 1, &attribute);
  int count = 0;
  *err = cudaOccupancyMaxActiveClusters(&count, (const void*)horner_resident_kernel, &config);
  return *err == cudaSuccess ? count : 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Tensor maps of the two (B, n, n) planes for boxes of n rows x ls columns of
// one member (cuTensorMapEncodeTiled, reached through the runtime's
// entry-point query: the library does not link libcuda).
cudaError_t encode_plane_maps(const float* mtr, const float* mti, int B, int n, int ls,
                              CUtensorMap* maps) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[2] = {4ull * n, 4ull * n * n};  // bytes, of dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)ls, (cuuint32_t)n, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const float* planes[2] = {mtr, mti};
  for (int k = 0; k < 2; ++k) {
    const CUresult res =
        encode(&maps[k], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(planes[k]), dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks per member of the resident kernel: the smallest cluster whose blocks
// can hold the matrix, or 0 where none can (the streaming kernel runs then).
int horner_apply_cluster(int n) {
  Shape s;
  return n >= 1 && pick_resident_shape(n, &s) ? s.cluster : 0;
}

// Clusters of C blocks of the resident kernel at n that the card co-schedules
// (the CUDA occupancy calculator), or 0 where C blocks cannot hold the matrix.
int horner_apply_active_clusters(int n, int C) {
  Shape s;
  if (n < 1 || C < 1 || C > kMaxCluster) return 0;
  if (!resident_shape(n, C, &s)) return 0;
  cudaError_t err;
  const int count = active_clusters(s, &err);
  cudaGetLastError();
  return count;
}

// The largest n the kernels take: the streaming kernel's two vectors of n
// float2 (u and the partial sums: parts = 1 above n = 512) in shared memory.
int horner_apply_max_n() { return (int)(kMaxShared / (2 * sizeof(float2))); }

// Launch on `stream`: the resident kernel over as many clusters as the card
// co-schedules (at most B), or B blocks of the streaming kernel (also with
// force_stream, for the tests). Returns the CUDA error code of the launch
// (0 = cudaSuccess; cudaErrorInvalidValue where n exceeds
// horner_apply_max_n()); faults during the run surface at the next
// synchronization.
int horner_apply_launch(const float* mtr, const float* mti, const float* vr, const float* vi,
                        float* ur, float* ui, int B, int n, int order, int force_stream,
                        void* stream) {
  if (B < 1 || n < 1 || order < 1) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.mtr = mtr;
  p.mti = mti;
  p.vr = vr;
  p.vi = vi;
  p.ur = ur;
  p.ui = ui;
  p.B = B;
  p.n = n;
  p.order = order;
  Shape s;
  cudaError_t err;
  if (force_stream || !pick_resident_shape(n, &s)) {
    size_t smem;
    stream_shape(n, &p.nr, &p.parts, &smem);
    if (smem > kMaxShared) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(horner_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    horner_stream_kernel<<<B, p.nr * p.parts, smem, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
  }
  // the occupancy query, once per device and n
  static int cached_device = -1, cached_n = -1, cached_clusters = 0;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device || n != cached_n) {
    const int clusters = active_clusters(s, &err);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    cached_device = device;
    cached_n = n;
    cached_clusters = clusters;
  }
  err = set_shared_memory(s);
  if (err != cudaSuccess) return (int)err;
  p.parts = s.parts;
  p.cluster = s.cluster;
  p.cols = s.cols;
  p.ls = s.ls;
  p.us = s.us;
  p.clusters = cached_clusters < B ? cached_clusters : B;
  // tensor copies where the hardware takes them: a box of n <= 256 rows of
  // ls <= 256 columns, rows of 16-byte multiples, 16-byte aligned planes
  CUtensorMap maps[2] = {};
  p.tma = n % 4 == 0 && s.ls % 4 == 0 && s.ls <= 256 &&
          ((uintptr_t)mtr | (uintptr_t)mti | (uintptr_t)vr | (uintptr_t)vi) % 16 == 0;
  if (p.tma) {
    err = encode_plane_maps(mtr, mti, B, n, s.ls, maps);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attribute;
  cudaLaunchConfig_t config = cluster_config(s, p.clusters, &attribute);
  config.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&config, horner_resident_kernel, p, maps[0], maps[1]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* horner_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
