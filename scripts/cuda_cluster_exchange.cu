// What synchronizing the blocks of a thread-block cluster costs on this card:
// the numbers behind the exchange of qiskit_dynamics_tpu_torch/csrc/
// horner_apply.cu (kernel B4), whose blocks trade u once per Horner iteration.
//
// With clusters of 4 blocks of 512 threads and 140 KB of shared memory (one
// block per SM, the kernel's shape at n = 256), as many clusters as the card
// co-schedules, each running 20,000 rounds of:
//   - a cluster barrier with release/acquire semantics (cg::cluster_group::sync),
//   - a cluster barrier without them (barrier.cluster.arrive.relaxed),
//   - a block barrier (__syncthreads),
//   - the kernel's exchange: 64 threads of each block store 2 floats into
//     each of the 4 blocks with st.async, whose bytes complete on an mbarrier
//     in the receiving block, and every thread waits for its block's 2 KB.
// Then the one-way latency between the two blocks of a cluster of 2 (one
// thread each, 20,000 messages): st.async completing on an mbarrier, against
// a store followed by a release store of a flag that the other polls with
// acquire loads.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/cluster_exchange scripts/cuda_cluster_exchange.cu && build/cluster_exchange
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned mapa(unsigned a, int r) {
  unsigned o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r));
  return o;
}
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned phase) {
  asm volatile("{ .reg .pred p; W: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1; @!p bra W; }"
               ::"r"(bar), "r"(phase) : "memory");
}

constexpr int kRounds = 20000;

template <int MODE>
__global__ void __launch_bounds__(512, 1) rounds(int iters, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 sm4[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm4);
  float2* u = reinterpret_cast<float2*>(sm4 + 1);  // (2, 256)
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank(), tid = threadIdx.x;
  const unsigned bar0 = saddr(bars);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8));
    asm volatile("fence.mbarrier_init.release.cluster;");
  }
  for (int i = tid; i < 512; i += blockDim.x) u[i] = make_float2(0.f, 0.f);
  cluster.sync();
  unsigned phases = 0;
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (MODE == 0) {
      cluster.sync();
    } else if (MODE == 1) {
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    } else if (MODE == 2) {
      __syncthreads();
    } else {
      const int par = it & 1;
      const unsigned bar = bar0 + 8 * par;
      if (tid == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                     "r"(2048) : "memory");
      }
      if ((tid & 7) == 0) {  // 64 leaders: this block's 64 entries of u
        const int k = tid >> 3;
        const unsigned dst = saddr(u + par * 256 + c * 64 + k);
        for (int r = 0; r < C; ++r) {
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
              ::"r"(mapa(dst, r)), "f"(acc), "f"((float)k), "r"(mapa(bar, r)) : "memory");
        }
      }
      wait_parity(bar, (phases >> par) & 1);
      phases ^= 1u << par;
      acc += u[par * 256 + (tid & 255)].x;
    }
  }
  if (acc == -1.f) out[0] = acc;
  cluster.sync();
}

template <int MODE>
__global__ void one_way(int iters, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ __align__(16) unsigned long long bar;
  __shared__ __align__(16) float data[2];
  __shared__ unsigned flag;
  const int c = (int)cluster.block_rank(), other = c ^ 1;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&bar)));
    data[0] = 0.f;
    flag = 0;
    asm volatile("fence.mbarrier_init.release.cluster;");
  }
  cluster.sync();
  const unsigned b0 = saddr(&bar), rbar = mapa(b0, other);
  const unsigned rdata = mapa(saddr(data), other), rflag = mapa(saddr(&flag), other);
  unsigned phase = 0;
  if (threadIdx.x == 0) {
    for (int it = 0; it < iters; ++it) {
      const bool send = (it & 1) == c;
      if (MODE == 0) {
        if (send) {
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %1}, [%2];"
              ::"r"(rdata), "f"((float)it), "r"(rbar) : "memory");
        } else {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8;" ::"r"(b0)
                       : "memory");
          wait_parity(b0, phase);
          phase ^= 1;
        }
      } else if (send) {
        asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(rdata), "f"((float)it) : "memory");
        asm volatile("st.release.cluster.shared::cluster.u32 [%0], %1;" ::"r"(rflag), "r"(it + 1)
                     : "memory");
      } else {
        unsigned v;
        do {
          asm volatile("ld.acquire.cluster.shared::cta.u32 %0, [%1];"
                       : "=r"(v) : "r"(saddr(&flag)) : "memory");
        } while (v != (unsigned)(it + 1));
      }
    }
  }
  cluster.sync();
  if (threadIdx.x == 0 && c == 0) out[0] = data[0];
}

template <typename Kernel>
float time_ms(Kernel kernel, cudaLaunchConfig_t* config, float* out) {
  cudaLaunchKernelEx(config, kernel, 100, out);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  cudaLaunchKernelEx(config, kernel, kRounds, out);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

template <int MODE>
void run_rounds(const char* name, float* out) {
  const int smem = 140 * 1024;
  cudaFuncSetAttribute(rounds<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 4;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  config.blockDim = dim3(512);
  config.dynamicSmemBytes = smem;
  config.gridDim = dim3(4);
  int clusters = 0;
  cudaOccupancyMaxActiveClusters(&clusters, (void*)rounds<MODE>, &config);
  config.gridDim = dim3(4 * clusters);
  const float ms = time_ms(rounds<MODE>, &config, out);
  printf("%-52s: %7.1f ns per round (%d clusters of 4; %s)\n", name, ms * 1e6 / kRounds,
         clusters, cudaGetErrorString(cudaGetLastError()));
}

template <int MODE>
void run_one_way(const char* name, float* out) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  config.blockDim = dim3(32);
  config.gridDim = dim3(2);
  const float ms = time_ms(one_way<MODE>, &config, out);
  printf("%-52s: %7.1f ns one way (%s)\n", name, ms * 1e6 / kRounds,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  cudaMalloc(&out, sizeof(float));
  run_rounds<0>("cluster barrier, release/acquire", out);
  run_rounds<1>("cluster barrier, relaxed", out);
  run_rounds<2>("block barrier", out);
  run_rounds<3>("exchange of u: st.async to 4 blocks, mbarrier wait", out);
  run_one_way<0>("st.async + mbarrier", out);
  run_one_way<1>("store + release store of a flag, acquire polling", out);
  cudaFree(out);
  return 0;
}
