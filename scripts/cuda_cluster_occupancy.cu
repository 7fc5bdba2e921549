// How many thread-block clusters of each size (1 to 16 blocks) the card can
// co-schedule for a block shaped like the fused expm chain's (256 threads,
// 114 KB of dynamic shared memory, so one block per SM): the numbers behind
// the cluster choice of qiskit_dynamics_tpu_torch/csrc/expm_chain.cu.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -o build/cluster_occupancy \
//       scripts/cuda_cluster_occupancy.cu && build/cluster_occupancy
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256) probe(float* x) {
  extern __shared__ float s[];
  s[threadIdx.x] = 1;
  if (x) x[0] = s[0];
}

int main() {
  const int smem = 114 * 1024;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int cs = 1; cs <= 16; ++cs) {
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(cs);
    config.blockDim = dim3(256);
    config.dynamicSmemBytes = smem;
    config.attrs = attr;
    config.numAttrs = 1;
    int count = -1;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&count, (void*)probe, &config);
    printf("cluster %2d: %d active (%s) -> %d SMs\n", cs, count, cudaGetErrorString(err),
           count * cs);
    cudaGetLastError();
  }
  return 0;
}
