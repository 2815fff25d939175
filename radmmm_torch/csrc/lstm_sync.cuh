// The step barriers and the host-side launch helpers shared by the LSTM
// recurrence's forward (lstm_recurrence.cu) and backward
// (lstm_recurrence_bwd.cu) kernels.
//
// Cluster route: barrier.cluster with release on arrive and acquire on
// wait orders one step's writes into peers' shared memory (distributed
// shared memory) before the next step's reads. Grid route: a lane's CTAs
// add to the lane's counter with a release after the step, and spin on an
// acquire load until it reaches step x CTAs.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The grid route's barrier, split in its two halves: thread 0 announces
// that its CTA finished the step (after the CTA's writes, ordered by the
// caller's __syncthreads), and waits until every CTA of the lane has
// announced `want` steps in all; the __syncthreads after the wait hands
// that order to the CTA's other threads.
__device__ __forceinline__ void lane_arrive(unsigned* counter) {
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

__device__ __forceinline__ void lane_wait(const unsigned* counter,
                                          unsigned want) {
  if (threadIdx.x == 0) {
    while (ld_acquire(counter) < want) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Host side, shared by the two kernels' C interfaces.

// The current device's limits for the wrapper's plan: SMs, the dynamic
// shared memory a block may opt into, shared memory per SM, and the
// registers a thread of `grid_kernel` uses as compiled.
template <typename Kernel>
inline int lstm_card_limits(Kernel grid_kernel, int* sms, int* smem_block,
                            int* smem_sm, int* regs_grid) {
  int dev = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(
           smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev))
      != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, grid_kernel)) != cudaSuccess)
    return (int)e;
  *regs_grid = fa.numRegs;
  return 0;
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         int n_cta, int blocks, int threads,
                                         size_t bytes, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_cta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of n_cta CTAs of `kern` (threads, bytes of dynamic shared
// memory each) that the current device holds at once, in *n_clusters (0:
// none fits, also when the CUDA driver refuses the size). Returns 0.
template <typename Kernel>
inline int lstm_active_clusters(Kernel kern, int n_cta, int threads,
                                size_t bytes, int* n_clusters) {
  *n_clusters = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess ||
      cudaFuncSetAttribute(kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess) {
    cudaGetLastError();     // a size the kernel cannot take: none fits
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, n_cta, n_cta, threads, bytes, nullptr);
  if (cudaOccupancyMaxActiveClusters(n_clusters, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    *n_clusters = 0;
  }
  return 0;
}

// One cluster of n_cta CTAs per lane (Hopper's non-portable size past 8),
// or a cooperative grid of the same blocks, so that every CTA is resident
// and a lane's spin barrier cannot deadlock. Returns cudaGetLastError()
// after the launch.
template <typename Params>
inline int lstm_launch(void (*kern)(const Params), const Params& p,
                       bool cluster, int n_cta, int blocks, int threads,
                       size_t bytes, cudaStream_t stream) {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes)) != cudaSuccess)
    return (int)e;
  if (cluster) {
    if (n_cta > 8 &&        // past the portable cluster size
        (e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
            != cudaSuccess)
      return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(&attr, n_cta, blocks, threads, bytes, stream);
    if ((e = cudaLaunchKernelEx(&cfg, kern, p)) != cudaSuccess) return (int)e;
  } else {
    void* args[] = {const_cast<Params*>(&p)};
    if ((e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                         dim3(threads), args, bytes, stream))
        != cudaSuccess)
      return (int)e;
  }
  return (int)cudaGetLastError();
}
