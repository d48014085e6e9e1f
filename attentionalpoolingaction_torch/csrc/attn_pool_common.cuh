// Helpers of the attentional pooling kernels of attn_pool.cu (the forward)
// and attn_pool_backward.cu (the head's backward), which nvcc builds as two
// libraries at once: 16-byte vectors of X, the column groups a lane owns,
// the cluster kernels' shared-memory layout and plan checks, the clustered
// launch, and the dispatch over X's dtype, the rank and the column groups.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define APA_MAX_RANK 8
#define APA_MAX_CLUSTER 16
#define APA_SAL_THREADS 256

namespace {

// -- 16-byte vectors of X: load16() loads, unpack() upcasts ----------------------

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  // round to nearest even, as torch's float32 -> bfloat16 cast
  __device__ __forceinline__ static uint4 pack(const float* in) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return u;
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Column groups of 16 bytes a lane may own in phase 1: the most of 4, 2, 1
// whose sal_w values (P x groups x kN floats) stay within 64 registers.
// The Python plan mirrors this (_lane_groups in ops/attn_pool_cuda.py).
template <typename T, int P>
__host__ __device__ constexpr int lane_groups() {
  return 64 / (P * Vec<T>::kN) >= 4 ? 4 : 64 / (P * Vec<T>::kN) >= 2 ? 2 : 1;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shared memory of a saliency CTA: X slice (resident path) | partial s
// (P, N) | summed s (P, N) | phase-2 row classes (r2, P, fs).  A backward
// CTA holds a third (P, N) buffer, s beside the partial and summed ds
// (pn_buffers 3).
__host__ __device__ inline size_t saliency_smem_bytes(int N, int fs, int P,
                                                      int itemsize,
                                                      bool resident, int r2,
                                                      int pn_buffers = 2) {
  size_t bytes = resident ? align16((size_t)N * fs * itemsize) : 0;
  bytes += align16((size_t)pn_buffers * P * N * sizeof(float));
  if (r2 > 1) bytes += (size_t)r2 * P * fs * sizeof(float);
  return bytes;
}

// -- launches ---------------------------------------------------------------------

// Clusters of the last launch that the card can run at once, as
// cudaOccupancyMaxActiveClusters reported it (a diagnostic for
// chip_smoke.py; the last launch of any thread).
int g_last_active_clusters = 0;

// Launch `kernel` on grid (gx, gy) in clusters of `cluster` along x, after
// the attributes it needs and a check that one such cluster fits the card.
// Returns the first error.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int gx, int gy,
                             int threads, int cluster, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  g_last_active_clusters = clusters;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Calls l.run<T, P, J>() for the column groups J a lane owns in phase 1:
// the fewest of 1, 2, 4 that cover the slice of fs columns.  A slice wider
// than lane_groups allows at rank P is cudaErrorInvalidValue.
template <typename T, int P, typename L>
cudaError_t with_groups(int fs, const L& l) {
  const int groups = fs / Vec<T>::kN;
  if (groups > 32 * lane_groups<T, P>()) return cudaErrorInvalidValue;
  if (groups <= 32) return l.template run<T, P, 1>();
  if constexpr (lane_groups<T, P>() >= 2) {
    if (groups <= 64) return l.template run<T, P, 2>();
  }
  if constexpr (lane_groups<T, P>() >= 4) return l.template run<T, P, 4>();
  return cudaErrorInvalidValue;
}

template <typename T, typename L>
cudaError_t with_rank(int P, int fs, const L& l) {
  switch (P) {
    case 1: return with_groups<T, 1>(fs, l);
    case 2: return with_groups<T, 2>(fs, l);
    case 3: return with_groups<T, 3>(fs, l);
    case 4: return with_groups<T, 4>(fs, l);
    case 5: return with_groups<T, 5>(fs, l);
    case 6: return with_groups<T, 6>(fs, l);
    case 7: return with_groups<T, 7>(fs, l);
    case 8: return with_groups<T, 8>(fs, l);
    default: return cudaErrorInvalidValue;
  }
}

// Calls with_rank<float> or with_rank<__nv_bfloat16> for x_dtype 0 or 1.
template <typename L>
cudaError_t with_dtype(int x_dtype, int P, int fs, const L& l) {
  if (x_dtype == 0) return with_rank<float>(P, fs, l);
  if (x_dtype == 1) return with_rank<__nv_bfloat16>(P, fs, l);
  return cudaErrorInvalidValue;
}

bool valid_cluster(int S) {
  return S == 1 || S == 2 || S == 4 || S == 8 || S == 16;
}

// The checks an entry point of a cluster kernel makes of its plan: the
// cluster, the slice, the row classes and the shared memory the kernel's
// layout needs with pn_buffers (P, N) buffers.
bool valid_cluster_plan(int x_dtype, int B, int N, int F, int P, int cluster,
                        int r2, int resident, long long smem,
                        int pn_buffers) {
  if (!valid_cluster(cluster) || F % (8 * cluster) != 0 || r2 < 1 ||
      r2 > APA_SAL_THREADS || B < 1 || N < 1 || P < 1 ||
      P > APA_MAX_RANK || (x_dtype != 0 && x_dtype != 1)) {
    return false;
  }
  const int itemsize = x_dtype == 0 ? 4 : 2;
  return (size_t)smem == saliency_smem_bytes(N, F / cluster, P, itemsize,
                                             resident != 0, r2, pn_buffers);
}

}  // namespace
