// The head's backward for Hopper (sm_90a): the pass over X.
//
// It replaces no Pallas kernel: the JAX package's _fused_bwd
// (attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:316) is jnp einsums
// that XLA fuses.  Run eagerly as torch ops (fused_pool_backward_plain in
// ops/attn_pool_cuda.py) those take ~13 launches, read X twice (ds = X dv,
// then d_sal_w = X^T ds) and write dx in two steps: 0.0699 / 0.1140 ms at
// B = 8 / 32, N = 49, f32 X, on an H100 at 700 W, 1.13-1.40x slower than
// autograd of the plain forward and 5.5-8.5% of the byte bound (PERF.md
// section 6).
//
// What bounds it on the H100: bytes, X read once and dx written once (25.7
// MB at B = 32, N = 49, f32); its 8 N F P flops are at most 8 flops a byte
// of them.  Around it, the wrapper keeps two cuBLAS products that are no
// pass over X (dv = g A, the kernel's input, and d_attn_w = sum_b v_b g_b^T)
// and one sum(0) over B of the kernel's per-image partials: 4 launches.
//
// The kernel has the saliency kernel's cluster and F-slice layout, and its
// plan (ops/attn_pool_cuda.py: backward_plan) the same rules:
//   * Phase 1: each CTA reads its slice of X_b from HBM once (into shared
//     memory on the resident path) and forms its partial
//     ds[p, n] = sum_{f in slice} X[n, f] dv[p, f], dv in registers.
//   * Exchange: the same reduce-scatter through distributed shared memory
//     in rank order, which adds dssum = g_b alpha (each CTA forms it, one
//     warp a rank, before the exchange); rank 0 then sums ds and s over n,
//     one warp a rank, in a fixed order, for this image's d_sal_b and its
//     d_attn_b = (sum_n s) g_b^T.
//   * Phase 2: d_sal_w's partial X^T ds over the slice (as v in the
//     forward: row classes meet in shared memory in class order), then
//     dx[n, f] = sum_p s[p, n] dv[p, f] + ds[p, n] sal_w[f, p], which reads
//     no X, written once in X's dtype with 16-byte stores.
//   * Each image writes its d_sal_w (F, P), d_sal_b (P) and d_attn_b (C, P)
//     to a (B, F P + P + C P) scratch; the wrapper sums it over B with one
//     sum(0), with no atomics.
//
// Like the forward kernels it takes f32 X or bf16 X (upcast in the load),
// accumulates in f32 on the CUDA cores, launches on the caller's stream
// through cudaLaunchKernelEx, allocates nothing and returns the launch's
// cudaError_t.  Every sum runs in an order fixed by the plan, so two
// launches give identical bits.

#include "attn_pool_common.cuh"

namespace {

// -- pool_backward ---------------------------------------------------------------

// x (B, N, F); dv (B, P, F); s (B, P, N); cot (B, C), the logits'
// cotangent g; attn_b (C, P);
// sal_w (F, P); dx (B, N, F) out, in X's dtype; red (B, F P + P + C P)
// out: each image's d_sal_w (F, P), d_sal_b (P) and d_attn_b (C, P).
// Grid, clusters, slices and J as the saliency kernel's; r2: row classes
// of phase 2's d_sal_w.
template <typename T, int P, int J, bool RESIDENT>
__global__ void __launch_bounds__(APA_SAL_THREADS)
pool_backward_kernel(const T* __restrict__ x, const float* __restrict__ dv,
                     const float* __restrict__ s,
                     const float* __restrict__ cot,
                     const float* __restrict__ attn_b,
                     const float* __restrict__ sal_w, T* __restrict__ dx,
                     float* __restrict__ red, int N, int F, int C, int fs,
                     int r2) {
  constexpr int VEC = Vec<T>::kN;
  constexpr int ROWS = J == 4 ? 4 : 8;
  constexpr int ROWS2 = 8;
  constexpr int NWARPS = APA_SAL_THREADS / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int f_lo = rank * fs;
  const int G = fs / VEC;  // 16-byte column groups in the slice
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int PN = P * N;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float dssum[P];  // g_b alpha
  T* xs = reinterpret_cast<T*>(smem);  // (N, fs)
  float* part = reinterpret_cast<float*>(
      smem + (RESIDENT ? align16((size_t)N * fs * sizeof(T)) : 0));  // (P, N)
  float* dsf = part + PN;  // ds, summed over the cluster (P, N)
  float* ss = dsf + PN;    // s (P, N)
  float* vred = part + align16((size_t)3 * PN * sizeof(float)) / 4;

  const T* xb = x + (size_t)b * N * F + f_lo;
  const float* dvb = dv + (size_t)b * P * F;
  const float* gb = cot + (size_t)b * C;
  float* redb = red + (size_t)b * (F * P + P + C * P);
  auto load_global = [&](int n, int g) -> uint4 {
    return g < G ? load16(xb + (size_t)n * F + g * VEC) : make_uint4(0, 0, 0, 0);
  };

  for (int i = tid; i < PN; i += APA_SAL_THREADS) ss[i] = s[(size_t)b * PN + i];
  // dssum[p] = sum_c g[b, c] alpha[c, p], warp p, the same bits in every CTA
  if (warp < P) {
    float a = 0.f;
    for (int c = lane; c < C; c += 32) a = fmaf(gb[c], attn_b[c * P + warp], a);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) dssum[warp] = a;
  }

  // This lane's dv columns, in registers.
  float w[P][J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int g = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int f = f_lo + g * VEC + e;
#pragma unroll
      for (int p = 0; p < P; ++p) w[p][j][e] = g < G ? dvb[(size_t)p * F + f] : 0.f;
    }
  }

  // Phase 1: the slice's partial ds[p, n] = sum_f x[n, f] dv[p, f], a row
  // reduced over its warp by shuffles; X kept where resident.
  auto row_partial = [&](const uint4* raw, int n) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float xv[VEC];
      Vec<T>::unpack(raw[j], xv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[p] = fmaf(xv[e], w[p][j][e], acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) part[p * N + n] = acc[p];
    }
  };
  auto keep = [&](const uint4* raw, int n) {
    if (RESIDENT) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int g = lane + 32 * j;
        if (g < G) *reinterpret_cast<uint4*>(xs + (size_t)n * fs + g * VEC) = raw[j];
      }
    }
  };
  const int full = N / ROWS * ROWS;
  for (int n0 = ROWS * warp; n0 < full; n0 += ROWS * NWARPS) {
    uint4 raw[ROWS][J];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int j = 0; j < J; ++j) raw[u][j] = load_global(n0 + u, lane + 32 * j);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      keep(raw[u], n0 + u);
      row_partial(raw[u], n0 + u);
    }
  }
  for (int n = full + warp; n < N; n += NWARPS) {
    uint4 raw[J];
#pragma unroll
    for (int j = 0; j < J; ++j) raw[j] = load_global(n, lane + 32 * j);
    keep(raw, n);
    row_partial(raw, n);
  }

  // Exchange, the saliency kernel's reduce-scatter: CTA r sums its share
  // of the (P, N) partials over the S CTAs in rank order, adds dssum and
  // stores the share into every CTA's ds.
  cluster.sync();
  const int per = (PN + S - 1) / S;
  const int hi = min(PN, (rank + 1) * per);
  for (int i = rank * per + tid; i < hi; i += APA_SAL_THREADS) {
    float t[APA_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < APA_MAX_CLUSTER; ++q) {
      t[q] = q < S ? *cluster.map_shared_rank(part + i, q) : 0.f;
    }
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < APA_MAX_CLUSTER; ++q) a += t[q];
    a += dssum[i / N];
#pragma unroll
    for (int q = 0; q < APA_MAX_CLUSTER; ++q) {
      if (q < S) *cluster.map_shared_rank(dsf + i, q) = a;
    }
  }
  cluster.sync();

  // This image's d_sal_b[p] = sum_n ds[p, n] and d_attn_b[c, p] =
  // (sum_n s[p, n]) g[b, c], warp p of rank 0.
  if (rank == 0 && warp < P) {
    float a = 0.f, ssum = 0.f;
    for (int n = lane; n < N; n += 32) {
      a += dsf[warp * N + n];
      ssum += ss[warp * N + n];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      ssum += __shfl_xor_sync(0xffffffffu, ssum, off);
    }
    if (lane == 0) redb[F * P + warp] = a;
    for (int c = lane; c < C; c += 32) redb[F * P + P + c * P + warp] = ssum * gb[c];
  }

  // Phase 2, d_sal_w: dsw[f, p] = sum_n ds[p, n] x[n, f] over the slice;
  // thread (g, r) takes column group g and rows n = r + r2 i.
  if (tid < r2 * G) {
    const int g = tid % G;
    const int r = tid / G;
    float acc[P][VEC];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[p][e] = 0.f;
    }
    auto accumulate = [&](const uint4& raw, int n) {
      float xv[VEC];
      Vec<T>::unpack(raw, xv);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float dsv = dsf[p * N + n];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[p][e] = fmaf(dsv, xv[e], acc[p][e]);
      }
    };
    const int rows = (N - r + r2 - 1) / r2;
    int i = 0;
    auto load_x = [&](int n) -> uint4 {
      return RESIDENT ? load16(xs + (size_t)n * fs + g * VEC)
                      : load16(xb + (size_t)n * F + g * VEC);
    };
    for (; i + ROWS2 <= rows; i += ROWS2) {
      uint4 raw[ROWS2];
#pragma unroll
      for (int u = 0; u < ROWS2; ++u) raw[u] = load_x(r + r2 * (i + u));
#pragma unroll
      for (int u = 0; u < ROWS2; ++u) accumulate(raw[u], r + r2 * (i + u));
    }
    for (; i < rows; ++i) accumulate(load_x(r + r2 * i), r + r2 * i);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (r2 > 1) {
        float* out = vred + ((size_t)r * P + p) * fs + g * VEC;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          *reinterpret_cast<float4*>(out + e) = make_float4(
              acc[p][e], acc[p][e + 1], acc[p][e + 2], acc[p][e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) redb[(size_t)(f_lo + g * VEC + e) * P + p] = acc[p][e];
      }
    }
  }

  // Phase 2, dx[n, f] = sum_p s[p, n] dv[p, f] + sum_p ds[p, n] sal_w[f, p]
  // (no X): thread (g, r) takes column group g and rows n = r + R i, every
  // thread of the CTA at work; one 16-byte store a row.
  {
    const int R = APA_SAL_THREADS / G;
    if (tid < R * G) {
      const int g = tid % G;
      const int r = tid / G;
      const int f0 = f_lo + g * VEC;
      float dvr[P][VEC], swr[P][VEC];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          dvr[p][e] = dvb[(size_t)p * F + f0 + e];
          swr[p][e] = sal_w[(size_t)(f0 + e) * P + p];
        }
      }
      T* dxb = dx + (size_t)b * N * F + f0;
#pragma unroll 4
      for (int n = r; n < N; n += R) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float a1 = 0.f, a2 = 0.f;
#pragma unroll
          for (int p = 0; p < P; ++p) {
            a1 = fmaf(ss[p * N + n], dvr[p][e], a1);
            a2 = fmaf(dsf[p * N + n], swr[p][e], a2);
          }
          o[e] = a1 + a2;
        }
        *reinterpret_cast<uint4*>(dxb + (size_t)n * F) = Vec<T>::pack(o);
      }
    }
  }

  if (r2 > 1) {
    __syncthreads();
    for (int i = tid; i < P * fs; i += APA_SAL_THREADS) {
      float a = 0.f;
      for (int r = 0; r < r2; ++r) a += vred[(size_t)r * P * fs + i];
      const int p = i / fs;
      redb[(size_t)(f_lo + i - p * fs) * P + p] = a;
    }
  }
}

// -- launch ----------------------------------------------------------------------

struct BackwardLaunch {
  const void* x;
  const float *dv, *s, *cot, *attn_b, *sal_w;
  void* dx;
  float* red;
  int B, N, F, C, S, r2;
  bool resident;
  size_t smem;
  cudaStream_t st;

  template <typename T, int P, int J>
  cudaError_t run() const {
    auto kernel = resident ? &pool_backward_kernel<T, P, J, true>
                           : &pool_backward_kernel<T, P, J, false>;
    return launch_clustered(kernel, B * S, 1, APA_SAL_THREADS, S, smem, st,
                            static_cast<const T*>(x), dv, s, cot, attn_b,
                            sal_w, static_cast<T*>(dx), red, N, F, C, F / S,
                            r2);
  }
};

}  // namespace

extern "C" {

// The pass over X of the head's backward: dv (B, P, F) = g A from the
// caller, s (B, P, N) saved by the forward, the cotangent g (B, C),
// attn_b (C, P) and sal_w (F, P); dx (B, N, F) in x's dtype and red
// (B, F P + P + C P) out.  (cluster, r2, resident, smem) is the launch plan
// of ops/attn_pool_cuda.py:backward_plan.
int apb_pool_backward(const void* x, int x_dtype, const float* dv,
                      const float* s, const float* g, const float* attn_b,
                      const float* sal_w, void* dx, float* red, int B, int N,
                      int F, int C, int P, int cluster, int r2, int resident,
                      long long smem, void* stream) {
  if (C < 1 || !valid_cluster_plan(x_dtype, B, N, F, P, cluster, r2,
                                   resident, smem, 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const BackwardLaunch l{x, dv, s, g, attn_b, sal_w, dx, red, B, N, F, C,
                         cluster, r2, resident != 0, (size_t)smem,
                         static_cast<cudaStream_t>(stream)};
  return (int)with_dtype(x_dtype, P, F / cluster, l);
}

int apb_last_active_clusters() { return g_last_active_clusters; }

const char* apb_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
