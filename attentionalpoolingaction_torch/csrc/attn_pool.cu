// Attentional pooling kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:
//   * _fused_pool_kernel (saliency_summary):   s = X sal_w + sal_b, v = s^T X
//   * _fused_pool_logits_kernel (fused_pool_logits): the same, then
//       logits = sum_p v_p A_p + (sum_n s_pn) alpha_p^T
// Here fused_pool_logits is apa_saliency_summary followed by
// apa_project_logits: the TPU kernel kept A resident in VMEM, which has no
// counterpart on an SM (A at C=393 is 3.2 MB, at C=600 4.9 MB).
//
// What bounds them on the H100: bytes.  Per image the work is ~4 N F P
// flops on N F elements of X (2P flops a byte in f32), far below the
// card's balance point.  At the serving shape (B=32, N=49, F=2048, C=393,
// P=1, f32) X is 12.8 MB and A 3.2 MB: ~5 us at 3.35 TB/s.
//
// Design (right and simple first):
//   saliency_summary: one block per image, templated on the rank P.
//     sal_w is staged in shared memory as (P, F).  Phase 1: each warp takes
//     positions n and reduces over F with 16-byte loads (APA_UNROLL of them
//     in flight a lane) and warp shuffles; s goes to shared memory and to
//     the output.  Phase 2: threads own 16-byte column groups of F and loop
//     over n, APA_UNROLL rows in flight, to accumulate v; that second read
//     of X (400 KB an image at 224 px) is served by the 50 MB L2.  One
//     block per image leaves most SMs idle at small B.
//   project_logits: a block owns 32 classes (one a lane) and a tile of
//     APA_PROJ_BT images; its 32 warps split F, each with APA_UNROLL rows
//     of A in flight, and meet in shared memory.  A is read as (P, F, C),
//     coalesced over c; the v rows of the tile sit in shared memory.  Each
//     A element is read ceil(B / BT) times, from L2 after the first.
//
// Both take f32 X or bf16 X (upcast in the load), accumulate in f32,
// launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define APA_MAX_RANK 8
#define APA_SAL_THREADS 512
#define APA_PROJ_WARPS 32
#define APA_PROJ_BT 4
#define APA_UNROLL 8

namespace {

// 16-byte vector loads of X: raw() issues the load, unpack() upcasts.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static uint4 raw(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static uint4 raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// x (B, N, F); sal_w (F, P); sal_b (P); v (B, P, F) out; s (B, P, N) out.
// Dynamic shared memory: (P * F + P * N) floats.  F % 8 == 0.
template <typename T, int P>
__global__ void __launch_bounds__(APA_SAL_THREADS)
saliency_summary_kernel(const T* __restrict__ x,
                        const float* __restrict__ sal_w,
                        const float* __restrict__ sal_b,
                        float* __restrict__ v, float* __restrict__ s, int N,
                        int F) {
  constexpr int VEC = Vec<T>::kN;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // (P, F)
  float* s_s = w_s + P * F;                      // (P, N)

  const int b = blockIdx.x;
  const T* xb = x + (size_t)b * N * F;
  for (int i = threadIdx.x; i < F * P; i += blockDim.x) {
    const int f = i / P;
    w_s[(i - f * P) * F + f] = sal_w[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // Phase 1: s[p, n] = sum_f x[n, f] sal_w[f, p] + sal_b[p].
  for (int n = warp; n < N; n += nwarps) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    const T* row = xb + (size_t)n * F;
    for (int f0 = lane * VEC; f0 < F; f0 += 32 * VEC * APA_UNROLL) {
      uint4 raw[APA_UNROLL];
#pragma unroll
      for (int u = 0; u < APA_UNROLL; ++u) {
        const int f = f0 + u * 32 * VEC;
        if (f < F) raw[u] = Vec<T>::raw(row + f);
      }
#pragma unroll
      for (int u = 0; u < APA_UNROLL; ++u) {
        const int f = f0 + u * 32 * VEC;
        if (f < F) {
          float xv[VEC];
          Vec<T>::unpack(raw[u], xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int j = 0; j < VEC; j += 4) {
              const float4 w =
                  *reinterpret_cast<const float4*>(w_s + p * F + f + j);
              acc[p] = fmaf(xv[j], w.x, acc[p]);
              acc[p] = fmaf(xv[j + 1], w.y, acc[p]);
              acc[p] = fmaf(xv[j + 2], w.z, acc[p]);
              acc[p] = fmaf(xv[j + 3], w.w, acc[p]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float a = acc[p];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
      }
      if (lane == 0) {
        a += sal_b[p];
        s_s[p * N + n] = a;
        s[((size_t)b * P + p) * N + n] = a;
      }
    }
  }
  __syncthreads();

  // Phase 2: v[p, f] = sum_n s[p, n] x[n, f]; X comes from L2 this time.
  for (int f0 = threadIdx.x * VEC; f0 < F; f0 += blockDim.x * VEC) {
    float acc[P][VEC];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[p][j] = 0.f;
    }
    for (int n0 = 0; n0 < N; n0 += APA_UNROLL) {
      uint4 raw[APA_UNROLL];
#pragma unroll
      for (int u = 0; u < APA_UNROLL; ++u) {
        if (n0 + u < N) raw[u] = Vec<T>::raw(xb + (size_t)(n0 + u) * F + f0);
      }
#pragma unroll
      for (int u = 0; u < APA_UNROLL; ++u) {
        if (n0 + u < N) {
          float xv[VEC];
          Vec<T>::unpack(raw[u], xv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const float sv = s_s[p * N + n0 + u];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              acc[p][j] = fmaf(sv, xv[j], acc[p][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float4* out =
          reinterpret_cast<float4*>(v + ((size_t)b * P + p) * F + f0);
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) {
        out[j] = make_float4(acc[p][4 * j], acc[p][4 * j + 1],
                             acc[p][4 * j + 2], acc[p][4 * j + 3]);
      }
    }
  }
}

// v (B, P, F); s (B, P, N); w_pfc (P, F, C); attn_b (C, P); logits (B, C).
// Grid: (ceil(C / 32), ceil(B / APA_PROJ_BT)); block: 32 * APA_PROJ_WARPS.
// Dynamic shared memory: APA_PROJ_BT * APA_MAX_RANK + proj_tile_floats(F)
// floats, laid out as
//   ssum (APA_PROJ_BT, APA_MAX_RANK) | tile
// where the tile holds the v rows (APA_PROJ_BT, F) of one rank and, after
// the last rank, the per-warp partial logits (APA_PROJ_WARPS,
// APA_PROJ_BT, 32).
__host__ __device__ inline int proj_tile_floats(int F) {
  const int v_rows = APA_PROJ_BT * F;
  const int partials = APA_PROJ_WARPS * APA_PROJ_BT * 32;
  return v_rows > partials ? v_rows : partials;
}

__global__ void __launch_bounds__(32 * APA_PROJ_WARPS)
project_logits_kernel(const float* __restrict__ v,
                      const float* __restrict__ s,
                      const float* __restrict__ w_pfc,
                      const float* __restrict__ attn_b,
                      float* __restrict__ logits, int B, int N, int F, int C,
                      int P) {
  extern __shared__ float4 smem4[];
  float* ssum_s = reinterpret_cast<float*>(smem4);  // (BT, MAX_RANK)
  float* tile = ssum_s + APA_PROJ_BT * APA_MAX_RANK;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int b0 = blockIdx.y * APA_PROJ_BT;
  const int nb = min(APA_PROJ_BT, B - b0);

  // sum_n s[b, p, n] for the tile's images: one warp a (image, rank) pair
  for (int i = warp; i < APA_PROJ_BT * P; i += APA_PROJ_WARPS) {
    const int bi = i / P;
    const int p = i - bi * P;
    float a = 0.f;
    if (bi < nb) {
      const float* sr = s + ((size_t)(b0 + bi) * P + p) * N;
      for (int n = lane; n < N; n += 32) a += sr[n];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
    }
    if (lane == 0) ssum_s[bi * APA_MAX_RANK + p] = a;
  }

  float acc[APA_PROJ_BT];
#pragma unroll
  for (int bi = 0; bi < APA_PROJ_BT; ++bi) acc[bi] = 0.f;

  for (int p = 0; p < P; ++p) {
    __syncthreads();  // the previous rank's v rows are no longer read
    for (int i = threadIdx.x; i < APA_PROJ_BT * F; i += blockDim.x) {
      const int bi = i / F;
      const int f = i - bi * F;
      tile[i] = bi < nb ? v[((size_t)(b0 + bi) * P + p) * F + f] : 0.f;
    }
    __syncthreads();
    if (c < C) {
      const float* wp = w_pfc + (size_t)p * F * C + c;
      for (int f0 = warp; f0 < F; f0 += APA_PROJ_WARPS * APA_UNROLL) {
        float w[APA_UNROLL];
#pragma unroll
        for (int u = 0; u < APA_UNROLL; ++u) {
          const int f = f0 + u * APA_PROJ_WARPS;
          w[u] = f < F ? wp[(size_t)f * C] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < APA_UNROLL; ++u) {
          const int f = f0 + u * APA_PROJ_WARPS;
          if (f < F) {
#pragma unroll
            for (int bi = 0; bi < APA_PROJ_BT; ++bi) {
              acc[bi] = fmaf(tile[bi * F + f], w[u], acc[bi]);
            }
          }
        }
      }
    }
  }

  __syncthreads();  // the tile now takes the per-warp partial logits
#pragma unroll
  for (int bi = 0; bi < APA_PROJ_BT; ++bi) {
    tile[(warp * APA_PROJ_BT + bi) * 32 + lane] = acc[bi];
  }
  __syncthreads();

  if (threadIdx.x < APA_PROJ_BT * 32) {
    const int bi = threadIdx.x / 32;
    const int cc = blockIdx.x * 32 + lane;
    if (bi < nb && cc < C) {
      float a = 0.f;
      for (int w = 0; w < APA_PROJ_WARPS; ++w) {
        a += tile[(w * APA_PROJ_BT + bi) * 32 + lane];
      }
      for (int p = 0; p < P; ++p) {
        a = fmaf(ssum_s[bi * APA_MAX_RANK + p], attn_b[cc * P + p], a);
      }
      logits[(size_t)(b0 + bi) * C + cc] = a;
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int P>
cudaError_t launch_saliency(const void* x, const float* sal_w,
                            const float* sal_b, float* v, float* s, int B,
                            int N, int F, cudaStream_t stream) {
  const size_t smem = (size_t)(P * F + P * N) * sizeof(float);
  const cudaError_t e = allow_smem(saliency_summary_kernel<T, P>, smem);
  if (e != cudaSuccess) return e;
  saliency_summary_kernel<T, P><<<B, APA_SAL_THREADS, smem, stream>>>(
      static_cast<const T*>(x), sal_w, sal_b, v, s, N, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_saliency_rank(const void* x, const float* sal_w,
                                 const float* sal_b, float* v, float* s,
                                 int B, int N, int F, int P,
                                 cudaStream_t st) {
  switch (P) {
    case 1: return launch_saliency<T, 1>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 2: return launch_saliency<T, 2>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 3: return launch_saliency<T, 3>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 4: return launch_saliency<T, 4>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 5: return launch_saliency<T, 5>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 6: return launch_saliency<T, 6>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 7: return launch_saliency<T, 7>(x, sal_w, sal_b, v, s, B, N, F, st);
    case 8: return launch_saliency<T, 8>(x, sal_w, sal_b, v, s, B, N, F, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.
int apa_saliency_summary(const void* x, int x_dtype, const float* sal_w,
                         const float* sal_b, float* v, float* s, int B,
                         int N, int F, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    return (int)launch_saliency_rank<float>(x, sal_w, sal_b, v, s, B, N, F,
                                            P, st);
  }
  if (x_dtype == 1) {
    return (int)launch_saliency_rank<__nv_bfloat16>(x, sal_w, sal_b, v, s,
                                                    B, N, F, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

int apa_project_logits(const float* v, const float* s, const float* w_pfc,
                       const float* attn_b, float* logits, int B, int N,
                       int F, int C, int P, void* stream) {
  if (P < 1 || P > APA_MAX_RANK) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(APA_PROJ_BT * APA_MAX_RANK + proj_tile_floats(F)) *
      sizeof(float);
  const cudaError_t e = allow_smem(project_logits_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + 31) / 32, (B + APA_PROJ_BT - 1) / APA_PROJ_BT);
  project_logits_kernel<<<grid, 32 * APA_PROJ_WARPS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      v, s, w_pfc, attn_b, logits, B, N, F, C, P);
  return (int)cudaGetLastError();
}

const char* apa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
