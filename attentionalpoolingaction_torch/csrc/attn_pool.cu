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
// What bounds them on the H100: bytes.  Per image the summary does ~4 N F P
// flops on N F elements of X (at most 8 flops a byte in f32 at P=8) and
// the projection 2 B flops on each 4-byte element of A (16 at B=32); the
// card's f32 balance point is ~20 flops a byte (67 TFLOP/s over 3.35 TB/s).
// Measured on the H100, what holds them further from that bound is what an
// SM can pull at once (~15-20 GB/s an SM from plain 16-byte loads with 8
// rows a warp in flight) and the fixed cost of a cluster barrier or a
// remote round trip (~1,000 cycles each).  So each kernel reads X or A
// from HBM once, spreads that read over many SMs and keeps barriers few.
// The launch plans are computed in Python (ops/attn_pool_cuda.py:
// saliency_plan, project_plan) and checked here against the kernels'
// shared-memory layouts.  The head's backward is attn_pool_backward.cu,
// which shares this file's helpers (attn_pool_common.cuh) and builds beside
// it.
//
// saliency_summary: one image over a thread-block cluster of S CTAs
// (S in 1, 2, 4, 8, 16; 16 is non-portable), each owning F / S columns.
//   * Phase 1: a warp takes 8 rows at a time (4 where a lane owns 4 column
//     groups) and loads them from HBM; each lane owns fixed 16-byte column
//     groups of the slice and holds their sal_w values in registers; each
//     row's partial s is reduced by warp shuffles.
//   * Resident path: phase 1 also stores the rows into shared memory, so X
//     is read from HBM once and phase 2 reads the slice there.  The plan
//     keeps a resident CTA within half an SM's shared memory (two CTAs an
//     SM) with room for 4 phase-2 row classes.  Where no S gives that, the
//     L2 re-read path runs instead: phase 2 reads the slice again, from
//     L2.  At F = 2048 that is f32 X from N = 218 at rank 1 and N = 191
//     at rank 5 (so hmdb51_clip8's 392 positions and rank-5 HICO at 448 px,
//     N = 196), and bf16 X from N = 429 at rank 1 and N = 355 at rank 5.
//   * Exchange, a reduce-scatter through distributed shared memory: after a
//     cluster barrier, CTA r sums its share of the (P, N) partials over the
//     S CTAs in rank order 0..S-1, adds sal_b, writes that share of s and
//     stores it into every CTA's copy.  A second cluster barrier follows;
//     after it no CTA touches another's shared memory, so it is the last
//     barrier any CTA needs before it exits.
//   * Phase 2: thread (g, r) owns column group g and rows n = r + r2 i; the
//     r2 row classes meet in shared memory, summed in class order.
//
// project_logits: (B, K) x (K, C) with K = P F, plus ssum attn_b^T.
//   * Grid (KS, ceil(C / 32)), clusters of KS CTAs along K (KS up to 16,
//     the largest that leaves every CTA rows).  A CTA owns 32 classes, one
//     a lane, and kr rows of K, and reads its part of A from HBM once:
//       - where B fits one tile of BT images (BT up to 32), A streams into
//         registers, coalesced over classes, 8 stages of 4 rows a warp in
//         flight;
//       - where B needs several tiles, the slab comes into shared memory
//         once by 16-byte cp.async (each row's 16-byte aligned window: rows
//         of A at C = 393 are not 16-byte aligned) and serves every tile.
//   * The tile's v rows for the CTA's K range sit in shared memory; each
//     thread keeps a BT-long accumulator for its class; the 8 warps, which
//     split the K range, meet in shared memory in warp order.
//   * The KS partials of a tile are summed through distributed shared
//     memory, in rank order 0..KS-1, with no float atomics: four outputs by
//     one thread of the cluster, which then adds ssum attn_b^T once.
//
// Both take f32 X or bf16 X (upcast in the load), accumulate in f32 on
// the CUDA cores, launch on the caller's stream through cudaLaunchKernelEx,
// allocate nothing and return the launch's cudaError_t.  Every sum runs in
// an order fixed by the plan, so two launches give identical bits.

#include "attn_pool_common.cuh"

#define APA_PROJ_THREADS 256
#define APA_PROJ_WARPS (APA_PROJ_THREADS / 32)
#define APA_PROJ_COLS 32           // classes a CTA owns, one a lane
#define APA_PROJ_STAGE 32          // rows of A a stage: 4 a warp
#define APA_PROJ_AROW 36           // floats a row of A in shared memory: 32 + shift
#define APA_PROJ_DEPTH 4           // stages of A in flight a warp, streamed

namespace {

// -- PTX helpers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Wait until all of this thread's cp.asyncs have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- saliency_summary ------------------------------------------------------------

// x (B, N, F); sal_w (F, P); sal_b (P); v (B, P, F) out; s (B, P, N) out.
// Grid B * S CTAs in clusters of S along F; CTA rank r owns columns
// [r fs, (r + 1) fs).  J: 16-byte column groups a lane owns, the fewest of
// 1, 2, 4 that cover the slice.  r2: row classes of phase 2.
template <typename T, int P, int J, bool RESIDENT>
__global__ void __launch_bounds__(APA_SAL_THREADS)
saliency_summary_kernel(const T* __restrict__ x,
                        const float* __restrict__ sal_w,
                        const float* __restrict__ sal_b,
                        float* __restrict__ v, float* __restrict__ s, int N,
                        int F, int fs, int r2) {
  constexpr int VEC = Vec<T>::kN;
  // rows in flight a warp in phase 1 (32 J 16-byte loads) and a thread in
  // phase 2
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

  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // (N, fs)
  float* part = reinterpret_cast<float*>(
      smem + (RESIDENT ? align16((size_t)N * fs * sizeof(T)) : 0));  // (P, N)
  float* sfull = part + P * N;                                       // (P, N)
  float* vred = part + align16((size_t)2 * P * N * sizeof(float)) / 4;

  const T* xb = x + (size_t)b * N * F + f_lo;
  auto load_global = [&](int n, int g) -> uint4 {
    return g < G ? load16(xb + (size_t)n * F + g * VEC) : make_uint4(0, 0, 0, 0);
  };

  // This lane's sal_w columns, in registers.
  float w[P][J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int g = lane + 32 * j;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int f = f_lo + g * VEC + e;
#pragma unroll
      for (int p = 0; p < P; ++p) w[p][j][e] = g < G ? sal_w[f * P + p] : 0.f;
    }
  }

  // Phase 1: the slice's partial s[p, n] = sum_f x[n, f] sal_w[f, p], a row
  // reduced over its warp by shuffles.
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
  // Rows come from HBM, ROWS a warp in flight; the resident path keeps them
  // in shared memory for phase 2.
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

  // Exchange, as a reduce-scatter: CTA r sums its share of the (P, N)
  // partials over the S CTAs in rank order, adds sal_b, writes that share of
  // s and stores it into every CTA's copy of s.  After the second barrier
  // no CTA touches another's shared memory, so any CTA may leave.
  cluster.sync();
  const int PN = P * N;
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
    a += sal_b[i / N];
    s[(size_t)b * PN + i] = a;
#pragma unroll
    for (int q = 0; q < APA_MAX_CLUSTER; ++q) {
      if (q < S) *cluster.map_shared_rank(sfull + i, q) = a;
    }
  }
  cluster.sync();

  // Phase 2: v[p, f] = sum_n s[p, n] x[n, f] over the slice's columns;
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
        const float sv = sfull[p * N + n];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[p][e] = fmaf(sv, xv[e], acc[p][e]);
      }
    };
    const int rows = (N - r + r2 - 1) / r2;
    int i = 0;
    // X from shared memory (resident) or again from L2
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
      float* out = r2 > 1 ? vred + ((size_t)r * P + p) * fs + g * VEC
                          : v + ((size_t)b * P + p) * F + f_lo + g * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(out + e) = make_float4(
            acc[p][e], acc[p][e + 1], acc[p][e + 2], acc[p][e + 3]);
      }
    }
  }
  if (r2 > 1) {
    __syncthreads();
    for (int i = tid; i < P * fs; i += APA_SAL_THREADS) {
      float a = 0.f;
      for (int r = 0; r < r2; ++r) a += vred[(size_t)r * P * fs + i];
      const int p = i / fs;
      v[((size_t)b * P + p) * F + f_lo + (i - p * fs)] = a;
    }
  }
}

// -- project_logits --------------------------------------------------------------

// Shared memory of a projection CTA, in floats: the CTA's slab of A,
// (kr, APA_PROJ_AROW), where it stays resident | v rows (bt, kr) |
// per-warp partials (warps, bt, 32) | CTA partial (bt, 32) | ssum (bt, P)
// | attn_b of the tile (32, P).
__host__ __device__ inline size_t project_smem_bytes(int kr, int bt, int P,
                                                     bool a_resident) {
  return ((a_resident ? (size_t)kr * APA_PROJ_AROW : 0) + (size_t)bt * kr +
          (size_t)APA_PROJ_WARPS * bt * APA_PROJ_COLS +
          (size_t)bt * APA_PROJ_COLS + (size_t)bt * P +
          (size_t)APA_PROJ_COLS * P) *
         sizeof(float);
}

// v (B, K); s (B, P, N); w (K, C) = w_pfc (P, F, C); attn_b (C, P);
// logits (B, C).  Grid (KS, ceil(C / 32)) in clusters of KS along K; CTA
// rank r owns rows [r kr, (r + 1) kr) of K (kr a multiple of 32), block y
// classes [32 y, 32 y + 32).  Warp w takes rows 4 w .. 4 w + 3 of every
// stage of 32 rows.  Where B fits one tile of BT images, A streams from
// HBM into registers, APA_PROJ_DEPTH stages a warp in flight; otherwise
// (a_resident) the CTA's slab of A comes into shared memory once and
// serves every tile.
template <int BT>
__global__ void __launch_bounds__(APA_PROJ_THREADS)
project_logits_kernel(const float* __restrict__ v,
                      const float* __restrict__ s,
                      const float* __restrict__ w,
                      const float* __restrict__ attn_b,
                      float* __restrict__ logits, int B, int N, int K, int C,
                      int P, int kr, bool a_resident) {
  constexpr int CHUNKS = APA_PROJ_AROW / 4;  // 16-byte copies a row of A
  constexpr int GROUPS = APA_PROJ_COLS / 4;  // float4 outputs an image
  constexpr int DEPTH = APA_PROJ_DEPTH;
  cg::cluster_group cluster = cg::this_cluster();
  const int KS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.y * APA_PROJ_COLS;
  const int k0 = rank * kr;
  const int nk = max(0, min(kr, K - k0));  // a multiple of 4, as K and kr are
  const int nst = kr / APA_PROJ_STAGE;

  extern __shared__ __align__(128) float psm[];
  float* a_s = psm;                                 // (kr, AROW)
  float* v_s = a_s + (a_resident ? (size_t)kr * APA_PROJ_AROW : 0);  // (BT, kr)
  float* red = v_s + (size_t)BT * kr;                 // (warps, BT, 32)
  float* part = red + APA_PROJ_WARPS * BT * APA_PROJ_COLS;  // (BT, 32)
  float* ssum = part + BT * APA_PROJ_COLS;                  // (BT, P)
  float* ab_s = ssum + BT * P;                              // (32, P)

  // The slab of A.  Row k's classes [c0, c0 + 32) start at element
  // e = (k0 + k) C + c0; the 16-byte chunks of the aligned window of AROW
  // floats from e & ~3 that hold them are copied, and the row is read at
  // offset e & 3.  Rows past the CTA's range, and chunks past the tile's
  // last class, are zeros.
  const size_t total = (size_t)K * C;
  const int cols = min(APA_PROJ_COLS, C - c0);
  auto issue_slab = [&]() {
    for (int i = tid; i < kr * CHUNKS; i += APA_PROJ_THREADS) {
      const int k = i / CHUNKS;
      const int j = i - k * CHUNKS;
      const size_t e = (size_t)(k0 + k) * C + c0;
      const size_t src = ((e >> 2) << 2) + 4 * j;
      const bool in = k < nk && src < e + cols && src < total;
      cp_async16(a_s + k * APA_PROJ_AROW + 4 * j, in ? w + src : w,
                 in ? 16u : 0u);
    }
  };
  // The tile's v rows over the CTA's K range; zeros past B and past K.
  auto issue_v = [&](int b0, int nb) {
    const int q_row = kr / 4;
    for (int i = tid; i < BT * q_row; i += APA_PROJ_THREADS) {
      const int bi = i / q_row;
      const int q = i - bi * q_row;
      const bool in = bi < nb && 4 * q < nk;
      cp_async16(v_s + bi * kr + 4 * q,
                 in ? v + (size_t)(b0 + bi) * K + k0 + 4 * q : v,
                 in ? 16u : 0u);
    }
  };

  issue_v(0, min(BT, B));
  if (a_resident) issue_slab();
  for (int i = tid; i < APA_PROJ_COLS * P; i += APA_PROJ_THREADS) {
    const int c = c0 + i / P;
    ab_s[i] = c < C ? attn_b[(size_t)c0 * P + i] : 0.f;
  }
  const int c_mod4 = C & 3;

  for (int b0 = 0; b0 < B; b0 += BT) {
    const int nb = min(BT, B - b0);
    if (b0 > 0) issue_v(b0, nb);
    // sum_n s[b, p, n] of the tile, four (image, rank) pairs a warp at once
    for (int i0 = warp; i0 < nb * P; i0 += 4 * APA_PROJ_WARPS) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = lane; n < N; n += 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * APA_PROJ_WARPS;
          a[u] += i < nb * P ? s[((size_t)b0 * P + i) * N + n] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          a[u] += __shfl_xor_sync(0xffffffffu, a[u], off);
        }
        const int i = i0 + u * APA_PROJ_WARPS;
        if (lane == 0 && i < nb * P) ssum[i] = a[u];
      }
    }
    cp_async_wait_all();
    __syncthreads();  // v rows (and the slab) have landed for every thread

    float acc[BT];
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) acc[bi] = 0.f;
    // rows k .. k + 3 of A, one class a lane, into the accumulators
    auto fma_rows = [&](const float* a, int k) {
#pragma unroll
      for (int bi = 0; bi < BT; ++bi) {
        const float4 x4 = *reinterpret_cast<const float4*>(v_s + bi * kr + k);
        float t = acc[bi];
        t = fmaf(x4.x, a[0], t);
        t = fmaf(x4.y, a[1], t);
        t = fmaf(x4.z, a[2], t);
        acc[bi] = fmaf(x4.w, a[3], t);
      }
    };
    if (a_resident) {
      for (int k = 4 * warp; k < kr; k += APA_PROJ_STAGE) {
        float a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int shift = ((k0 + k + u) * c_mod4 + c0) & 3;
          a[u] = a_s[(k + u) * APA_PROJ_AROW + shift + lane];
        }
        fma_rows(a, k);
      }
    } else {
      const bool col = lane < cols;
      for (int st0 = 0; st0 < nst; st0 += DEPTH) {
        float a[DEPTH][4];
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int k = (st0 + d) * APA_PROJ_STAGE + 4 * warp + u;
            a[d][u] = col && k < nk ? w[(size_t)(k0 + k) * C + c0 + lane] : 0.f;
          }
        }
#pragma unroll
        for (int d = 0; d < DEPTH; ++d) {
          if (st0 + d < nst) fma_rows(a[d], (st0 + d) * APA_PROJ_STAGE + 4 * warp);
        }
      }
    }
#pragma unroll
    for (int bi = 0; bi < BT; ++bi) {
      red[(warp * BT + bi) * APA_PROJ_COLS + lane] = acc[bi];
    }
    __syncthreads();
    for (int o = tid; o < nb * APA_PROJ_COLS; o += APA_PROJ_THREADS) {
      const int bi = o / APA_PROJ_COLS;
      const int l = o - bi * APA_PROJ_COLS;
      float a = 0.f;
#pragma unroll
      for (int wi = 0; wi < APA_PROJ_WARPS; ++wi) {
        a += red[(wi * BT + bi) * APA_PROJ_COLS + l];
      }
      part[o] = a;
    }

    // The cluster's KS partials, summed in rank order: four outputs by one
    // thread of CTA (group % KS), which adds ssum attn_b^T once.
    cluster.sync();
    for (int g = rank + KS * tid; g < nb * GROUPS; g += KS * APA_PROJ_THREADS) {
      float4 t[APA_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < APA_MAX_CLUSTER; ++q) {
        t[q] = q < KS ? *reinterpret_cast<const float4*>(
                            cluster.map_shared_rank(part + 4 * g, q))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < APA_MAX_CLUSTER; ++q) {
        o4[0] += t[q].x;
        o4[1] += t[q].y;
        o4[2] += t[q].z;
        o4[3] += t[q].w;
      }
      const int bi = g / GROUPS;
      const int l0 = 4 * (g - bi * GROUPS);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + l0 + e;
        float a = o4[e];
        for (int p = 0; p < P; ++p) {
          a = fmaf(ssum[bi * P + p], ab_s[(l0 + e) * P + p], a);
        }
        if (c < C) logits[(size_t)(b0 + bi) * C + c] = a;
      }
    }
    cluster.sync();  // `part` and the tile's buffers are free again
  }
}

// -- launches ---------------------------------------------------------------------

struct SaliencyLaunch {
  const void* x;
  const float *sal_w, *sal_b;
  float *v, *s;
  int B, N, F, S, r2;
  bool resident;
  size_t smem;
  cudaStream_t st;

  template <typename T, int P, int J>
  cudaError_t run() const {
    const T* xt = static_cast<const T*>(x);
    auto kernel = resident ? &saliency_summary_kernel<T, P, J, true>
                           : &saliency_summary_kernel<T, P, J, false>;
    return launch_clustered(kernel, B * S, 1, APA_SAL_THREADS, S, smem, st,
                            xt, sal_w, sal_b, v, s, N, F, F / S, r2);
  }
};

}  // namespace

extern "C" {

// x_dtype: 0 = float32, 1 = bfloat16.  (cluster, r2, resident, smem) is
// the launch plan of ops/attn_pool_cuda.py:saliency_plan.
int apa_saliency_summary(const void* x, int x_dtype, const float* sal_w,
                         const float* sal_b, float* v, float* s, int B,
                         int N, int F, int P, int cluster, int r2,
                         int resident, long long smem, void* stream) {
  if (!valid_cluster_plan(x_dtype, B, N, F, P, cluster, r2, resident, smem,
                          2)) {
    return (int)cudaErrorInvalidValue;
  }
  const SaliencyLaunch l{x, sal_w, sal_b, v, s, B, N, F, cluster, r2,
                         resident != 0, (size_t)smem,
                         static_cast<cudaStream_t>(stream)};
  return (int)with_dtype(x_dtype, P, F / cluster, l);
}

// (k_split, k_rows, b_tile, a_resident, smem) is the launch plan of
// ops/attn_pool_cuda.py:project_plan.
int apa_project_logits(const float* v, const float* s, const float* w_pfc,
                       const float* attn_b, float* logits, int B, int N,
                       int F, int C, int P, int k_split, int k_rows,
                       int b_tile, int a_resident, long long smem,
                       void* stream) {
  const int K = P * F;
  if (P < 1 || P > APA_MAX_RANK || F % 8 != 0 || !valid_cluster(k_split) ||
      k_rows < APA_PROJ_STAGE || k_rows % APA_PROJ_STAGE != 0 ||
      (long long)k_rows * k_split < K || B < 1 || N < 1 ||
      (B > b_tile && !a_resident) ||
      (size_t)smem != project_smem_bytes(k_rows, b_tile, P, a_resident != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (C + APA_PROJ_COLS - 1) / APA_PROJ_COLS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define APA_PROJ_CASE(BT)                                                   \
  case BT:                                                                  \
    return (int)launch_clustered(project_logits_kernel<BT>, k_split, tiles, \
                                 APA_PROJ_THREADS, k_split, (size_t)smem,   \
                                 st, v, s, w_pfc, attn_b, logits, B, N, K,  \
                                 C, P, k_rows, a_resident != 0);
  switch (b_tile) {
    APA_PROJ_CASE(1)
    APA_PROJ_CASE(2)
    APA_PROJ_CASE(4)
    APA_PROJ_CASE(8)
    APA_PROJ_CASE(16)
    APA_PROJ_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef APA_PROJ_CASE
}

int apa_last_active_clusters() { return g_last_active_clusters; }

const char* apa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

