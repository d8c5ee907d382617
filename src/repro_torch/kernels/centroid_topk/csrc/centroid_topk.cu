// Streaming centroid top-T for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/centroid_topk/centroid_topk.py::
// centroid_topk (body _kernel).  Same contract: for each query, the T best
// centroids by q.c (dot) or 2*q.c - ||c||^2 (l2), computed in f32, without
// writing the [Q, K] score matrix; ties go to the lower centroid id, and an
// entry whose value is <= NEG_INF/2 carries id -1.
//
// What bounds it on the H100: 2*Q*K*D flops on Q*D + K*D inputs.  At the
// sharded search's Q=256, K=3162, D=768 that is 1.24 GFLOP on 10.5 MB, so
// with f32 FMA (67 TFLOP/s against 3.35 TB/s) it is bound by operations:
// 0.019 ms against 0.003 ms for the bytes.
//
// This first design: one CTA of 256 threads per group of 16 queries.  The
// CTA walks all of K in tiles of 128 centroids; per tile it stages 16x32
// query and 128x32 centroid slices of the depth in shared memory and
// computes the 16x128 score tile as an f32 FMA product (each thread one
// query row by 8 centroids; no tensor cores, never TF32).  Under l2 the 16
// threads of query row 0 also sum the staged centroid squares, so ||c||^2
// comes from the same staged tile.  The masked tile is then folded into each
// query's running top-T: a warp owns 2 queries, lane j < T holds the j-th
// best (value, id) in registers, and candidates above the running T-th are
// ballot-selected in id order and inserted after equal entries with warp
// shuffles, so the lower id wins a tie as in lax.top_k.
//
// Left to later PRs: at Q=256 only 16 of 132 SMs get a CTA.  Splitting K
// over CTAs (with a second merge pass) or fewer queries per CTA would fill
// the card; wgmma would move the bound from f32 FMA to bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;   // queries per CTA
constexpr int CT = 128;  // centroids per tile
constexpr int DK = 32;   // depth per staging step
constexpr int NT = 256;  // threads per CTA: 16 query rows x 16 column groups
constexpr int CPT = CT / 16;             // centroids scored by each thread
constexpr int RPW = QT / (NT / 32);      // queries owned by each warp
constexpr int MAX_T = 32;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Metric { kDot = 0, kL2 = 1 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TQ, typename TC, int METRIC>
__global__ void __launch_bounds__(NT) centroid_topk_kernel(
    const TQ* __restrict__ queries, const TC* __restrict__ centroids,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int q, int k,
    int d, int t) {
  __shared__ float qs[QT][DK + 1];
  __shared__ float cs[CT][DK + 1];
  __shared__ float ss[QT][CT + 1];
  __shared__ float cn[CT];  // ||c||^2 of the tile's centroids (l2)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid >> 4;   // query row of this thread's scores
  const int cx = tid & 15;  // first of its centroid columns (stride 16)
  const int q0 = blockIdx.x * QT;
  const int nq = min(QT, q - q0);

  float rv[RPW];
  int ri[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rv[i] = NEG_INF;
    ri[i] = -1;
  }

  for (int c0 = 0; c0 < k; c0 += CT) {
    const int nc = min(CT, k - c0);
    float acc[CPT], nacc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = nacc[j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      __syncthreads();
      for (int e = tid; e < QT * DK; e += NT) {
        const int rr = e / DK, c = e % DK;
        float x = 0.f;
        if (rr < nq && d0 + c < d)
          x = to_f32(queries[(size_t)(q0 + rr) * d + d0 + c]);
        qs[rr][c] = x;
      }
      for (int e = tid; e < CT * DK; e += NT) {
        const int rr = e / DK, c = e % DK;
        float x = 0.f;
        if (rr < nc && d0 + c < d)
          x = to_f32(centroids[(size_t)(c0 + rr) * d + d0 + c]);
        cs[rr][c] = x;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float a = qs[r][kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float b = cs[cx + 16 * j][kk];
          acc[j] = fmaf(a, b, acc[j]);
          if (METRIC == kL2 && r == 0) nacc[j] = fmaf(b, b, nacc[j]);
        }
      }
    }
    if (METRIC == kL2 && r == 0) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) cn[cx + 16 * j] = nacc[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cx + 16 * j;
      float sc = METRIC == kL2 ? 2.f * acc[j] - cn[c] : acc[j];
      ss[r][c] = c < nc ? sc : NEG_INF;  // past K: never selected
    }
    __syncthreads();

    // fold the tile into each owned query's running top-T, in id order
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      if (row >= nq) continue;  // uniform over the warp
      float kth = __shfl_sync(FULL, rv[i], t - 1);
#pragma unroll
      for (int h = 0; h < CT / 32; ++h) {
        const float cand = ss[row][h * 32 + lane];
        unsigned sel = __ballot_sync(FULL, cand > kth);
        while (sel) {
          const int src = __ffs(sel) - 1;
          sel &= sel - 1;
          const float cv = __shfl_sync(FULL, cand, src);
          if (cv > kth) {  // uniform; strictly greater: lower ids win ties
            const int cid = c0 + h * 32 + src;
            const int p = __popc(__ballot_sync(FULL, lane < t && rv[i] >= cv));
            const float up_v = __shfl_up_sync(FULL, rv[i], 1);
            const int up_i = __shfl_up_sync(FULL, ri[i], 1);
            if (lane < t && lane > p) {
              rv[i] = up_v;
              ri[i] = up_i;
            } else if (lane == p) {
              rv[i] = cv;
              ri[i] = cid;
            }
            kth = __shfl_sync(FULL, rv[i], t - 1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = warp * RPW + i;
    if (row < nq && lane < t) {
      const size_t o = (size_t)(q0 + row) * t + lane;
      out_vals[o] = rv[i];
      out_ids[o] = rv[i] > 0.5f * NEG_INF ? ri[i] : -1;
    }
  }
}

template <typename TQ, typename TC, int METRIC>
cudaError_t launch(int q, int k, int d, int t, const void* queries,
                   const void* centroids, void* out_vals, void* out_ids,
                   cudaStream_t stream) {
  dim3 grid((q + QT - 1) / QT);
  centroid_topk_kernel<TQ, TC, METRIC><<<grid, NT, 0, stream>>>(
      (const TQ*)queries, (const TC*)centroids, (float*)out_vals,
      (int*)out_ids, q, k, d, t);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: 0 on a
// successful launch.
extern "C" int centroid_topk_launch(int q, int k, int d, int t,
                                    const void* queries, const void* centroids,
                                    void* out_vals, void* out_ids, int metric,
                                    int q_dtype, int c_dtype, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (t < 1 || t > MAX_T || t > k || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CT_ARGS q, k, d, t, queries, centroids, out_vals, out_ids, st
#define CT_DISPATCH(M)                                                      \
  if (q_dtype == kF32 && c_dtype == kF32)                                   \
    return launch<float, float, M>(CT_ARGS);                                \
  if (q_dtype == kBF16 && c_dtype == kBF16)                                 \
    return launch<__nv_bfloat16, __nv_bfloat16, M>(CT_ARGS);                \
  if (q_dtype == kF32 && c_dtype == kBF16)                                  \
    return launch<float, __nv_bfloat16, M>(CT_ARGS);                        \
  if (q_dtype == kBF16 && c_dtype == kF32)                                  \
    return launch<__nv_bfloat16, float, M>(CT_ARGS);
  if (metric == kDot) {
    CT_DISPATCH(kDot)
  } else if (metric == kL2) {
    CT_DISPATCH(kL2)
  }
#undef CT_DISPATCH
#undef CT_ARGS
  return cudaErrorInvalidValue;
}
