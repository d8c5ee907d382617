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
// in f32 FMA (67 TFLOP/s against 3.35 TB/s) it is bound by operations:
// 0.019 ms against 0.003 ms for the bytes.  The sums stay in f32 FMA, never
// TF32.  The first design gave each CTA 16 queries and all of K, so Q=256
// filled 16 of the 132 SMs; this one fills the card:
//
// - Split K.  The grid is (query groups of 32) x (K chunks of 128
//   centroids): 8 x 25 = 200 CTAs at the sharded search's shape, all
//   resident at once (two per SM: 46 KB of shared memory and at most 128
//   registers a thread).  Each CTA writes its chunk's top-T per query to a
//   [Q, n_chunks, T] scratch that the wrapper allocates, and a second small
//   kernel merges the chunks of a query in chunk order by (value
//   descending, id ascending), so ties still go to the lower id across
//   chunk edges.  No padding of K: the last chunk
//   masks its missing centroids to NEG_INF.
// - Register-blocked micro-tiles.  Each of the 256 threads computes 4
//   queries x 4 centroids, reading both as float4 along the depth from
//   shared memory (rows of 36 floats: 16-byte aligned, conflict-free), so 8
//   shared loads feed 64 FMAs.
// - Double-buffered staging.  f32 operands go to shared memory with
//   cp.async (16-byte copies where D is a multiple of 4, 4-byte copies
//   otherwise); bf16 operands are loaded into registers before the current
//   slice is multiplied and widened into the other buffer after it.  Either
//   way the next 32-deep slice is in flight during the FMAs.
// - Under l2 each warp sums ||c||^2 for one float4 of every slice of the
//   staged centroid tile; the 8 partial sums are added at the chunk's end.
//
// The selection (both kernels): lane j of a warp holds the query's j-th best
// (value, id); candidates above the running T-th are ballot-selected in id
// order and inserted after equal entries with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 32;       // queries per CTA
constexpr int CT = 128;      // centroids per CTA: one K chunk
constexpr int DK = 32;       // depth per staging step
constexpr int LD = DK + 4;   // staged row stride in floats
constexpr int NT = 256;      // threads: 8 query rows x 32 centroid columns
constexpr int RPW = QT / (NT / 32);  // queries selected by each warp
constexpr int MERGE_Q = 8;   // queries per merge CTA, one warp each
constexpr int MAX_T = 32;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Metric { kDot = 0, kL2 = 1 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One operand's ROWS x DK slice, staged as f32 rows of LD floats.  f32:
// cp.async straight into shared memory.  bf16: loads into registers
// (issue), widened into shared memory later (finish).
template <typename T, bool VEC, int ROWS>
struct Slice {
  static constexpr int N = ROWS * DK / NT;  // elements per thread
  __nv_bfloat16 r[N];

  __device__ __forceinline__ void issue(const T* g, int nrows, int d, int d0,
                                        float* dst, int tid) {
    if constexpr (sizeof(T) == 4) {
      if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const int e = tid + NT * i, row = e / (DK / 4);
          const int c = 4 * (e % (DK / 4));
          const bool in = row < nrows && d0 + c < d;
          cp_async16(dst + row * LD + c,
                     in ? (const float*)g + (size_t)row * d + d0 + c
                        : (const float*)g, in);
        }
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int e = tid + NT * i, row = e / DK, c = e % DK;
          const bool in = row < nrows && d0 + c < d;
          cp_async4(dst + row * LD + c,
                    in ? (const float*)g + (size_t)row * d + d0 + c
                       : (const float*)g, in);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int e = tid + NT * i, row = e / DK, c = e % DK;
        r[i] = (row < nrows && d0 + c < d) ? g[(size_t)row * d + d0 + c]
                                           : __float2bfloat16(0.f);
      }
    }
  }

  __device__ __forceinline__ void finish(float* dst, int tid) {
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int e = tid + NT * i;
        dst[(e / DK) * LD + e % DK] = __bfloat162float(r[i]);
      }
    }
  }
};

// Inserts the candidates of `cand` (lane order = id order) that beat the
// running T-th into the warp's list (rv, ri): strictly greater, after
// equal entries, so the earlier candidate wins a tie.
__device__ __forceinline__ void fold(float& rv, int& ri, float cand, int cid,
                                     int lane, int t) {
  float kth = __shfl_sync(FULL, rv, t - 1);
  unsigned sel = __ballot_sync(FULL, cand > kth);
  while (sel) {
    const int src = __ffs(sel) - 1;
    sel &= sel - 1;
    const float cv = __shfl_sync(FULL, cand, src);
    const int ci = __shfl_sync(FULL, cid, src);
    if (cv > kth) {  // uniform over the warp
      const int p = __popc(__ballot_sync(FULL, lane < t && rv >= cv));
      const float up_v = __shfl_up_sync(FULL, rv, 1);
      const int up_i = __shfl_up_sync(FULL, ri, 1);
      if (lane < t && lane > p) {
        rv = up_v;
        ri = up_i;
      } else if (lane == p) {
        rv = cv;
        ri = ci;
      }
      kth = __shfl_sync(FULL, rv, t - 1);
    }
  }
}

template <typename TQ, typename TC, int METRIC, bool VEC>
__global__ void __launch_bounds__(NT, 2) chunk_topk_kernel(
    const TQ* __restrict__ queries, const TC* __restrict__ centroids,
    float* __restrict__ part_vals, int* __restrict__ part_ids, int q, int k,
    int d, int t) {
  __shared__ __align__(16) float buf[2][(QT + CT) * LD];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = lane;  // centroid columns tx + 32*j
  const int ty = warp;  // query rows ty + 8*i
  const int q0 = blockIdx.x * QT;
  const int chunk = blockIdx.y;
  const int c0 = chunk * CT;
  const int nq = min(QT, q - q0);
  const int nc = min(CT, k - c0);
  const TQ* qg = queries + (size_t)q0 * d;
  const TC* cg = centroids + (size_t)c0 * d;

  float acc[4][4], nacc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    nacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  Slice<TQ, VEC, QT> qsl;
  Slice<TC, VEC, CT> csl;
  const int steps = (d + DK - 1) / DK;
  qsl.issue(qg, nq, d, 0, buf[0], tid);
  csl.issue(cg, nc, d, 0, buf[0] + QT * LD, tid);
  cp_async_commit();
  qsl.finish(buf[0], tid);
  csl.finish(buf[0] + QT * LD, tid);

  for (int s = 0; s < steps; ++s) {
    float* cur = buf[s & 1];
    float* nxt = buf[(s + 1) & 1];
    const bool more = s + 1 < steps;
    if (more) {
      qsl.issue(qg, nq, d, (s + 1) * DK, nxt, tid);
      csl.issue(cg, nc, d, (s + 1) * DK, nxt + QT * LD, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* qs = cur;
    const float* cs = cur + QT * LD;
#pragma unroll
    for (int kk = 0; kk < DK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 8 * i) * LD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(cs + (tx + 32 * j) * LD + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          x = fmaf(a[i].w, b[j].w, x);
          acc[i][j] = x;
        }
      if (METRIC == kL2 && kk / 4 == ty) {  // uniform over the warp
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = nacc[j];
          x = fmaf(b[j].x, b[j].x, x);
          x = fmaf(b[j].y, b[j].y, x);
          x = fmaf(b[j].z, b[j].z, x);
          x = fmaf(b[j].w, b[j].w, x);
          nacc[j] = x;
        }
      }
    }
    if (more) {
      qsl.finish(nxt, tid);
      csl.finish(nxt + QT * LD, tid);
    }
    __syncthreads();
  }

  // The staging buffers are free now: the score tile and the norms' partial
  // sums reuse them.
  float* ss = &buf[0][0];          // [QT][CT+1]
  float* nred = ss + QT * (CT + 1);  // [8][CT]
  float* cn = nred + 8 * CT;         // [CT]
  if (METRIC == kL2) {
#pragma unroll
    for (int j = 0; j < 4; ++j) nred[ty * CT + tx + 32 * j] = nacc[j];
    __syncthreads();
    if (tid < CT) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) x += nred[w * CT + tid];
      cn[tid] = x;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 32 * j;
      const float sc = METRIC == kL2 ? 2.f * acc[i][j] - cn[c] : acc[i][j];
      ss[(ty + 8 * i) * (CT + 1) + c] = c < nc ? sc : NEG_INF;
    }
  __syncthreads();

  const int nch = gridDim.y;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = warp * RPW + i;
    if (row >= nq) continue;  // uniform over the warp
    float rv = NEG_INF;
    int ri = -1;
#pragma unroll
    for (int h = 0; h < CT / 32; ++h)
      fold(rv, ri, ss[row * (CT + 1) + h * 32 + lane], c0 + h * 32 + lane,
           lane, t);
    if (lane < t) {
      const size_t o = ((size_t)(q0 + row) * nch + chunk) * t + lane;
      part_vals[o] = rv;
      part_ids[o] = ri;
    }
  }
}

// Merges each query's per-chunk lists in chunk order: a chunk's ids are all
// above the earlier chunks', so inserting after equal entries keeps ties in
// ascending id order.
__global__ void __launch_bounds__(MERGE_Q * 32) merge_kernel(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int q, int nch,
    int t) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * MERGE_Q + (threadIdx.x >> 5);
  if (qi >= q) return;  // uniform over the warp
  float rv = NEG_INF;
  int ri = -1;
  for (int c = 0; c < nch; ++c) {
    const size_t o = ((size_t)qi * nch + c) * t + lane;
    fold(rv, ri, lane < t ? part_vals[o] : NEG_INF,
         lane < t ? part_ids[o] : -1, lane, t);
  }
  if (lane < t) {
    out_vals[(size_t)qi * t + lane] = rv;
    out_ids[(size_t)qi * t + lane] = rv > 0.5f * NEG_INF ? ri : -1;
  }
}

template <typename TQ, typename TC, int METRIC, bool VEC>
cudaError_t launch(int q, int k, int d, int t, const void* queries,
                   const void* centroids, void* part_vals, void* part_ids,
                   void* out_vals, void* out_ids, cudaStream_t stream) {
  const int nch = (k + CT - 1) / CT;
  dim3 grid((q + QT - 1) / QT, nch);
  chunk_topk_kernel<TQ, TC, METRIC, VEC><<<grid, NT, 0, stream>>>(
      (const TQ*)queries, (const TC*)centroids, (float*)part_vals,
      (int*)part_ids, q, k, d, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<(q + MERGE_Q - 1) / MERGE_Q, MERGE_Q * 32, 0, stream>>>(
      (const float*)part_vals, (const int*)part_ids, (float*)out_vals,
      (int*)out_ids, q, nch, t);
  return cudaGetLastError();
}

}  // namespace

// The number of K chunks: the scratch holds [Q, n_chunks, T] values and ids.
extern "C" int centroid_topk_chunks(int k) { return (k + CT - 1) / CT; }

// Plain C entry point (bound with ctypes).  part_vals/part_ids are the
// wrapper's [Q, centroid_topk_chunks(K), T] f32/int32 scratch.  Returns a
// cudaError_t: 0 on a successful launch of both kernels.
extern "C" int centroid_topk_launch(int q, int k, int d, int t,
                                    const void* queries, const void* centroids,
                                    void* part_vals, void* part_ids,
                                    void* out_vals, void* out_ids, int metric,
                                    int q_dtype, int c_dtype, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (t < 1 || t > MAX_T || t > k || d < 1) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // 16-byte copies need 16-byte aligned rows
  const bool vec = d % 4 == 0 && (uintptr_t)queries % 16 == 0 &&
                   (uintptr_t)centroids % 16 == 0;
#define CT_ARGS \
  q, k, d, t, queries, centroids, part_vals, part_ids, out_vals, out_ids, st
#define CT_DISPATCH(M)                                                      \
  if (q_dtype == kF32 && c_dtype == kF32)                                   \
    return vec ? launch<float, float, M, true>(CT_ARGS)                     \
               : launch<float, float, M, false>(CT_ARGS);                   \
  if (q_dtype == kBF16 && c_dtype == kBF16)                                 \
    return launch<__nv_bfloat16, __nv_bfloat16, M, false>(CT_ARGS);         \
  if (q_dtype == kF32 && c_dtype == kBF16)                                  \
    return launch<float, __nv_bfloat16, M, false>(CT_ARGS);                 \
  if (q_dtype == kBF16 && c_dtype == kF32)                                  \
    return launch<__nv_bfloat16, float, M, false>(CT_ARGS);
  if (metric == kDot) {
    CT_DISPATCH(kDot)
  } else if (metric == kL2) {
    CT_DISPATCH(kL2)
  }
#undef CT_DISPATCH
#undef CT_ARGS
  return cudaErrorInvalidValue;
}
