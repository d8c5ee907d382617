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
//   registers a thread).  Each CTA writes its chunk's top-min(T, 128) per
//   query to a [Q, n_chunks, min(T, 128)] scratch that the wrapper
//   allocates, and a second small kernel merges the chunks of a query by
//   (value descending, id ascending), so ties still go to the lower id
//   across chunk edges.  No padding of K: the last chunk masks its missing
//   centroids to NEG_INF.
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
// The selection, any T up to K: each warp bitonic-sorts a query's 128 chunk
// scores in registers (4 a lane, 28 compare-exchange steps, by value
// descending then id ascending) and keeps the first min(T, 128).  The
// first design inserted the candidates above the running T-th one at a
// time, a chain of warp shuffles per insert: the sort costs the same for
// every T and took less time on an H100 already at T = 8 (PERF.md).  The
// merge runs one CTA per query, which sorts all its chunk entries in
// shared memory with a bitonic network (the lists of K <= 8192 centroids
// fit), or else places every chunk entry straight at its rank: its
// position in its own list plus, in each other chunk's list, the length of
// the prefix that comes before it (a binary search).  Both orders send
// ties to the lower id.

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

// Whether (va, ia) comes before (vb, ib) in a list: value descending, then
// id ascending.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Sorts the warp's 128 (value, id) pairs, element e = 32*j + lane in slot
// j, best first (a bitonic network: strides below 32 across lanes, the
// others between a lane's own slots).
__device__ __forceinline__ void warp_sort128(float (&v)[CT / 32],
                                             int (&id)[CT / 32], int lane) {
#pragma unroll
  for (int k = 2; k <= CT; k <<= 1) {
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) {
      if (s >= 32) {
#pragma unroll
        for (int j = 0; j < CT / 32; ++j) {
          const int jp = j ^ (s >> 5);
          if (jp < j) continue;
          const bool up = ((32 * j + lane) & k) == 0;
          if (up == before(v[jp], id[jp], v[j], id[j])) {
            const float tv = v[j];
            const int ti = id[j];
            v[j] = v[jp];
            id[j] = id[jp];
            v[jp] = tv;
            id[jp] = ti;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < CT / 32; ++j) {
          const int e = 32 * j + lane;
          const float pv = __shfl_xor_sync(FULL, v[j], s);
          const int pi = __shfl_xor_sync(FULL, id[j], s);
          // the lower index of an ascending pair keeps the one first
          const bool first = ((e & s) == 0) == ((e & k) == 0);
          if (first == before(pv, pi, v[j], id[j])) {
            v[j] = pv;
            id[j] = pi;
          }
        }
      }
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
  const int tc = min(t, CT);  // the chunk's list length
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = warp * RPW + i;
    if (row >= nq) continue;  // uniform over the warp
    const size_t o = ((size_t)(q0 + row) * nch + chunk) * tc;
    float v[CT / 32];
    int id[CT / 32];
#pragma unroll
    for (int h = 0; h < CT / 32; ++h) {
      v[h] = ss[row * (CT + 1) + h * 32 + lane];  // NEG_INF past nc
      id[h] = c0 + h * 32 + lane;
    }
    warp_sort128(v, id, lane);
#pragma unroll
    for (int h = 0; h < CT / 32; ++h)
      if (h * 32 + lane < tc) {
        part_vals[o + h * 32 + lane] = v[h];
        part_ids[o + h * 32 + lane] = v[h] > 0.5f * NEG_INF ? id[h] : -1;
      }
  }
}

// The merge where a query's lists do not fit in shared memory: one CTA a
// query.  Every live entry of every chunk list goes straight to its rank:
// its position in its own list plus, in each other list, the length of the
// prefix that comes before it (a binary search: the lists are sorted,
// their -1 pads last).  Ranks are distinct,
// so each output slot is written once; slots past the live entries keep
// the (NEG_INF, -1) they were filled with.  Where a list holds T entries
// (T <= 128), an entry that comes after the best of the lists' last
// entries has at least T entries before it, so it is dropped before any
// search.
__global__ void __launch_bounds__(256) rank_merge_kernel(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int nch, int t,
    int tc) {
  const int qi = blockIdx.x;
  const int n = nch * tc;
  const float* pv = part_vals + (size_t)qi * n;
  const int* pi = part_ids + (size_t)qi * n;
  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    out_vals[(size_t)qi * t + r] = NEG_INF;
    out_ids[(size_t)qi * t + r] = -1;
  }
  __syncthreads();
  // the bound: the best full list's last entry (id -1: no bound)
  __shared__ float bv[32];
  __shared__ int bi[32];
  float tv = NEG_INF;
  int ti = -1;
  if (tc == t)
    for (int c = threadIdx.x; c < nch; c += blockDim.x) {
      const int li = pi[c * tc + tc - 1];
      const float lv = pv[c * tc + tc - 1];
      if (li >= 0 && (ti < 0 || before(lv, li, tv, ti))) {
        tv = lv;
        ti = li;
      }
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, tv, o);
    const int oi = __shfl_xor_sync(FULL, ti, o);
    if (oi >= 0 && (ti < 0 || before(ov, oi, tv, ti))) {
      tv = ov;
      ti = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    bv[warp] = tv;
    bi[warp] = ti;
  }
  __syncthreads();
  if (warp == 0) {
    tv = lane < (int)(blockDim.x >> 5) ? bv[lane] : NEG_INF;
    ti = lane < (int)(blockDim.x >> 5) ? bi[lane] : -1;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, tv, o);
      const int oi = __shfl_xor_sync(FULL, ti, o);
      if (oi >= 0 && (ti < 0 || before(ov, oi, tv, ti))) {
        tv = ov;
        ti = oi;
      }
    }
    if (lane == 0) {
      bv[0] = tv;
      bi[0] = ti;
    }
  }
  __syncthreads();
  tv = bv[0];
  ti = bi[0];
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int id = pi[e];
    if (id < 0) continue;
    const float v = pv[e];
    if (ti >= 0 && before(tv, ti, v, id)) continue;  // T entries before it
    const int c = e / tc;
    int rank = e - c * tc;
    for (int c2 = 0; c2 < nch && rank < t; ++c2) {
      if (c2 == c) continue;
      const float* lv = pv + c2 * tc;
      const int* li = pi + c2 * tc;
      int lo = 0, hi = tc;  // the first entry not before (v, id)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (li[mid] >= 0 && before(lv[mid], li[mid], v, id))
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < t) {
      out_vals[(size_t)qi * t + rank] = v;
      out_ids[(size_t)qi * t + rank] = id;
    }
  }
}

// The merge where a query's n chunk entries fit in shared memory (p, a
// power of two >= n, pairs of 8 bytes): one CTA a query sorts them, -1
// pads last, and writes the first T.
__global__ void __launch_bounds__(256) sort_merge_kernel(
    const float* __restrict__ part_vals, const int* __restrict__ part_ids,
    float* __restrict__ out_vals, int* __restrict__ out_ids, int n, int p,
    int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sv = reinterpret_cast<float*>(smem_raw);
  int* si = reinterpret_cast<int*>(sv + p);
  const int qi = blockIdx.x;
  for (int e = threadIdx.x; e < p; e += blockDim.x) {
    const int id = e < n ? part_ids[(size_t)qi * n + e] : -1;
    sv[e] = id >= 0 ? part_vals[(size_t)qi * n + e] : NEG_INF;
    si[e] = id;
  }
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int a = 2 * i - (i & (j - 1));
        const int b = a + j;
        const float va = sv[a], vb = sv[b];
        const int ia = si[a], ib = si[b];
        if (((a & k) == 0) ? before(vb, ib, va, ia) : before(va, ia, vb, ib)) {
          sv[a] = vb;
          sv[b] = va;
          si[a] = ib;
          si[b] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    const bool live = r < n && si[r] >= 0;
    out_vals[(size_t)qi * t + r] = live ? sv[r] : NEG_INF;
    out_ids[(size_t)qi * t + r] = live ? si[r] : -1;
  }
}

constexpr size_t SORT_MERGE_MAX = 64 * 1024;  // shared memory of a sort merge

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
  const int tc = min(t, CT);
  const int n = nch * tc;
  int p = 1;
  while (p < n) p <<= 1;
  if ((size_t)p * 8 <= SORT_MERGE_MAX) {
    if ((size_t)p * 8 > 48 * 1024) {
      err = cudaFuncSetAttribute(sort_merge_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SORT_MERGE_MAX);
      if (err != cudaSuccess) return err;
    }
    sort_merge_kernel<<<q, 256, (size_t)p * 8, stream>>>(
        (const float*)part_vals, (const int*)part_ids, (float*)out_vals,
        (int*)out_ids, n, p, t);
  } else {
    rank_merge_kernel<<<q, 256, 0, stream>>>(
        (const float*)part_vals, (const int*)part_ids, (float*)out_vals,
        (int*)out_ids, nch, t, tc);
  }
  return cudaGetLastError();
}

}  // namespace

// The number of K chunks and each chunk's list length: the scratch holds
// [Q, n_chunks, list_len] values and ids.
extern "C" int centroid_topk_chunks(int k) { return (k + CT - 1) / CT; }
extern "C" int centroid_topk_list_len(int t) { return min(t, CT); }

// Plain C entry point (bound with ctypes).  part_vals/part_ids are the
// wrapper's [Q, centroid_topk_chunks(K), centroid_topk_list_len(T)]
// f32/int32 scratch.  Returns a
// cudaError_t: 0 on a successful launch of both kernels.
extern "C" int centroid_topk_launch(int q, int k, int d, int t,
                                    const void* queries, const void* centroids,
                                    void* part_vals, void* part_ids,
                                    void* out_vals, void* out_ids, int metric,
                                    int q_dtype, int c_dtype, void* stream) {
  if (q <= 0) return cudaSuccess;
  if (t < 1 || t > k || d < 1) return cudaErrorInvalidValue;
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
