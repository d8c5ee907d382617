// Tiled, probe-deduplicated filtered IVF scan with a streaming per-query
// top-k, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/filtered_scan/filtered_scan.py::
// filtered_scan_tiled (body _tiled_kernel, selection _fold_topk).  Same
// contract: for every unique-probe slot s, score the query tile
// slot_tile[s] (QB rows) against every row of cluster slot_cluster[s]
// (dot; SQ8 dot times the row scale; or l2 as 2*dot - ||v||^2), mask rows
// failing the query's DNF filter (OR over F terms of AND over M int16
// attributes, widened to int32) or dead (id < 0) to NEG_INF, and keep each
// query row's top k (earliest row wins ties) and its pass count.  Slots at
// position >= n_unique[tile] within their tile, or whose cluster lies
// outside [0, K), are pads: they are skipped and written as (NEG_INF, -1, 0).
// Queries are the vectors' dtype, or f32 against bf16 vectors (the sharded
// search passes its f32 queries uncast, as the TPU kernel accepts).
//
// What bounds it on the H100: each live slot streams its cluster's
// Vpad*D*bytes of vectors (4.9 MB at Vpad=3200, D=768, bf16) and spends
// 2*QB*Vpad*D flops on them, i.e. 2*QB/bytes = 64 flop/byte for bf16 at
// QB=64.  With f32 FMA (67 TFLOP/s against 3.35 TB/s, ridge ~20 flop/byte)
// this design is bound by operations, not bytes.
//
// This first design: one CTA of 256 threads per (live slot, group of 64
// query rows).  The CTA reads its own slot_cluster/slot_tile (the TPU's
// scalar prefetch) and walks Vpad in chunks of 64 rows inside the CTA (the
// TPU's sequential grid axis; no state crosses CTAs).  Per chunk it stages
// the rows' ids, attributes and norms/scales in shared memory, computes the
// 64x64 score tile as an smem-tiled f32 FMA product over D in steps of 32
// (each thread a 4x4 micro-tile; no tensor cores, never TF32), applies the
// scale/l2 epilogue, the mask and the pass count, and folds the tile into
// each query row's running top-k: a warp owns 8 rows, lane j < k holds the
// row's j-th best (value, id) in registers, candidates above the running
// k-th are ballot-selected in row order and inserted with warp shuffles.
//
// Left to later PRs: bf16 wgmma on the tensor cores (which moves the bound
// to bytes), TMA loads into a multi-stage smem ring, and a persistent grid
// that balances slots across the 132 SMs when a batch has few unique slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;   // query rows per CTA
constexpr int VT = 64;   // cluster rows per chunk
constexpr int DK = 32;   // depth per staging step
constexpr int NT = 256;  // threads per CTA (16 x 16 grid of 4x4 micro-tiles)
constexpr int RPW = QT / (NT / 32);  // query rows owned by each warp
constexpr int MAX_K = 32;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kDot = 0, kL2 = 1, kSq8 = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

size_t smem_bytes(int m, int f) {
  size_t floats = QT * (DK + 1) + VT * (DK + 1) + QT * (VT + 1) + VT;
  size_t ints = VT + QT + (size_t)VT * m + 2 * (size_t)QT * f * m;
  return 4 * (floats + ints);
}

template <typename TQ, typename TV, int MODE>
__global__ void __launch_bounds__(NT) filtered_scan_tiled_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const TV* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [QT][DK+1]
  float* vs = qs + QT * (DK + 1);                  // [VT][DK+1]
  float* ss = vs + VT * (DK + 1);                  // [QT][VT+1] masked scores
  float* auxs = ss + QT * (VT + 1);                // [VT] norms or scales
  int* idss = reinterpret_cast<int*>(auxs + VT);   // [VT]
  int* npass_s = idss + VT;                        // [QT]
  int* attrs_s = npass_s + QT;                     // [VT][m]
  int* lo_s = attrs_s + VT * m;                    // [QT][f][m]
  int* hi_s = lo_s + QT * f * m;                   // [QT][f][m]

  const int s = blockIdx.x;
  const int q0 = blockIdx.y * QT;  // first query row of this CTA in the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = min(QT, qb - q0);  // query rows this CTA serves
  const size_t out_row0 = (size_t)s * qb + q0;

  const int tile = slot_tile[s];
  const int cluster = slot_cluster[s];
  const bool pad = (n_unique != nullptr && s - tile * u_cap >= n_unique[tile]) ||
                   cluster < 0 || cluster >= n_clusters;
  if (pad) {  // uniform over the CTA
    for (int e = tid; e < nq * k; e += NT) {
      out_vals[out_row0 * k + e] = NEG_INF;
      out_ids[out_row0 * k + e] = -1;
    }
    for (int e = tid; e < nq; e += NT) out_npass[out_row0 + e] = 0;
    return;
  }

  const size_t qrow0 = (size_t)tile * qb + q0;
  const int fm = f * m;
  for (int e = tid; e < QT * fm; e += NT) {
    const int r = e / fm;
    const bool in = r < nq;  // idle rows get a void term
    lo_s[e] = in ? (int)lo[(qrow0 + r) * fm + e % fm] : 1;
    hi_s[e] = in ? (int)hi[(qrow0 + r) * fm + e % fm] : 0;
  }
  for (int e = tid; e < QT; e += NT) npass_s[e] = 0;

  float rv[RPW];
  int ri[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    rv[i] = NEG_INF;
    ri[i] = -1;
  }

  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t crow0 = (size_t)cluster * vpad;
  const TV* vbase = vectors + crow0 * d;
  const TQ* qbase = queries + qrow0 * d;

  for (int v0 = 0; v0 < vpad; v0 += VT) {
    const int nv = min(VT, vpad - v0);
    for (int e = tid; e < VT; e += NT) {
      const bool in = e < nv;
      idss[e] = in ? ids[crow0 + v0 + e] : -1;
      auxs[e] = (MODE != kDot && in) ? aux[crow0 + v0 + e] : 0.f;
    }
    for (int e = tid; e < VT * m; e += NT) {
      const int r = e / m;
      attrs_s[e] = r < nv ? (int)attrs[(crow0 + v0 + r) * m + e % m] : 0;
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      __syncthreads();
      for (int e = tid; e < QT * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        float x = 0.f;
        if (r < nq && d0 + c < d) x = to_f32(qbase[(size_t)r * d + d0 + c]);
        qs[r * (DK + 1) + c] = x;
      }
      for (int e = tid; e < VT * DK; e += NT) {
        const int r = e / DK, c = e % DK;
        float x = 0.f;
        if (r < nv && d0 + c < d)
          x = to_f32(vbase[(size_t)(v0 + r) * d + d0 + c]);
        vs[r * (DK + 1) + c] = x;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (DK + 1) + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vs[(tx + 16 * j) * (DK + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // epilogue: row constants, DNF mask, liveness, pass counts
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float sc = acc[i][j];
        if (MODE == kSq8) sc = sc * auxs[c];
        if (MODE == kL2) sc = 2.f * sc - auxs[c];
        bool ok = r < nq && idss[c] >= 0;  // idss is -1 past the list end
        if (ok) {
          bool any = false;
          for (int t = 0; t < f && !any; ++t) {
            bool all = true;
            for (int a = 0; a < m && all; ++a) {
              const int av = attrs_s[c * m + a];
              all = av >= lo_s[(r * f + t) * m + a] &&
                    av <= hi_s[(r * f + t) * m + a];
            }
            any = all;
          }
          ok = any;
        }
        cnt += ok;
        ss[r * (VT + 1) + c] = ok ? sc : NEG_INF;
      }
      if (cnt) atomicAdd(&npass_s[r], cnt);
    }
    __syncthreads();

    // fold the chunk into each owned row's running top-k, in row order
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + (NT / 32) * i;
      if (r >= nq) continue;  // uniform over the warp
      float kth = __shfl_sync(FULL, rv[i], k - 1);
#pragma unroll
      for (int h = 0; h < VT / 32; ++h) {
        const float cand = ss[r * (VT + 1) + h * 32 + lane];
        unsigned sel = __ballot_sync(FULL, cand > kth);
        while (sel) {
          const int src = __ffs(sel) - 1;
          sel &= sel - 1;
          const float cv = __shfl_sync(FULL, cand, src);
          if (cv > kth) {  // uniform; strictly greater: earlier rows win ties
            const int cid = idss[h * 32 + src];
            const int p = __popc(__ballot_sync(FULL, lane < k && rv[i] >= cv));
            const float up_v = __shfl_up_sync(FULL, rv[i], 1);
            const int up_i = __shfl_up_sync(FULL, ri[i], 1);
            if (lane < k && lane > p) {
              rv[i] = up_v;
              ri[i] = up_i;
            } else if (lane == p) {
              rv[i] = cv;
              ri[i] = cid;
            }
            kth = __shfl_sync(FULL, rv[i], k - 1);
          }
        }
      }
    }
    __syncthreads();  // ss and the staged row constants are reused next chunk
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + (NT / 32) * i;
    if (r < nq && lane < k) {
      const size_t o = (out_row0 + r) * k + lane;
      out_vals[o] = rv[i];
      out_ids[o] = rv[i] > 0.5f * NEG_INF ? ri[i] : -1;
    }
  }
  __syncthreads();
  for (int e = tid; e < nq; e += NT) out_npass[out_row0 + e] = npass_s[e];
}

template <typename TQ, typename TV, int MODE>
cudaError_t launch(int n_slots, const void* slot_cluster, const void* slot_tile,
                   const void* n_unique, int u_cap, int n_clusters,
                   const void* queries, const void* lo, const void* hi,
                   const void* vectors, const void* attrs, const void* ids,
                   const void* aux, void* out_vals, void* out_ids,
                   void* out_npass, int qb, int d, int vpad, int m, int f,
                   int k, cudaStream_t stream) {
  auto kernel = filtered_scan_tiled_kernel<TQ, TV, MODE>;
  const size_t smem = smem_bytes(m, f);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_slots, (qb + QT - 1) / QT);
  kernel<<<grid, NT, smem, stream>>>(
      (const int*)slot_cluster, (const int*)slot_tile, (const int*)n_unique,
      u_cap, n_clusters, (const TQ*)queries, (const int16_t*)lo,
      (const int16_t*)hi, (const TV*)vectors, (const int16_t*)attrs,
      (const int*)ids, (const float*)aux, (float*)out_vals, (int*)out_ids,
      (int*)out_npass, qb, d, vpad, m, f, k);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  n_unique may be null (every
// slot live); aux is the norms (mode 1) or scales (mode 2) pointer, null for
// mode 0.  Returns a cudaError_t: 0 on a successful launch.
extern "C" int filtered_scan_tiled_launch(
    int n_slots, const void* slot_cluster, const void* slot_tile,
    const void* n_unique, int u_cap, int n_clusters, const void* queries,
    const void* lo, const void* hi, const void* vectors, const void* attrs,
    const void* ids, const void* aux, void* out_vals, void* out_ids,
    void* out_npass, int qb, int d, int vpad, int m, int f, int k, int mode,
    int q_dtype, int v_dtype, void* stream) {
  if (n_slots <= 0) return cudaSuccess;
  if (k < 1 || k > MAX_K || qb < 1 || d < 1 || f < 1 || m < 0)
    return cudaErrorInvalidValue;
  if (smem_bytes(m, f) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_ARGS                                                               \
  n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters, queries, lo, \
      hi, vectors, attrs, ids, aux, out_vals, out_ids, out_npass, qb, d,      \
      vpad, m, f, k, st
  if (mode == kDot && q_dtype == kBF16 && v_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, kDot>(FS_ARGS);
  if (mode == kDot && q_dtype == kF32 && v_dtype == kF32)
    return launch<float, float, kDot>(FS_ARGS);
  if (mode == kDot && q_dtype == kF32 && v_dtype == kBF16)  // sharded search
    return launch<float, __nv_bfloat16, kDot>(FS_ARGS);
  if (mode == kL2 && q_dtype == kBF16 && v_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, kL2>(FS_ARGS);
  if (mode == kL2 && q_dtype == kF32 && v_dtype == kF32)
    return launch<float, float, kL2>(FS_ARGS);
  if (mode == kL2 && q_dtype == kF32 && v_dtype == kBF16)
    return launch<float, __nv_bfloat16, kL2>(FS_ARGS);
  if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8)
    return launch<float, int8_t, kSq8>(FS_ARGS);
#undef FS_ARGS
  return cudaErrorInvalidValue;
}
