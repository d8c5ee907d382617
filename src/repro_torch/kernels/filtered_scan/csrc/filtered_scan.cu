// Per-probe filtered IVF scan for NVIDIA Hopper (sm_90a): masked scores of
// one query against every row of one cluster, for each (query, probe) slot.
//
// Replaces the TPU kernel repro/kernels/filtered_scan/filtered_scan.py::
// filtered_scan (bodies _scan_kernel_dot, _scan_kernel_dot_q8 and
// _scan_kernel_l2).  Same contract: for every slot p, the row
// out[p, v] = score(queries[slot_query[p]], vectors[slot_cluster[p], v])
// (dot; SQ8 dot times the row scale; or l2 as 2*dot - ||v||^2), set to
// NEG_INF where the row fails the query's DNF filter (OR over F terms of AND
// over M int16 attributes, widened to int32) or is dead (id < 0).  Every
// slot is scanned, pads included, as on the TPU.
//
// What bounds it on the H100: a matvec does 2 flops per vector element it
// reads (1 flop/byte for bf16), far below the f32 FMA ridge of ~20, so it is
// bound by bytes: each slot streams its cluster's Vpad*D vectors plus the
// attributes and ids, and writes Vpad f32 scores.  Slots that share a
// cluster can only share its bytes through the 50 MB L2.
//
// This first design: one CTA of 256 threads per (slot, block of 256 rows).
// The CTA stages the slot's query row as f32 and its DNF bounds as int32 in
// shared memory.  Each warp takes 32 rows one after another: the lanes read
// the row with 16-byte vector loads across D (8 bf16, 4 f32 or 16 int8 per
// load; scalar loads where D*bytes is not a multiple of 16), accumulate in
// f32 FMA and reduce with shuffles, and lane i keeps row i's dot.  Then each
// lane applies its own row's epilogue (row constant, DNF test, liveness), so
// the 32 scores are written as one coalesced store.
//
// Left to later PRs: slots of one cluster scheduled together (or the tiled
// kernel's per-tile dedup) so the cluster is read from HBM once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int VT = 256;  // cluster rows per CTA (32 per warp)
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kDot = 0, kL2 = 1, kSq8 = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// acc += the 16 bytes `raw` of row elements times the matching f32 query
// elements q[0 .. 16/sizeof(T)).
__device__ __forceinline__ float dot16(const uint4& raw, const float* q, float acc,
                                       const float*) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 x = *reinterpret_cast<const float4*>(&raw);
  const float4 a = q4[0];
  acc = fmaf(x.x, a.x, acc);
  acc = fmaf(x.y, a.y, acc);
  acc = fmaf(x.z, a.z, acc);
  return fmaf(x.w, a.w, acc);
}
__device__ __forceinline__ float dot16(const uint4& raw, const float* q, float acc,
                                       const __nv_bfloat16*) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 lo = __bfloat1622float2(h[2 * i]);
    const float2 hi = __bfloat1622float2(h[2 * i + 1]);
    const float4 a = q4[i];
    acc = fmaf(lo.x, a.x, acc);
    acc = fmaf(lo.y, a.y, acc);
    acc = fmaf(hi.x, a.z, acc);
    acc = fmaf(hi.y, a.w, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(const uint4& raw, const float* q, float acc,
                                       const int8_t*) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = q4[i];
    acc = fmaf((float)c[i].x, a.x, acc);
    acc = fmaf((float)c[i].y, a.y, acc);
    acc = fmaf((float)c[i].z, a.z, acc);
    acc = fmaf((float)c[i].w, a.w, acc);
  }
  return acc;
}

template <typename TQ, typename TV, int MODE>
__global__ void __launch_bounds__(NT) filtered_scan_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_query,
    int n_clusters, int n_queries, const TQ* __restrict__ queries,
    const int16_t* __restrict__ lo, const int16_t* __restrict__ hi,
    const TV* __restrict__ vectors, const int16_t* __restrict__ attrs,
    const int* __restrict__ ids, const float* __restrict__ aux,
    float* __restrict__ out, int d, int vpad, int m, int f, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);        // [d]
  int* lo_s = reinterpret_cast<int*>(qs + ((d + 3) & ~3));  // [f][m]
  int* hi_s = lo_s + f * m;                              // [f][m]

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.y * VT + warp * 32;  // this warp's first row
  float* out_row = out + (size_t)p * vpad;

  const int cluster = slot_cluster[p];
  const int query = slot_query[p];
  if (cluster < 0 || cluster >= n_clusters || query < 0 || query >= n_queries) {
    const int v = r0 + lane;  // uniform over the CTA
    if (v < vpad) out_row[v] = NEG_INF;
    return;
  }
  for (int e = tid; e < d; e += NT) qs[e] = to_f32(queries[(size_t)query * d + e]);
  for (int e = tid; e < f * m; e += NT) {
    lo_s[e] = (int)lo[(size_t)query * f * m + e];
    hi_s[e] = (int)hi[(size_t)query * f * m + e];
  }
  __syncthreads();
  if (r0 >= vpad) return;  // uniform over the warp

  const size_t crow0 = (size_t)cluster * vpad;
  const int nrows = min(32, vpad - r0);
  float mine = 0.f;  // lane i: the dot of row r0 + i
  constexpr int EPV = 16 / sizeof(TV);  // elements per 16-byte load
  for (int i = 0; i < nrows; ++i) {
    const TV* row = vectors + (crow0 + r0 + i) * d;
    float acc = 0.f;
    if (vec_ok) {
      const uint4* row16 = reinterpret_cast<const uint4*>(row);
      for (int c = lane; c < d / EPV; c += 32)
        acc = dot16(__ldg(row16 + c), qs + c * EPV, acc, (const TV*)nullptr);
    } else {
      for (int e = lane; e < d; e += 32) acc = fmaf(to_f32(row[e]), qs[e], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == i) mine = acc;
  }

  // epilogue: lane i owns row r0 + i
  if (lane >= nrows) return;
  const size_t row = crow0 + r0 + lane;
  float sc = mine;
  if (MODE == kSq8) sc = sc * aux[row];
  if (MODE == kL2) sc = 2.f * sc - aux[row];
  bool ok = ids[row] >= 0;
  if (ok) {
    bool any = false;
    for (int t = 0; t < f && !any; ++t) {
      bool all = true;
      for (int a = 0; a < m && all; ++a) {
        const int av = attrs[row * m + a];
        all = av >= lo_s[t * m + a] && av <= hi_s[t * m + a];
      }
      any = all;
    }
    ok = any;
  }
  out_row[r0 + lane] = ok ? sc : NEG_INF;
}

size_t smem_bytes(int d, int m, int f) {
  return 4 * ((size_t)((d + 3) & ~3) + 2 * (size_t)f * m);
}

template <typename TQ, typename TV, int MODE>
cudaError_t launch(int n_slots, const void* slot_cluster, const void* slot_query,
                   int n_clusters, int n_queries, const void* queries,
                   const void* lo, const void* hi, const void* vectors,
                   const void* attrs, const void* ids, const void* aux,
                   void* out, int d, int vpad, int m, int f, cudaStream_t stream) {
  auto kernel = filtered_scan_kernel<TQ, TV, MODE>;
  const size_t smem = smem_bytes(d, m, f);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec_ok = ((size_t)d * sizeof(TV)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  dim3 grid(n_slots, (vpad + VT - 1) / VT);
  kernel<<<grid, NT, smem, stream>>>(
      (const int*)slot_cluster, (const int*)slot_query, n_clusters, n_queries,
      (const TQ*)queries, (const int16_t*)lo, (const int16_t*)hi,
      (const TV*)vectors, (const int16_t*)attrs, (const int*)ids,
      (const float*)aux, (float*)out, d, vpad, m, f, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  aux is the norms (mode 1) or
// scales (mode 2) pointer, null for mode 0.  Returns a cudaError_t: 0 on a
// successful launch.
extern "C" int filtered_scan_launch(
    int n_slots, const void* slot_cluster, const void* slot_query,
    int n_clusters, int n_queries, const void* queries, const void* lo,
    const void* hi, const void* vectors, const void* attrs, const void* ids,
    const void* aux, void* out, int d, int vpad, int m, int f, int mode,
    int q_dtype, int v_dtype, void* stream) {
  if (n_slots <= 0 || vpad <= 0) return cudaSuccess;
  if (d < 1 || f < 1 || m < 0 || vpad > 65535 * VT) return cudaErrorInvalidValue;
  if (smem_bytes(d, m, f) > 227 * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_ARGS                                                             \
  n_slots, slot_cluster, slot_query, n_clusters, n_queries, queries, lo, hi, \
      vectors, attrs, ids, aux, out, d, vpad, m, f, st
#define FS_FLOAT_PAIRS(M)                                                   \
  if (q_dtype == kF32 && v_dtype == kF32) return launch<float, float, M>(FS_ARGS); \
  if (q_dtype == kBF16 && v_dtype == kBF16)                                 \
    return launch<__nv_bfloat16, __nv_bfloat16, M>(FS_ARGS);                \
  if (q_dtype == kF32 && v_dtype == kBF16)                                  \
    return launch<float, __nv_bfloat16, M>(FS_ARGS);
  if (mode == kDot) {
    FS_FLOAT_PAIRS(kDot)
  } else if (mode == kL2) {
    FS_FLOAT_PAIRS(kL2)
  } else if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8) {
    return launch<float, int8_t, kSq8>(FS_ARGS);
  }
#undef FS_FLOAT_PAIRS
#undef FS_ARGS
  return cudaErrorInvalidValue;
}
