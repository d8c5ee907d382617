// Tiled, probe-deduplicated filtered IVF scan with a streaming per-query
// top-k, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/filtered_scan/filtered_scan.py::
// filtered_scan_tiled (body _tiled_kernel, selection _fold_topk).  Same
// contract: for every unique-probe slot s, score the query tile
// slot_tile[s] (QB rows) against every row of cluster slot_cluster[s]
// (dot; SQ8 dot times the row scale; or l2 as 2*dot - ||v||^2), mask rows
// failing the query's DNF filter (OR over F terms of AND over M int16
// attributes) or dead (id < 0) to NEG_INF, and keep each query row's top k
// (earliest row wins ties) and its pass count.  Slots at position >=
// n_unique[tile] within their tile, or whose cluster lies outside [0, K),
// are pads: their CTAs write (NEG_INF, -1, 0) and exit at once.  Queries are
// the vectors' dtype, or f32 against bf16 vectors (the sharded search passes
// its f32 queries uncast, as the TPU kernel accepts).
//
// What bounds it on the H100: each live slot streams its cluster's
// Vpad*D*2 bytes of bf16 vectors (4.9 MB at Vpad=3200, D=768) and spends
// 2*QB*Vpad*D flops on them, 64 flop/byte at QB=64.  On the bf16 tensor
// cores (989 TFLOP/s, ridge ~295 flop/byte) that is bound by bytes: the
// kernel needs ~260 TFLOP/s to keep up with HBM.  In f32 FMA (67 TFLOP/s)
// it was bound by operations at 23x its bytes bound, so the design is:
//
// - Tensor cores for bf16 vectors (scan_tc_kernel).  One CTA per (live
//   slot, group of 64 query rows) walks the cluster in chunks of 128 rows.
//   The score tile S = Q_tile . V_chunk^T (both operands K-major, a "TN"
//   product) is mma.sync.m16n8k16 bf16 with f32 accumulators, each of 8
//   MMA warps 16 query rows x 64 vector rows, operands read with ldmatrix
//   from padded (conflict-free) shared memory.  mma.sync and not wgmma: at
//   64 flop/byte the bytes bound needs about a quarter of the tensor-core
//   peak, which mma.sync reaches, and its fragment layouts are fixed and
//   documented.
// - Warp specialization.  The epilogue (mask and top-k fold) took as long
//   as streaming the chunk, and stalled it.  So 8 more warps run it: the
//   MMA warps hand each chunk's scores over in one shared tile (named
//   barriers: full / free) and go on streaming and multiplying the next
//   chunk while the epilogue warps mask and fold this one.
// - Asynchronous copies.  Vector tiles of 128 rows x 64 depth (16 KB) flow
//   through a 4-stage cp.async ring that runs across chunk edges, so three
//   tiles are in flight while a tile is multiplied.  bf16 queries are
//   loaded once per CTA and stay resident (64 x D bf16, 97 KB at D=768).
// - f32 queries x bf16 vectors run on the same body: each ring stage also
//   carries the 64-row f32 query slice, split at fragment load into three
//   bf16 terms h = bf16(q), m = bf16(q - h), l = bf16(q - h - m), all
//   multiplied into one f32 accumulator.  The products of bf16 are exact in
//   f32 and |q - h - m - l| <= 2^-27 |q|, so the f32 tolerance holds.
// - The epilogue stays exact.  The accumulators are staged through the
//   shared score tile (their fragment layout is not row-major).  Each
//   epilogue warp owns 8 query rows; lane j holds candidate j of each
//   32-row group of the chunk.  Liveness, the row constant, the DNF test
//   and the pass counts (integer ballots, in registers) come first for 4
//   rows x 128 candidates at once, independent work whose latencies
//   overlap.  Only attributes whose bound interval is narrower than int16's
//   range are tested (flagged once per CTA, bounds packed lo|hi in one
//   word), and a row with a term that tests none (match_all) passes every
//   live row, counted once per chunk.  Then the candidates above a row's
//   running k-th are inserted in row order, one per row per step for 4
//   rows at once: lane j < k holds the row's j-th best (value, id), and a
//   candidate goes after equal entries, so the earliest row wins a tie.
// - Any k.  Both bodies keep each row's list in registers, R = 1, 2, 4 or
//   8 slots a lane (lane j holds ranks j, j+32, ...; an insert shifts every
//   slot one rank, lane 0 of slot s taking lane 31 of slot s-1), so
//   k <= 256 is the same streaming fold (R = 1, k <= 32, is the first
//   design's code unchanged; the tensor-core epilogue masks 4 / 2 / 1 rows
//   at once as R grows, to bound its registers).  k > 256 (up to Vpad)
//   takes a third body, scan_sort_kernel: one CTA per (slot, query row)
//   scores the whole cluster into shared memory and bitonic-sorts it by
//   (value descending, row ascending), the same order as the fold.  It
//   reads a cluster once per query row, so it is slow; no full-size path
//   asks for k > 256.
// - D not a multiple of 8, or unaligned operands, take scalar staging loads
//   into the same ring (the tests' D = 97 and 100); Vpad and D are walked
//   in whole tiles with the ragged edge zero-filled and masked.
//
// f32 x f32 and SQ8 (f32 x int8) run on no full-size path; they keep the
// first design's f32 FMA body (scan_fma_kernel: 64x64 score tiles from
// 64x32 staging slices, each thread a 4x4 micro-tile), as do bf16 shapes
// whose resident query tile would not fit in shared memory (D > ~1000) or
// with M > 16 attributes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;   // query rows per CTA
constexpr int NT = 256;  // FMA body threads; the tensor-core body has 2 x NT
constexpr int RPW = QT / (NT / 32);  // query rows folded by each warp
constexpr int MAX_R = 8;  // register slots a lane: k <= 256 in registers
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kDot = 0, kL2 = 1, kSq8 = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// The value at warp-uniform rank r of a list held R slots a lane.
template <int R>
__device__ __forceinline__ float rank_value(const float (&rv)[R], int r) {
  const int s = r >> 5;
  float x = rv[0];
#pragma unroll
  for (int j = 1; j < R; ++j) x = s == j ? rv[j] : x;
  return __shfl_sync(FULL, x, r & 31);
}

// Where `ins` (uniform over the warp), inserts (cv, ci) after the entries
// >= cv of the warp's k-list: ranks p+1 .. k-1 take the rank below them.
// Branch-free, so several rows' insert chains overlap.
template <int R>
__device__ __forceinline__ void insert_if(float (&rv)[R], int (&ri)[R],
                                          float cv, int ci, int lane, int k,
                                          bool ins) {
  int p = 0;
#pragma unroll
  for (int s = 0; s < R; ++s)
    p += __popc(__ballot_sync(FULL, s * 32 + lane < k && rv[s] >= cv));
#pragma unroll
  for (int s = R - 1; s >= 0; --s) {  // slot s-1 is read before it moves
    float up_v = __shfl_up_sync(FULL, rv[s], 1);
    int up_i = __shfl_up_sync(FULL, ri[s], 1);
    if (s > 0) {
      const float wv = __shfl_sync(FULL, rv[s > 0 ? s - 1 : 0], 31);
      const int wi = __shfl_sync(FULL, ri[s > 0 ? s - 1 : 0], 31);
      up_v = lane == 0 ? wv : up_v;
      up_i = lane == 0 ? wi : up_i;
    }
    const int r = s * 32 + lane;
    const bool shift = ins && r < k && r > p;
    const bool put = ins && r == p;
    rv[s] = shift ? up_v : put ? cv : rv[s];
    ri[s] = shift ? up_i : put ? ci : ri[s];
  }
}

// Inserts the candidates of `cand` (lane order = row order) that beat the
// running k-th into the warp's list (rv, ri): strictly greater, after equal
// entries, so the earlier row wins a tie.
template <int R>
__device__ __forceinline__ void fold(float (&rv)[R], int (&ri)[R], float cand,
                                     int cid, int lane, int k) {
  float kth = rank_value<R>(rv, k - 1);
  unsigned sel = __ballot_sync(FULL, cand > kth);
  while (sel) {
    const int src = __ffs(sel) - 1;
    sel &= sel - 1;
    const float cv = __shfl_sync(FULL, cand, src);
    const int ci = __shfl_sync(FULL, cid, src);
    if (cv > kth) {  // uniform over the warp
      insert_if<R>(rv, ri, cv, ci, lane, k, true);
      kth = rank_value<R>(rv, k - 1);
    }
  }
}

// Writes a warp's k-list to out[0, k): values, and ids where the value is
// not a NEG_INF pad.
template <int R>
__device__ __forceinline__ void write_list(const float (&rv)[R],
                                           const int (&ri)[R], float* out_v,
                                           int* out_i, int lane, int k) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = s * 32 + lane;
    if (r < k) {
      out_v[r] = rv[s];
      out_i[r] = rv[s] > 0.5f * NEG_INF ? ri[s] : -1;
    }
  }
}

template <int R>
__device__ __forceinline__ void init_list(float (&rv)[R], int (&ri)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    rv[s] = NEG_INF;
    ri[s] = -1;
  }
}

// Whether slot s is a pad (dedup pad or cluster out of range).
__device__ __forceinline__ bool is_pad(int s, int tile, int cluster,
                                       const int* n_unique, int u_cap,
                                       int n_clusters) {
  return (n_unique != nullptr && s - tile * u_cap >= n_unique[tile]) ||
         cluster < 0 || cluster >= n_clusters;
}

__device__ __forceinline__ void write_pad(float* out_vals, int* out_ids,
                                          int* out_npass, size_t out_row0,
                                          int nq, int k) {
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
    out_vals[out_row0 * k + e] = NEG_INF;
    out_ids[out_row0 * k + e] = -1;
  }
  for (int e = threadIdx.x; e < nq; e += blockDim.x)
    out_npass[out_row0 + e] = 0;
}

// ---------------------------------------------------------------------------
// f32 FMA body: f32 x f32, SQ8, and the bf16 shapes the tensor-core body
// does not take.
// ---------------------------------------------------------------------------

namespace ffma {

constexpr int VT = 64;  // cluster rows per chunk
constexpr int DK = 32;  // depth per staging step

size_t smem_bytes(int m, int f) {
  size_t floats = QT * (DK + 1) + VT * (DK + 1) + QT * (VT + 1) + VT;
  size_t ints = VT + QT + (size_t)VT * m + 2 * (size_t)QT * f * m;
  return 4 * (floats + ints);
}

template <typename TQ, typename TV, int MODE, int R>
__global__ void __launch_bounds__(NT) scan_fma_kernel(
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
  if (is_pad(s, tile, cluster, n_unique, u_cap, n_clusters)) {
    write_pad(out_vals, out_ids, out_npass, out_row0, nq, k);
    return;  // uniform over the CTA
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

  float rv[RPW][R];
  int ri[RPW][R];
#pragma unroll
  for (int i = 0; i < RPW; ++i) init_list<R>(rv[i], ri[i]);

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
#pragma unroll
      for (int h = 0; h < VT / 32; ++h)
        fold<R>(rv[i], ri[i], ss[r * (VT + 1) + h * 32 + lane],
                idss[h * 32 + lane], lane, k);
    }
    __syncthreads();  // ss and the staged row constants are reused next chunk
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + (NT / 32) * i;
    if (r < nq)
      write_list<R>(rv[i], ri[i], out_vals + (out_row0 + r) * k,
                    out_ids + (out_row0 + r) * k, lane, k);
  }
  __syncthreads();
  for (int e = tid; e < nq; e += NT) out_npass[out_row0 + e] = npass_s[e];
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// Tensor-core body: bf16 vectors against bf16 or f32 queries.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int VT = 128;      // cluster rows per chunk
constexpr int KS = 64;       // depth per ring stage
constexpr int STAGES = 4;    // ring depth: STAGES - 1 tiles in flight
constexpr int BLD = KS + 8;  // bf16 row stride of a vector tile (144 B)
constexpr int FLD = KS + 8;  // f32 row stride of a query slice (288 B)
constexpr int SLD = VT + 8;  // f32 row stride of the score tile
constexpr int MAX_M = 16;    // attributes per row the epilogue stages
constexpr int MPT = VT * MAX_M / NT;  // attribute values staged per thread
constexpr int RB = 4;        // query rows an epilogue warp masks at once

struct Layout {  // byte offsets into dynamic shared memory
  size_t stage, a_res, ss, idss, auxs, bnd, act, attrs, total;
};

__host__ __device__ inline Layout layout(bool f32q, int d, int m, int f) {
  Layout L;
  const size_t dp = (size_t)(d + KS - 1) / KS * KS;
  L.stage = (size_t)VT * BLD * 2 + (f32q ? (size_t)QT * FLD * 4 : 0);
  L.a_res = STAGES * L.stage;  // resident bf16 query tile [QT][dp + 8]
  L.ss = L.a_res + (f32q ? 0 : (size_t)QT * (dp + 8) * 2);
  L.idss = L.ss + (size_t)QT * SLD * 4;
  L.auxs = L.idss + VT * 4;
  L.bnd = L.auxs + VT * 4;
  L.act = L.bnd + (size_t)QT * f * m * 4;
  L.attrs = L.act + (size_t)QT * f * 4;
  L.total = L.attrs + ((size_t)VT * m * 2 + 15) / 16 * 16;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Named barriers: the MMA warps' ring, and the score tile's hand-over
// between the MMA warps (which arrive on kBarFull, then wait on kBarFree)
// and the epilogue warps (the other way round).
enum Barrier { kBarRing = 1, kBarFull = 2, kBarFree = 3 };
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a . b over one m16n8k16 bf16 tile, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// Two f32 values as three bf16x2 terms h + m + l (each difference is exact).
__device__ __forceinline__ void split3(float2 x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const __nv_bfloat162 bh = __floats2bfloat162_rn(x.x, x.y);
  const float2 fh = __bfloat1622float2(bh);
  const float rx = x.x - fh.x, ry = x.y - fh.y;
  const __nv_bfloat162 bm = __floats2bfloat162_rn(rx, ry);
  const float2 fm = __bfloat1622float2(bm);
  h = bits(bh);
  m = bits(bm);
  l = bits(__floats2bfloat162_rn(rx - fm.x, ry - fm.y));
}

// Stages ring tile (v0, d0): VT x KS bf16 vector rows and, for f32 queries,
// the QT x KS f32 query slice.  VEC: 16-byte cp.async (zero-filled past the
// edge); else scalar loads and stores (ragged D or unaligned operands).
template <typename TQ, bool VEC>
__device__ __forceinline__ void issue_tile(unsigned char* stage,
                                           const __nv_bfloat16* vb,
                                           const TQ* qg, int nq, int vpad,
                                           int v0, int d0, int d, int tid) {
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(stage);
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < VT * KS / 8 / NT; ++i) {
      const int e = tid + NT * i, row = e >> 3, c = (e & 7) * 8;
      const bool in = v0 + row < vpad && d0 + c < d;
      cp16(bs + row * BLD + c, in ? vb + (size_t)(v0 + row) * d + d0 + c : vb,
           in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < VT * KS / NT; ++i) {
      const int e = tid + NT * i, row = e / KS, c = e % KS;
      const bool in = v0 + row < vpad && d0 + c < d;
      bs[row * BLD + c] =
          in ? vb[(size_t)(v0 + row) * d + d0 + c] : __float2bfloat16(0.f);
    }
  }
  if constexpr (sizeof(TQ) == 4) {
    float* fs = reinterpret_cast<float*>(stage + VT * BLD * 2);
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < QT * KS / 4 / NT; ++i) {
        const int e = tid + NT * i, row = e >> 4, c = (e & 15) * 4;
        const bool in = row < nq && d0 + c < d;
        cp16(fs + row * FLD + c, in ? qg + (size_t)row * d + d0 + c : qg, in);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < QT * KS / NT; ++i) {
        const int e = tid + NT * i, row = e / KS, c = e % KS;
        const bool in = row < nq && d0 + c < d;
        fs[row * FLD + c] = in ? qg[(size_t)row * d + d0 + c] : 0.f;
      }
    }
  }
}

// Whether attribute row `av` (m int16) passes a query row's DNF: `act` holds
// per term the attributes to test, `bnd` their bounds packed lo | hi << 16.
__device__ __forceinline__ bool dnf_pass(const unsigned* act,
                                         const int* bnd, const int16_t* av,
                                         int f, int m) {
  for (int t = 0; t < f; ++t) {
    unsigned a_set = act[t];
    bool all = true;
    while (a_set && all) {
      const int a = __ffs(a_set) - 1;
      a_set &= a_set - 1;
      const int b = bnd[t * m + a];
      all = av[a] >= (int)(int16_t)(b & 0xffff) && av[a] <= (b >> 16);
    }
    if (all) return true;
  }
  return false;
}

template <typename TQ, int MODE, bool VEC, int R>
__global__ void __launch_bounds__(2 * NT, 1) scan_tc_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const __nv_bfloat16* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k) {
  constexpr bool F32Q = sizeof(TQ) == 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(F32Q, d, m, f);
  float* ss = reinterpret_cast<float*>(smem + L.ss);        // [QT][SLD]
  int* idss = reinterpret_cast<int*>(smem + L.idss);        // [VT]
  float* auxs = reinterpret_cast<float*>(smem + L.auxs);    // [VT]
  int* bnd = reinterpret_cast<int*>(smem + L.bnd);          // [QT][f][m]
  unsigned* act_s = reinterpret_cast<unsigned*>(smem + L.act);  // [QT][f]
  int16_t* attrs_s = reinterpret_cast<int16_t*>(smem + L.attrs);  // [VT][m]

  const int s = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int lane = threadIdx.x & 31;
  const int nq = min(QT, qb - q0);
  const size_t out_row0 = (size_t)s * qb + q0;

  const int tile = slot_tile[s];
  const int cluster = slot_cluster[s];
  if (is_pad(s, tile, cluster, n_unique, u_cap, n_clusters)) {
    write_pad(out_vals, out_ids, out_npass, out_row0, nq, k);
    return;  // uniform over the CTA
  }

  const size_t qrow0 = (size_t)tile * qb + q0;
  const size_t crow0 = (size_t)cluster * vpad;
  const int dp = (d + KS - 1) / KS * KS;
  const int nks = dp / KS;
  const int nch = (vpad + VT - 1) / VT;

  if (threadIdx.x < NT) {
    // ---- the MMA warps: stream the cluster, multiply, hand over tiles ----
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const TQ* qg = queries + qrow0 * d;
    const __nv_bfloat16* vb = vectors + crow0 * d;
    const __nv_bfloat16* a_res =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.a_res);
    const int ald = dp + 8;  // row stride of the resident query tile
    const int total = nch * nks;  // ring tiles

    if constexpr (!F32Q) {  // the resident bf16 query tile, zero-padded
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + L.a_res);
      if constexpr (VEC) {
        for (int e = tid; e < QT * dp / 8; e += NT) {
          const int row = e / (dp / 8), c = (e % (dp / 8)) * 8;
          const bool in = row < nq && c < d;
          cp16(a + row * ald + c, in ? qg + (size_t)row * d + c : qg, in);
        }
      } else {
        for (int e = tid; e < QT * dp; e += NT) {
          const int row = e / dp, c = e % dp;
          a[row * ald + c] = (row < nq && c < d) ? qg[(size_t)row * d + c]
                                                 : __float2bfloat16(0.f);
        }
      }
      cp_commit();
    }
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < total)
        issue_tile<TQ, VEC>(smem + p * L.stage, vb, qg, nq, vpad,
                            (p / nks) * VT, (p % nks) * KS, d, tid);
      cp_commit();
    }

    const int wm = warp & 3;   // query rows wm*16 .. +15
    const int wn = warp >> 2;  // vector rows wn*64 .. +63 of the chunk
    const int g = lane >> 2, tq = lane & 3;
    float acc[8][4];
    int meta_id = -1;
    float meta_aux = 0.f;
    int16_t meta_at[MPT];

    for (int t = 0; t < total; ++t) {
      const int chunk = t / nks, ks = t - chunk * nks;
      if (ks == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
        // the chunk's row constants, handed over with its scores; nothing
        // waits for these loads before the hand-over
        const int v0 = chunk * VT, nv = min(VT, vpad - v0);
        meta_id = -1;
        meta_aux = 0.f;
        if (tid < nv) meta_id = ids[crow0 + v0 + tid];
        if (MODE == kL2 && tid >= VT && tid - VT < nv)
          meta_aux = aux[crow0 + v0 + tid - VT];
#pragma unroll
        for (int j = 0; j < MPT; ++j) {
          const int e = tid + NT * j;
          meta_at[j] = 0;
          if (e < nv * m) meta_at[j] = attrs[(crow0 + v0) * m + e];
        }
      }
      cp_wait<STAGES - 2>();
      bar_sync(kBarRing, NT);
      {
        const int p = t + STAGES - 1;
        if (p < total)
          issue_tile<TQ, VEC>(smem + (p % STAGES) * L.stage, vb, qg, nq,
                              vpad, (p / nks) * VT, (p % nks) * KS, d, tid);
        cp_commit();
      }

      const unsigned char* stage = smem + (t % STAGES) * L.stage;
      const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(stage);
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        constexpr int TERMS = F32Q ? 3 : 1;
        uint32_t a[TERMS][4];
        if constexpr (F32Q) {
          const float* fs =
              reinterpret_cast<const float*>(stage + VT * BLD * 2);
          const float* f0 = fs + (wm * 16 + g) * FLD + kk * 16 + 2 * tq;
          split3(*reinterpret_cast<const float2*>(f0), a[0][0], a[1][0],
                 a[2][0]);
          split3(*reinterpret_cast<const float2*>(f0 + 8 * FLD), a[0][1],
                 a[1][1], a[2][1]);
          split3(*reinterpret_cast<const float2*>(f0 + 8), a[0][2], a[1][2],
                 a[2][2]);
          split3(*reinterpret_cast<const float2*>(f0 + 8 * FLD + 8), a[0][3],
                 a[1][3], a[2][3]);
        } else {
          ldsm_x4(a_res + (wm * 16 + (lane & 15)) * ald + ks * KS + kk * 16 +
                      (lane >> 4) * 8,
                  a[0]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(bs + (wn * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                           BLD +
                      kk * 16 + ((lane >> 3) & 1) * 8,
                  b);
#pragma unroll
          for (int tm = 0; tm < TERMS; ++tm) {
            mma(acc[2 * np], a[tm], b[0], b[1]);
            mma(acc[2 * np + 1], a[tm], b[2], b[3]);
          }
        }
      }

      if (ks == nks - 1) {  // hand the chunk's scores to the epilogue warps
        if (chunk > 0) bar_sync(kBarFree, 2 * NT);  // they are done with ss
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wn * 64 + j * 8 + 2 * tq;
          const int row = wm * 16 + g;
          *reinterpret_cast<float2*>(ss + row * SLD + col) =
              make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(ss + (row + 8) * SLD + col) =
              make_float2(acc[j][2], acc[j][3]);
        }
        if (tid < VT)
          idss[tid] = meta_id;
        else
          auxs[tid - VT] = meta_aux;
#pragma unroll
        for (int j = 0; j < MPT; ++j) {
          const int e = tid + NT * j;
          if (e < VT * m) attrs_s[e] = meta_at[j];
        }
        bar_arrive(kBarFull, 2 * NT);
      }
    }
    cp_wait<0>();
    return;
  }

  // ---- the epilogue warps: mask each handed-over chunk, fold its rows ----
  const int etid = threadIdx.x - NT;
  const int warp = etid >> 5;  // folds query rows warp + 8*i

  // Each query row's bounds, packed lo | hi << 16, and per term the
  // attributes whose interval is narrower than int16's range.
  const int fm = f * m;
  for (int e = etid; e < QT * fm; e += NT) {
    const int r = e / fm;
    const int lv = r < nq ? (int)lo[(qrow0 + r) * fm + e % fm] : 1;
    const int hv = r < nq ? (int)hi[(qrow0 + r) * fm + e % fm] : 0;
    bnd[e] = (int)(((unsigned)lv & 0xffffu) | ((unsigned)hv << 16));
  }
  for (int e = etid; e < QT * f; e += NT) {
    const int r = e / f;
    unsigned act = 0;
    if (r < nq)
      for (int a = 0; a < m; ++a) {
        const size_t o = (qrow0 + r) * fm + (size_t)(e % f) * m + a;
        if (lo[o] > -32768 || hi[o] < 32767) act |= 1u << a;
      }
    act_s[e] = act;
  }

  // rows masked and folded at once: fewer as the lists grow, to bound the
  // registers
  constexpr int RBR = R == 1 ? RB : R == 2 ? 2 : 1;
  float rv[RPW][R];
  int ri[RPW][R], npass[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    init_list<R>(rv[i], ri[i]);
    npass[i] = 0;
  }
  unsigned free_rows = 0;  // bit i: row warp + 8*i passes every live row

  for (int chunk = 0; chunk < nch; ++chunk) {
    bar_sync(kBarFull, 2 * NT);  // the chunk's scores and row constants
    if (chunk == 0)  // the rows with a term that tests no attribute
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + (NT / 32) * i;
        bool free = false;
        for (int t = 0; t < f; ++t) free |= act_s[r * f + t] == 0;
        free_rows |= (unsigned)free << i;
      }
    int idc[VT / 32], n_live = 0;
    float auxc[VT / 32];
    unsigned live[VT / 32];
#pragma unroll
    for (int h = 0; h < VT / 32; ++h) {
      idc[h] = idss[h * 32 + lane];  // -1 past the list end
      auxc[h] = MODE == kL2 ? auxs[h * 32 + lane] : 0.f;
      live[h] = __ballot_sync(FULL, idc[h] >= 0);
      n_live += __popc(live[h]);
    }
    // per half of the warp's rows: row constant, liveness, DNF mask and
    // pass counts of all 128 candidates first (independent, so latencies
    // overlap; a row whose filter has a term that tests no attribute passes
    // every live row, counted once per chunk), then the inserts of those
    // above the running k-th
#pragma unroll
    for (int i0 = 0; i0 < RPW; i0 += RBR) {
      float cand[RBR][VT / 32], kth[RBR];
      unsigned sel[RBR][VT / 32];
#pragma unroll
      for (int i = 0; i < RBR; ++i) {
        const int r = warp + (NT / 32) * (i0 + i);
        kth[i] = rank_value<R>(rv[i0 + i], k - 1);
        if (r < nq && (free_rows >> (i0 + i) & 1)) {  // every live row passes
          npass[i0 + i] += n_live;
#pragma unroll
          for (int h = 0; h < VT / 32; ++h) {
            float sc = ss[r * SLD + h * 32 + lane];
            if (MODE == kL2) sc = 2.f * sc - auxc[h];
            cand[i][h] = sc;
            sel[i][h] = __ballot_sync(FULL, sc > kth[i]) & live[h];
          }
          continue;
        }
        int cnt = 0;
#pragma unroll
        for (int h = 0; h < VT / 32; ++h) {
          const int c = h * 32 + lane;
          float sc = ss[r * SLD + c];
          if (MODE == kL2) sc = 2.f * sc - auxc[h];
          bool ok = r < nq && idc[h] >= 0;
          if (ok)
            ok = dnf_pass(act_s + r * f, bnd + r * fm, attrs_s + c * m, f, m);
          cnt += __popc(__ballot_sync(FULL, ok));
          cand[i][h] = ok ? sc : NEG_INF;
          sel[i][h] = __ballot_sync(FULL, cand[i][h] > kth[i]);
        }
        npass[i0 + i] += cnt;
      }
      // Each step inserts the next selected candidate (in row order) of
      // every row at once: the rows' insert chains are independent, so
      // their shuffle latencies overlap.  After a step each row drops the
      // candidates that no longer beat its k-th.
      while (true) {
        bool more = false;
#pragma unroll
        for (int i = 0; i < RBR; ++i) {
          int h = VT / 32;
          unsigned w = 0;
#pragma unroll
          for (int j = VT / 32 - 1; j >= 0; --j)
            if (sel[i][j]) {
              h = j;
              w = sel[i][j];
            }
          more |= h < VT / 32;  // uniform over the warp
          float ch = cand[i][0];
          int cid = idc[0];
#pragma unroll
          for (int j = 1; j < VT / 32; ++j) {
            ch = h == j ? cand[i][j] : ch;
            cid = h == j ? idc[j] : cid;
          }
          const int src = (__ffs(w) - 1) & 31;
          const float cv = __shfl_sync(FULL, ch, src);
          const int ci = __shfl_sync(FULL, cid, src);
          const bool ins = w != 0 && cv > kth[i];
          insert_if<R>(rv[i0 + i], ri[i0 + i], cv, ci, lane, k, ins);
          kth[i] = rank_value<R>(rv[i0 + i], k - 1);
#pragma unroll
          for (int j = 0; j < VT / 32; ++j) {
            if (j == h) sel[i][j] = w & (w - 1);
            sel[i][j] &= __ballot_sync(FULL, cand[i][j] > kth[i]);
          }
        }
        if (!more) break;
      }
    }
    if (chunk + 1 < nch) bar_arrive(kBarFree, 2 * NT);  // ss may be refilled
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + (NT / 32) * i;
    if (r < nq)
      write_list<R>(rv[i], ri[i], out_vals + (out_row0 + r) * k,
                    out_ids + (out_row0 + r) * k, lane, k);
    if (r < nq && lane == 0) out_npass[out_row0 + r] = npass[i];
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Sort body: k > 256 (up to Vpad), every dtype pair.
// ---------------------------------------------------------------------------

namespace sortk {

constexpr int NTS = 256;  // threads of a sort CTA

// Shared memory of a sort CTA: the cluster's scores and rows padded to a
// power of two p, the query row in f32, its bounds.
size_t smem_bytes(int p, int d, int m, int f) {
  return (size_t)p * 8 + (size_t)d * 4 + (size_t)2 * f * m * 4;
}

// Whether (va, ia) comes before (vb, ib): value descending, row ascending.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <typename TQ, typename TV, int MODE>
__global__ void __launch_bounds__(NTS) scan_sort_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const TV* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k, int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* vals = reinterpret_cast<float*>(smem_raw);  // [p]
  int* rows = reinterpret_cast<int*>(vals + p);       // [p]
  float* qs = reinterpret_cast<float*>(rows + p);     // [d]
  int* lo_s = reinterpret_cast<int*>(qs + d);         // [f][m]
  int* hi_s = lo_s + f * m;                           // [f][m]
  __shared__ int npass_s;

  const int s = blockIdx.x;
  const int r = blockIdx.y;  // query row within the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t out_row = (size_t)s * qb + r;
  const int tile = slot_tile[s];
  const int cluster = slot_cluster[s];
  if (is_pad(s, tile, cluster, n_unique, u_cap, n_clusters)) {
    write_pad(out_vals, out_ids, out_npass, out_row, 1, k);
    return;  // uniform over the CTA
  }
  const size_t qrow = (size_t)tile * qb + r;
  const size_t crow0 = (size_t)cluster * vpad;
  const int fm = f * m;
  for (int e = tid; e < d; e += NTS) qs[e] = to_f32(queries[qrow * d + e]);
  for (int e = tid; e < fm; e += NTS) {
    lo_s[e] = lo[qrow * fm + e];
    hi_s[e] = hi[qrow * fm + e];
  }
  if (tid == 0) npass_s = 0;
  __syncthreads();

  // one warp a row: the score, the row constant, liveness and the DNF test
  for (int v = tid >> 5; v < p; v += NTS / 32) {
    float sc = NEG_INF;
    bool ok = false;
    if (v < vpad) {
      const size_t row = crow0 + v;
      float acc = 0.f;
      for (int e = lane; e < d; e += 32)
        acc = fmaf(qs[e], to_f32(vectors[row * d + e]), acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (MODE == kSq8) acc *= aux[row];
      if (MODE == kL2) acc = 2.f * acc - aux[row];
      ok = ids[row] >= 0;
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
      sc = ok ? acc : NEG_INF;
    }
    if (lane == 0) {
      vals[v] = sc;
      rows[v] = v;
      if (ok) atomicAdd(&npass_s, 1);
    }
  }
  __syncthreads();

  // bitonic sort, best first
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p / 2; i += NTS) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const bool up = (a & size) == 0;
        const float va = vals[a], vb = vals[b];
        const int ra = rows[a], rb = rows[b];
        if (up ? before(vb, rb, va, ra) : before(va, ra, vb, rb)) {
          vals[a] = vb;
          vals[b] = va;
          rows[a] = rb;
          rows[b] = ra;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += NTS) {
    const float v = vals[j];
    out_vals[out_row * k + j] = v;
    out_ids[out_row * k + j] = v > 0.5f * NEG_INF ? ids[crow0 + rows[j]] : -1;
  }
  if (tid == 0) out_npass[out_row] = npass_s;
}

}  // namespace sortk

#define FS_PARAMS                                                          \
  int n_slots, const void *slot_cluster, const void *slot_tile,            \
      const void *n_unique, int u_cap, int n_clusters, const void *queries, \
      const void *lo, const void *hi, const void *vectors,                 \
      const void *attrs, const void *ids, const void *aux, void *out_vals, \
      void *out_ids, void *out_npass, int qb, int d, int vpad, int m,      \
      int f, int k, cudaStream_t stream
#define FS_KERNEL_ARGS(TQ, TV)                                               \
  (const int*)slot_cluster, (const int*)slot_tile, (const int*)n_unique,     \
      u_cap, n_clusters, (const TQ*)queries, (const int16_t*)lo,             \
      (const int16_t*)hi, (const TV*)vectors, (const int16_t*)attrs,         \
      (const int*)ids, (const float*)aux, (float*)out_vals, (int*)out_ids,   \
      (int*)out_npass, qb, d, vpad, m, f, k

constexpr size_t SMEM_MAX = 227 * 1024;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The register slots a lane the k-list needs: 1, 2, 4 or 8 (k <= 256).
inline int list_slots(int k) {
  return k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
}

// k > 256: one CTA per (slot, query row), the cluster sorted in shared
// memory.
template <typename TQ, typename TV, int MODE>
cudaError_t launch_sort(FS_PARAMS) {
  auto kernel = sortk::scan_sort_kernel<TQ, TV, MODE>;
  int p = 1;
  while (p < vpad) p <<= 1;
  const size_t smem = sortk::smem_bytes(p, d, m, f);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_slots, qb);
  kernel<<<grid, sortk::NTS, smem, stream>>>(FS_KERNEL_ARGS(TQ, TV), p);
  return cudaGetLastError();
}

template <typename TQ, typename TV, int MODE, int R>
cudaError_t launch_fma_r(FS_PARAMS) {
  auto kernel = ffma::scan_fma_kernel<TQ, TV, MODE, R>;
  const size_t smem = ffma::smem_bytes(m, f);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_slots, (qb + QT - 1) / QT);
  kernel<<<grid, NT, smem, stream>>>(FS_KERNEL_ARGS(TQ, TV));
  return cudaGetLastError();
}

#define FS_FWD                                                              \
  n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters, queries,   \
      lo, hi, vectors, attrs, ids, aux, out_vals, out_ids, out_npass, qb, d, \
      vpad, m, f, k, stream

template <typename TQ, typename TV, int MODE>
cudaError_t launch_fma(FS_PARAMS) {
  if (k > 32 * MAX_R) return launch_sort<TQ, TV, MODE>(FS_FWD);
  switch (list_slots(k)) {
    case 1: return launch_fma_r<TQ, TV, MODE, 1>(FS_FWD);
    case 2: return launch_fma_r<TQ, TV, MODE, 2>(FS_FWD);
    case 4: return launch_fma_r<TQ, TV, MODE, 4>(FS_FWD);
    default: return launch_fma_r<TQ, TV, MODE, 8>(FS_FWD);
  }
}

template <typename TQ, int MODE, bool VEC, int R>
cudaError_t launch_tc_r(FS_PARAMS) {
  auto kernel = tc::scan_tc_kernel<TQ, MODE, VEC, R>;
  const size_t smem = tc::layout(sizeof(TQ) == 4, d, m, f).total;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_slots, (qb + QT - 1) / QT);
  kernel<<<grid, 2 * NT, smem, stream>>>(FS_KERNEL_ARGS(TQ, __nv_bfloat16));
  return cudaGetLastError();
}

template <typename TQ, int MODE, bool VEC>
cudaError_t launch_tc(FS_PARAMS) {
  switch (list_slots(k)) {
    case 1: return launch_tc_r<TQ, MODE, VEC, 1>(FS_FWD);
    case 2: return launch_tc_r<TQ, MODE, VEC, 2>(FS_FWD);
    case 4: return launch_tc_r<TQ, MODE, VEC, 4>(FS_FWD);
    default: return launch_tc_r<TQ, MODE, VEC, 8>(FS_FWD);
  }
}

// Whether the tensor-core body takes bf16 vectors at these shapes: at most
// MAX_M attributes, and its shared memory fits.
bool tc_fits(bool f32q, int d, int m, int f) {
  return m <= tc::MAX_M && tc::layout(f32q, d, m, f).total <= SMEM_MAX;
}

// bf16 vectors: the tensor-core body where it fits (k <= 256), else the
// FMA or sort body.
template <typename TQ, int MODE>
cudaError_t launch_bf16(FS_PARAMS) {
  if (!tc_fits(sizeof(TQ) == 4, d, m, f) || k > 32 * MAX_R)
    return launch_fma<TQ, __nv_bfloat16, MODE>(
        n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters,
        queries, lo, hi, vectors, attrs, ids, aux, out_vals, out_ids,
        out_npass, qb, d, vpad, m, f, k, stream);
  const bool vec = d % 8 == 0 && (uintptr_t)queries % 16 == 0 &&
                   (uintptr_t)vectors % 16 == 0;
  return (vec ? launch_tc<TQ, MODE, true> : launch_tc<TQ, MODE, false>)(
      n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters, queries,
      lo, hi, vectors, attrs, ids, aux, out_vals, out_ids, out_npass, qb, d,
      vpad, m, f, k, stream);
}

}  // namespace

// Which body the launcher picks for these operands: 1 = tensor cores,
// 0 = f32 FMA, -1 = refused.  For the tests and the timing script.
extern "C" int filtered_scan_tiled_body(int d, int m, int f, int mode,
                                        int q_dtype, int v_dtype) {
  if (v_dtype == kBF16 && (q_dtype == kBF16 || q_dtype == kF32) &&
      (mode == kDot || mode == kL2))
    return tc_fits(q_dtype == kF32, d, m, f);
  if ((mode == kDot || mode == kL2) && q_dtype == kF32 && v_dtype == kF32)
    return 0;
  if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8) return 0;
  return -1;
}

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
  if (k < 1 || k > vpad || qb < 1 || d < 1 || f < 1 || m < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_ARGS                                                               \
  n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters, queries, lo, \
      hi, vectors, attrs, ids, aux, out_vals, out_ids, out_npass, qb, d,      \
      vpad, m, f, k, st
  if (mode == kDot && q_dtype == kBF16 && v_dtype == kBF16)
    return launch_bf16<__nv_bfloat16, kDot>(FS_ARGS);
  if (mode == kDot && q_dtype == kF32 && v_dtype == kBF16)  // sharded search
    return launch_bf16<float, kDot>(FS_ARGS);
  if (mode == kL2 && q_dtype == kBF16 && v_dtype == kBF16)
    return launch_bf16<__nv_bfloat16, kL2>(FS_ARGS);
  if (mode == kL2 && q_dtype == kF32 && v_dtype == kBF16)
    return launch_bf16<float, kL2>(FS_ARGS);
  if (mode == kDot && q_dtype == kF32 && v_dtype == kF32)
    return launch_fma<float, float, kDot>(FS_ARGS);
  if (mode == kL2 && q_dtype == kF32 && v_dtype == kF32)
    return launch_fma<float, float, kL2>(FS_ARGS);
  if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8)
    return launch_fma<float, int8_t, kSq8>(FS_ARGS);
#undef FS_ARGS
  return cudaErrorInvalidValue;
}
