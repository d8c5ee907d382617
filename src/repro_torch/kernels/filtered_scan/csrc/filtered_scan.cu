// Per-probe filtered IVF scan for NVIDIA Hopper (sm_90a): masked scores of
// one query against every row of one cluster, for each (query, probe) slot.
//
// Replaces the TPU kernel repro/kernels/filtered_scan/filtered_scan.py::
// filtered_scan (bodies _scan_kernel_dot, _scan_kernel_dot_q8 and
// _scan_kernel_l2).  Same contract: for every slot p, the row
// out[p, v] = score(queries[slot_query[p]], vectors[slot_cluster[p], v])
// (dot; SQ8 dot times the row scale; or l2 as 2*dot - ||v||^2), set to
// NEG_INF where the row fails the query's DNF filter (OR over F terms of AND
// over M int16 attributes, widened to int32) or is dead (id < 0).  A slot
// whose cluster or query is out of range gets a row of NEG_INF.  Every
// slot's row is written, pads included.
//
// What bounds it on the H100.  A matvec does 2 flops per vector element it
// reads (1 flop/byte in bf16), far below the f32 FMA ridge of ~20, so it is
// bound by bytes.  What the function must read is each DISTINCT cluster
// once: the sharded search's uniform batch has 3592 slots over about 1360
// clusters, 6.8 GB of rows (3200 rows x 1560 B each) = 2.0 ms at 3.35 TB/s.
// The arithmetic of its distinct (cluster, query) pairs, 2 x 1793 x 3200 x
// 768 = 8.8 GFLOP, is 0.13 ms at the 67 TFLOP/s f32 FMA peak.  The first
// design (one CTA per slot and 256 rows) streamed a cluster once per slot
// that probes it (5.35 ms of bytes if L2 shared nothing) and computed the
// ~1800 dispatch pads (cluster 0, query 0) once each; it took 4.2 ms.
//
// This design reads each distinct cluster's rows once from HBM and computes
// each distinct (cluster, query) pair once:
//
// 1. A cluster-major schedule, built on the card by plan_kernel (one CTA
//    of 1024 threads, launched by the same entry point on the caller's
//    stream; no host sync).  Each slot becomes one 64-bit word (cluster |
//    query | slot), bitonic-sorted in shared memory: strides of 64 and up
//    through shared memory, the shorter ones in registers within a warp
//    (warp shuffles), so the sort takes 28 barriers, not 78, at 4096.  A run
//    of equal (cluster, query) is one PAIR that keeps the run of slots it
//    fans out to: all the dispatch pads become one pair.  Each cluster's
//    pairs are cut into CHUNKS of at most g <= GMAX queries.  Slots out of
//    range share one cluster field that sorts after every real one, so they
//    form one pair whose chunk only writes NEG_INF.  A WORK ITEM is
//    (chunk, block of RB = 128 rows); items are numbered cluster by
//    cluster, and within a cluster row block by row block with the chunks
//    innermost, so the chunks of a cluster probed by more than g queries
//    read each row block from L2 within a few items of each other.  The
//    plan writes the count of items to the scratch; scan_kernel is a
//    persistent grid (SMs x resident CTAs) whose CTAs take items from a
//    counter with atomicAdd until the count is reached.  Tables longer
//    than PLAN_CAP slots are planned and scanned PLAN_CAP slots at a time.
// 2. Each work item's rows are streamed once, through a 4-stage cp.async
//    ring of 128 rows x 128 bytes of depth (16-byte copies; rows of 144
//    bytes in shared memory, so the 16-byte reads below are free of bank
//    conflicts); the attributes, ids and row constants ride the item's
//    first stage.  The ring runs on across items: a CTA takes its next item
//    when it starts one, and that item's first tiles and row constants load
//    behind this one's last tiles, so the ring does not drain at item
//    edges.  Two CTAs of ~110 KB sit on each SM, 6 stages (~110 KB) in
//    flight per SM, well above the ~25 KB that 3.35 TB/s x ~1 us of
//    latency asks of each of 132 SMs.
// 3. f32 FMA from shared memory, no cross-lane reductions: two threads own
//    a row (SPLIT = 2, 256 threads a CTA), each summing every other 16-byte
//    piece of it against each query of the chunk, four independent sums a
//    query so the FMAs do not wait on each other; the chunk's queries are
//    staged once per item as f32 and read as broadcast float4.  The two
//    halves meet once per item in shared memory.  No tensor cores: the
//    arithmetic is ~0.13 ms against ~2.0 ms of bytes, and f32 FMA keeps
//    f32 x bf16 exact to f32 accumulation with no bf16 split of the
//    queries.  One thread a row left too few warps to hide the sums behind
//    the stream (8 a SM; chip_smoke.py --variants times FS_SPLIT=1).
// 4. Epilogue per (row, pair): the row constant (SQ8 scale, or 2*dot -
//    ||v||^2), liveness (id >= 0) and the pair's DNF bounds (staged as
//    int32) give the score, kept in shared memory.  Then each warp writes
//    whole 128-column rows of the pair's slots, loading 32 slot ids at a
//    time, so a pair with many slots (the pads: ~1800) is written by all 8
//    warps of each of its Vpad / RB row-block items.
// 5. Row offsets are size_t (K*Vpad*D = 7.8e9).  Where D*bytes is not a
//    multiple of 16, each row's 128-byte slice is staged as the 16-byte
//    aligned span that holds it (at most 144 bytes) and read element by
//    element from its offset; any Vpad works (the last row block is short).
//
// Compile-time switches for experiments (the default builds the kernel as
// shipped; chip_smoke.py --variants times them): -DFS_VARIANT=1 streams the
// rows and does nothing else; -DFS_VARIANT=2 adds the sums and the epilogue
// but writes each pair's score to its first slot only (no fan-out);
// -DFS_VARIANT=3 runs the plan alone; -DFS_SPLIT=1 gives each row one
// thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FS_VARIANT
#define FS_VARIANT 0
#endif
#ifndef FS_SPLIT
#define FS_SPLIT 2
#endif

namespace {

constexpr int RB = 128;            // rows of a work item
constexpr int SPLIT = FS_SPLIT;    // threads that share a row
constexpr int NT = RB * SPLIT;     // threads of a scan CTA
constexpr int TILE_BYTES = 128;    // depth of a ring stage, in bytes
constexpr int STRIDE = TILE_BYTES + 16;  // a staged row in shared memory
constexpr int STAGES = 4;
constexpr size_t SMEM_CAP = 110 * 1024;  // two CTAs an SM; sets g
constexpr int GMAX = 8;            // queries per chunk at most
constexpr int PLAN_NT = 1024;      // threads of the plan CTA
constexpr int PLAN_CAP = 8192;     // slots one plan sorts (8 per thread)
constexpr int PLAN_E = PLAN_CAP / PLAN_NT;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
// A slot's sort word: cluster (cbits) | query (qbits) | the slot's place in
// the plan (SLOT_BITS), so one 64-bit compare orders by (cluster, query) and
// the word carries its slot.  The field widths follow the operands: qbits
// holds every query index (Q < 2^qbits) and cbits every cluster index plus
// the all-ones field `bad` that slots out of range take (after every real
// cluster, query field 0); the launcher checks cbits + qbits + SLOT_BITS
// <= 64.  The sort's padding, all ones, sorts after everything.
constexpr int SLOT_BITS = 13;   // PLAN_CAP slots
constexpr unsigned long long kPadKey = ~0ull;
static_assert(PLAN_CAP <= (1 << SLOT_BITS), "a plan's slots fit SLOT_BITS");

enum Mode { kDot = 0, kL2 = 1, kSq8 = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The plan in the scratch, for a table of at most n_max slots.
struct Plan {
  int* counters;          // [0] work items, [1] items taken
  int* sorted_slot;       // [n_max] slots by (cluster, query)
  int* pair_begin;        // [n_max + 1] a pair's first position in sorted_slot
  int* pair_query;        // [n_max]
  int* chunk_pair_begin;  // [n_max + 1]
  int* chunk_cluster;     // [n_max]
  int* chunk_first;       // [n_max] first chunk of the chunk's cluster
  int* chunk_count;       // [n_max] chunks of the chunk's cluster
};

Plan plan_at(int* scratch, int n_max) {
  Plan p;
  p.counters = scratch;
  p.sorted_slot = scratch + 4;
  p.pair_begin = p.sorted_slot + n_max;
  p.pair_query = p.pair_begin + n_max + 1;
  p.chunk_pair_begin = p.pair_query + n_max;
  p.chunk_cluster = p.chunk_pair_begin + n_max + 1;
  p.chunk_first = p.chunk_cluster + n_max;
  p.chunk_count = p.chunk_first + n_max;
  return p;
}

size_t scratch_ints(int n_max) { return 4 + 7 * (size_t)n_max + 2; }

// ---------------------------------------------------------------- the plan

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxOp {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Exclusive scan of one int per thread over the PLAN_NT threads (identity
// 0 for both ops used here); *total gets the whole.  ws: 32 ints of shared
// memory.  Every thread must call it.
template <typename Op>
__device__ int block_scan(int v, int* ws, int* total, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = op(x, y);
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = ws[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w = op(w, y);
    }
    ws[lane] = w;
  }
  __syncthreads();
  const int before = warp > 0 ? ws[warp - 1] : 0;
  const int prev = __shfl_up_sync(FULL, x, 1);
  const int excl = lane > 0 ? op(before, prev) : before;
  *total = ws[31];
  __syncthreads();  // ws is free again
  return excl;
}

// Steps j = j_top, j_top / 2, .., 1 of bitonic stage k (ascending where
// bit k of the index is clear) on a 64-element segment held by one warp:
// a0 is element i (= segment start + lane), a1 is element i + 32.
__device__ __forceinline__ void segment_steps(unsigned long long& a0,
                                              unsigned long long& a1, int i,
                                              int k, int j_top) {
  for (int j = j_top; j > 0; j >>= 1) {
    if (j == 32) {  // a0 and a1 are the pair
      const unsigned long long lo = a0 < a1 ? a0 : a1, hi = a0 < a1 ? a1 : a0;
      const bool up = (i & k) == 0;
      a0 = up ? lo : hi;
      a1 = up ? hi : lo;
    } else {  // the pair is lane ^ j; the lower index keeps the min going up
      const unsigned long long b0 = __shfl_xor_sync(FULL, a0, j);
      const unsigned long long b1 = __shfl_xor_sync(FULL, a1, j);
      const bool min0 = ((i & j) == 0) == ((i & k) == 0);
      const bool min1 = (((i + 32) & j) == 0) == (((i + 32) & k) == 0);
      a0 = (a0 < b0) == min0 ? a0 : b0;
      a1 = (a1 < b1) == min1 ? a1 : b1;
    }
  }
}

// Plans slots [base, base + n) (n <= PLAN_CAP): sorts them by (cluster,
// query), collapses equal keys into pairs, cuts each cluster's pairs into
// chunks of at most g, and writes the work-item count.  One CTA of PLAN_NT
// threads; pc (a power of two >= n, >= PLAN_NT) keys in shared memory.
__global__ void __launch_bounds__(PLAN_NT) plan_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_query,
    int base, int n, int pc, int n_clusters, int n_queries, int qbits,
    unsigned long long bad, int g, int n_rb, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem_raw);
  __shared__ int ws[32];
  const int tid = threadIdx.x;

  for (int i = tid; i < pc; i += PLAN_NT) {
    unsigned long long k = kPadKey;
    if (i < n) {
      const int c = slot_cluster[base + i], q = slot_query[base + i];
      const bool ok = c >= 0 && c < n_clusters && q >= 0 && q < n_queries;
      k = (ok ? ((unsigned long long)c << qbits | (unsigned)q)
              : bad << qbits) << SLOT_BITS | (unsigned)i;
    }
    key[i] = k;
  }
  __syncthreads();
  // bitonic sort, ascending (the words are distinct).  Steps of stride
  // j >= 64 go through shared memory, one barrier each; the strides below
  // 64 run on 64-element segments held by one warp in registers.
  const int lane = tid & 31, warp = tid >> 5;
  for (int sg = warp; sg < pc / 64; sg += PLAN_NT / 32) {
    const int b0 = sg * 64;
    unsigned long long a0 = key[b0 + lane], a1 = key[b0 + 32 + lane];
    for (int k = 2; k <= 64; k <<= 1) segment_steps(a0, a1, b0 + lane, k, k >> 1);
    key[b0 + lane] = a0;
    key[b0 + 32 + lane] = a1;
  }
  __syncthreads();
  for (int k = 128; k <= pc; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int q = tid; q < pc / 2; q += PLAN_NT) {  // q: one compared pair
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));  // bit j clear
        const int ixj = i | j;
        const unsigned long long a = key[i], b = key[ixj];
        if ((a > b) == ((i & k) == 0)) {
          key[i] = b;
          key[ixj] = a;
        }
      }
      __syncthreads();
    }
    for (int sg = warp; sg < pc / 64; sg += PLAN_NT / 32) {
      const int b0 = sg * 64;
      unsigned long long a0 = key[b0 + lane], a1 = key[b0 + 32 + lane];
      segment_steps(a0, a1, b0 + lane, k, 32);
      key[b0 + lane] = a0;
      key[b0 + 32 + lane] = a1;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += PLAN_NT)
    plan.sorted_slot[i] = base + (int)(key[i] & ((1u << SLOT_BITS) - 1));

  // pairs: runs of equal keys.  Thread t owns positions [t*E, t*E + E).
  const int e_per = pc / PLAN_NT;
  const int i0 = tid * e_per;
  unsigned long long kk[PLAN_E];
  int cnt = 0;
  unsigned heads = 0;
#pragma unroll
  for (int e = 0; e < PLAN_E; ++e) {
    const int i = i0 + e;
    kk[e] = kPadKey;
    if (e < e_per && i < n) {
      kk[e] = key[i] >> SLOT_BITS;  // (cluster, query)
      if (i == 0 || key[i - 1] >> SLOT_BITS != kk[e]) {
        heads |= 1u << e;
        ++cnt;
      }
    }
  }
  int n_pairs;
  int run = block_scan(cnt, ws, &n_pairs, SumOp());  // also orders the reads
#pragma unroll                                       // before the writes
  for (int e = 0; e < PLAN_E; ++e) {
    if (heads >> e & 1u) {
      const int p = run++;
      key[p] = kk[e];  // compacted pair keys (p <= i)
      plan.pair_begin[p] = i0 + e;
      plan.pair_query[p] = (int)(kk[e] & ((1ull << qbits) - 1));
    }
  }
  if (tid == 0) plan.pair_begin[n_pairs] = n;
  __syncthreads();

  // chunks: each cluster's pairs cut g at a time.  cfirst = the cluster's
  // first pair, a max-scan of the cluster heads' positions.
  int cand[PLAN_E];
  unsigned cl[PLAN_E];
  int m = 0;
#pragma unroll
  for (int e = 0; e < PLAN_E; ++e) {
    const int j = i0 + e;
    cand[e] = 0;
    cl[e] = 0;
    if (e < e_per && j < n_pairs) {
      cl[e] = (unsigned)(key[j] >> qbits);  // pair keys now
      if (j == 0 || (unsigned)(key[j - 1] >> qbits) != cl[e]) cand[e] = j;
    }
    m = max(m, cand[e]);
    cand[e] = m;  // inclusive within the thread
  }
  int dummy;
  const int carry = block_scan(m, ws, &dummy, MaxOp());
  cnt = 0;
  unsigned chunk_heads = 0;
#pragma unroll
  for (int e = 0; e < PLAN_E; ++e) {
    const int j = i0 + e;
    cand[e] = max(carry, cand[e]);  // now cfirst
    if (e < e_per && j < n_pairs && (j - cand[e]) % g == 0) {
      chunk_heads |= 1u << e;
      ++cnt;
    }
  }
  int n_chunks;
  run = block_scan(cnt, ws, &n_chunks, SumOp());
#pragma unroll
  for (int e = 0; e < PLAN_E; ++e) {
    const int j = i0 + e;
    if (!(e < e_per && j < n_pairs)) continue;
    if (chunk_heads >> e & 1u) {
      plan.chunk_pair_begin[run] = j;
      plan.chunk_cluster[run] = cl[e] == bad ? -1 : (int)cl[e];
      ++run;
    }
    const int cid = run - 1;
    if (j == n_pairs - 1 || (unsigned)(key[j + 1] >> qbits) != cl[e]) {
      const int cf = cand[e];  // the cluster's last pair: describe its chunks
      const int nch = (j - cf) / g + 1;
      const int c0 = cid - (j - cf) / g;
      for (int x = 0; x < nch; ++x) {
        plan.chunk_first[c0 + x] = c0;
        plan.chunk_count[c0 + x] = nch;
      }
    }
  }
  if (tid == 0) {
    plan.chunk_pair_begin[n_chunks] = n_pairs;
    plan.counters[0] = n_chunks * n_rb;
    plan.counters[1] = 0;
  }
}

// ---------------------------------------------------------------- the scan

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// The 16 bytes `raw` as f32 elements.
__device__ __forceinline__ void unpack(const uint4& raw, float* x, const float*) {
  const float4 v = *reinterpret_cast<const float4*>(&raw);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& raw, float* x,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float* x, const int8_t*) {
  const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[4 * i] = (float)c[i].x;
    x[4 * i + 1] = (float)c[i].y;
    x[4 * i + 2] = (float)c[i].z;
    x[4 * i + 3] = (float)c[i].w;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_ring() {  // all but the newest STAGES-2
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages the bytes [src, src + nbytes) as the 16-byte aligned span holding
// them; returns where src lands past dst.  (An aligned 16-byte block that
// holds a byte of the tensor lies in the tensor's mapped pages.)
__device__ __forceinline__ int stage_span(unsigned char* dst, const void* src,
                                          size_t nbytes) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = b & ~(uintptr_t)15;
  const int n16 = nbytes ? (int)((b + nbytes - a + 15) / 16) : 0;
  for (int i = threadIdx.x; i < n16; i += NT)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(a + 16 * i));
  return (int)(b - a);
}

size_t span_bytes(size_t nbytes) { return (nbytes + 31) & ~(size_t)15; }

struct ScanSmem {  // byte offsets into the dynamic shared memory
  size_t qs, lo, hi, part, attrs[2], ids[2], aux[2], total;
};

ScanSmem scan_smem(int d, int m, int f, int g) {
  ScanSmem s;
  size_t o = (size_t)STAGES * RB * STRIDE;
  s.qs = o;
  o += (size_t)g * ((d + 3) & ~3) * 4;
  s.lo = o;
  o += (size_t)g * f * m * 4;
  s.hi = o;
  o += (size_t)g * f * m * 4;
  s.part = o;
  o += (size_t)(SPLIT > 1 ? SPLIT - 1 : 1) * GMAX * RB * 4;
  o = (o + 15) & ~(size_t)15;
  for (int b = 0; b < 2; ++b) {  // the row constants of two items
    s.attrs[b] = o;
    o += span_bytes((size_t)RB * m * 2);
    s.ids[b] = o;
    o += span_bytes((size_t)RB * 4);
    s.aux[b] = o;
    o += span_bytes((size_t)RB * 4);
  }
  s.total = o;
  return s;
}

struct Item {  // a work item: one chunk's pairs against one row block
  int cluster, r0, rows, pb, np;  // cluster -1: no item
};

// The item w: a cluster's items run row block by row block, its chunks
// innermost, so w / n_rb is one of the cluster's chunks.
__device__ __forceinline__ Item decode(const Plan& plan, int w, int n_rb,
                                       int vpad) {
  const int guess = w / n_rb;
  const int cf = plan.chunk_first[guess], nc = plan.chunk_count[guess];
  const int local = w - cf * n_rb;
  const int chunk = cf + local % nc;
  Item it;
  it.cluster = plan.chunk_cluster[chunk];
  it.r0 = local / nc * RB;
  it.rows = min(RB, vpad - it.r0);
  it.pb = plan.chunk_pair_begin[chunk];
  it.np = plan.chunk_pair_begin[chunk + 1] - it.pb;
  return it;
}

// Takes the CTA's next item to scan (every thread calls it, after a
// __syncthreads that follows every read of *s_item).  The item of the slots
// out of range is written on the way, rows of NEG_INF.
__device__ Item take_item(const Plan& plan, int n_items, int n_rb, int vpad,
                          int* s_item, float* __restrict__ out) {
  for (;;) {
    if (threadIdx.x == 0) *s_item = atomicAdd(plan.counters + 1, 1);
    __syncthreads();
    const int w = *s_item;
    __syncthreads();
    if (w >= n_items) return Item{-1, 0, 0, 0, 0};
    const Item it = decode(plan, w, n_rb, vpad);
    if (it.cluster >= 0) return it;
    for (int j = 0; j < it.np; ++j) {  // the slots out of range
      const int e = plan.pair_begin[it.pb + j + 1];
      for (int s = plan.pair_begin[it.pb + j]; s < e; ++s)
        for (int v = threadIdx.x; v < it.rows; v += NT)
          out[(size_t)plan.sorted_slot[s] * vpad + it.r0 + v] = NEG_INF;
    }
  }
}

// Issues the copies of depth tile t of an item's rows into ring stage dst.
template <typename TV, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const TV* __restrict__ vectors,
                                          size_t crow0, int rows, int d, int t) {
  constexpr int ES = sizeof(TV);
  constexpr int DK = TILE_BYTES / ES;
  constexpr int CPR = VEC ? TILE_BYTES / 16 : STRIDE / 16;  // copies a row
  const int k0 = t * DK;
  const int lbytes = min(DK, d - k0) * ES;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += NT) {
    const int r = idx / CPR, c = idx - r * CPR;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(vectors + (crow0 + r) * d + k0);
    if (VEC) {
      if (c * 16 < lbytes) cp_async16(dst + r * STRIDE + c * 16, src + c * 16);
    } else {
      const uintptr_t b = reinterpret_cast<uintptr_t>(src);
      const uintptr_t a = b & ~(uintptr_t)15;
      if ((uintptr_t)c * 16 < b - a + lbytes)
        cp_async16(dst + r * STRIDE + c * 16,
                   reinterpret_cast<const void*>(a + c * 16));
    }
  }
}

// Stages an item's row constants (attributes, ids, norms or scales).
template <int MODE>
__device__ __forceinline__ void load_rows(unsigned char* smem,
                                          const ScanSmem& lay, int b,
                                          const int16_t* attrs, const int* ids,
                                          const float* aux, size_t crow0,
                                          int rows, int m) {
  stage_span(smem + lay.attrs[b], attrs + crow0 * m, (size_t)rows * m * 2);
  stage_span(smem + lay.ids[b], ids + crow0, (size_t)rows * 4);
  if (MODE != kDot) stage_span(smem + lay.aux[b], aux + crow0, (size_t)rows * 4);
}

// The scan: a persistent CTA takes work items one after another.  Its ring
// positions run on across items: while item k's last tiles are summed, the
// first tiles of item k + 1 (taken when item k starts) and its row
// constants are already loading, so the ring does not drain at item edges.
// SPLIT threads share a row, each summing every SPLIT-th 16-byte piece.
template <typename TQ, typename TV, int MODE, bool VEC>
__global__ void __launch_bounds__(NT, 512 / NT) scan_kernel(
    Plan plan, int n_rb, const TQ* __restrict__ queries,
    const int16_t* __restrict__ lo, const int16_t* __restrict__ hi,
    const TV* __restrict__ vectors, const int16_t* __restrict__ attrs,
    const int* __restrict__ ids, const float* __restrict__ aux,
    float* __restrict__ out, int d, int vpad, int m, int f, ScanSmem lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + lay.qs);  // [g][dq]
  int* lo_s = reinterpret_cast<int*>(smem + lay.lo);    // [g][f][m]
  int* hi_s = reinterpret_cast<int*>(smem + lay.hi);
  // [SPLIT-1][GMAX][RB] shares of the sums, then [GMAX][RB] scores
  float* part = reinterpret_cast<float*>(smem + lay.part);
  __shared__ int s_item;
  __shared__ int s_query[GMAX], s_begin[GMAX], s_end[GMAX];
  constexpr int ES = sizeof(TV);
  constexpr int DK = TILE_BYTES / ES;  // depth of a stage, in elements
  constexpr int EPV = 16 / ES;         // elements per 16-byte read
  const int tid = threadIdx.x;
  const int row = tid % RB, h = tid / RB;  // h: which share of the depth
  const int dq = (d + 3) & ~3;
  const int fm = f * m;
  const int n_items = plan.counters[0];
  const int n_tiles = (d + DK - 1) / DK;
  const bool ahead = n_tiles >= STAGES - 1;  // look-ahead fits in one item

  Item cur = take_item(plan, n_items, n_rb, vpad, &s_item, out);
  if (cur.cluster < 0) return;
  int base = 0;  // ring position of the item's first tile
  int buf = 0;   // row-constant buffer of the item
  load_rows<MODE>(smem, lay, buf, attrs, ids, aux,
                  (size_t)cur.cluster * vpad + cur.r0, cur.rows, m);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles)
      load_tile<TV, VEC>(smem + (size_t)(t % STAGES) * RB * STRIDE, vectors,
                         (size_t)cur.cluster * vpad + cur.r0, cur.rows, d, t);
    cp_commit();
  }

  for (;;) {
    const size_t crow0 = (size_t)cur.cluster * vpad + cur.r0;
    if (tid < cur.np) {
      s_query[tid] = plan.pair_query[cur.pb + tid];
      s_begin[tid] = plan.pair_begin[cur.pb + tid];
      s_end[tid] = plan.pair_begin[cur.pb + tid + 1];
    }
    // the next item, so its first tiles can load behind this one's last
    const Item nxt = take_item(plan, n_items, n_rb, vpad, &s_item, out);
    for (int j = 0; j < cur.np; ++j) {
      const TQ* qrow = queries + (size_t)s_query[j] * d;
      for (int e = tid; e < d; e += NT) qs[j * dq + e] = to_f32(qrow[e]);
    }
    for (int idx = tid; idx < cur.np * fm; idx += NT) {
      const int j = idx / fm, r = idx - j * fm;
      lo_s[idx] = (int)lo[(size_t)s_query[j] * fm + r];
      hi_s[idx] = (int)hi[(size_t)s_query[j] * fm + r];
    }
    const size_t nrow0 = (size_t)nxt.cluster * vpad + nxt.r0;

    // four independent sums per query (elements e % 4), added at the end,
    // so one query's FMAs do not wait on each other
    float acc[GMAX][4];
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      cp_wait_ring();
      __syncthreads();  // tile t is in; every thread is done with tile t - 1
      {
        const int u = t + STAGES - 1;  // the tile to issue, past t
        unsigned char* dst = smem + (size_t)((base + u) % STAGES) * RB * STRIDE;
        if (u < n_tiles) {
          load_tile<TV, VEC>(dst, vectors, crow0, cur.rows, d, u);
        } else if (ahead && nxt.cluster >= 0) {
          if (u == n_tiles)
            load_rows<MODE>(smem, lay, buf ^ 1, attrs, ids, aux, nrow0,
                            nxt.rows, m);
          load_tile<TV, VEC>(dst, vectors, nrow0, nxt.rows, d, u - n_tiles);
        }
        cp_commit();
      }
#if FS_VARIANT != 1
      if (row < cur.rows) {
        const unsigned char* rowp =
            smem + (size_t)((base + t) % STAGES) * RB * STRIDE + row * STRIDE;
        const int k0 = t * DK;
        const int len = min(DK, d - k0);
        const float* qk = qs + k0;
        if (VEC) {
          const int n16 = len / EPV;
#pragma unroll
          for (int c0 = 0; c0 < DK / EPV; c0 += SPLIT) {
            const int c = c0 + h;
            if (c >= n16) break;
            const uint4 raw = *reinterpret_cast<const uint4*>(rowp + c * 16);
            float x[EPV];
            unpack(raw, x, (const TV*)nullptr);
#pragma unroll
            for (int j = 0; j < GMAX; ++j) {
              if (j < cur.np) {
                const float* qj = qk + j * dq + c * EPV;
#pragma unroll
                for (int e = 0; e < EPV; e += 4) {
                  const float4 a = *reinterpret_cast<const float4*>(qj + e);
                  acc[j][0] = fmaf(x[e], a.x, acc[j][0]);
                  acc[j][1] = fmaf(x[e + 1], a.y, acc[j][1]);
                  acc[j][2] = fmaf(x[e + 2], a.z, acc[j][2]);
                  acc[j][3] = fmaf(x[e + 3], a.w, acc[j][3]);
                }
              }
            }
          }
        } else {
          const uintptr_t b = reinterpret_cast<uintptr_t>(
              vectors + (crow0 + row) * d + k0);
          const TV* rv = reinterpret_cast<const TV*>(rowp + (b & 15));
          for (int e = h; e < len; e += SPLIT) {
            const float x = to_f32(rv[e]);
#pragma unroll
            for (int j = 0; j < GMAX; ++j)
              if (j < cur.np) acc[j][0] = fmaf(x, qk[j * dq + e], acc[j][0]);
          }
        }
      }
#endif
    }
    if (!ahead && nxt.cluster >= 0) {  // short rows: the next item's first
      __syncthreads();                 // tiles load only now
      load_rows<MODE>(smem, lay, buf ^ 1, attrs, ids, aux, nrow0, nxt.rows, m);
#pragma unroll
      for (int t = 0; t < STAGES - 1; ++t) {
        if (t < n_tiles)
          load_tile<TV, VEC>(
              smem + (size_t)((base + n_tiles + t) % STAGES) * RB * STRIDE,
              vectors, nrow0, nxt.rows, d, t);
        cp_commit();
      }
    }

#if FS_VARIANT != 1
    // epilogue: the SPLIT shares of each sum meet in shared memory, then
    // thread `row` of share 0 scores its row against each pair into `part`
    float sum[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j)
      sum[j] = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
    if (SPLIT > 1) {
      if (h > 0 && row < cur.rows) {
#pragma unroll
        for (int j = 0; j < GMAX; ++j)
          if (j < cur.np) part[((h - 1) * GMAX + j) * RB + row] = sum[j];
      }
      __syncthreads();
    }
    if (h == 0 && row < cur.rows) {
      const int16_t* at = reinterpret_cast<const int16_t*>(
          smem + lay.attrs[buf] + (reinterpret_cast<uintptr_t>(attrs + crow0 * m) & 15))
          + row * m;
      const int id = reinterpret_cast<const int*>(
          smem + lay.ids[buf] + (reinterpret_cast<uintptr_t>(ids + crow0) & 15))[row];
      const float cst = MODE == kDot ? 0.f : reinterpret_cast<const float*>(
          smem + lay.aux[buf] + (reinterpret_cast<uintptr_t>(aux + crow0) & 15))[row];
#pragma unroll
      for (int j = 0; j < GMAX; ++j) {
        if (j >= cur.np) break;
        float sc = sum[j];
#pragma unroll
        for (int x = 1; x < SPLIT; ++x) sc += part[((x - 1) * GMAX + j) * RB + row];
        if (MODE == kSq8) sc = sc * cst;
        if (MODE == kL2) sc = 2.f * sc - cst;
        bool ok = id >= 0;
        if (ok) {
          bool any = false;
          for (int tt = 0; tt < f && !any; ++tt) {
            const int* lb = lo_s + (j * f + tt) * m;
            const int* hb = hi_s + (j * f + tt) * m;
            bool all = true;
            for (int a = 0; a < m && all; ++a) {
              const int av = at[a];
              all = av >= lb[a] && av <= hb[a];
            }
            any = all;
          }
          ok = any;
        }
        part[j * RB + row] = ok ? sc : NEG_INF;  // this thread read it last
      }
    }
    __syncthreads();
    // the fan-out: each warp writes whole slot rows of the block, so a pair
    // with many slots (the pads) is written by every warp at once
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int j = 0; j < cur.np; ++j) {
#if FS_VARIANT == 2
        const int e = s_begin[j] + 1;
#else
        const int e = s_end[j];
#endif
        float sv[RB / 32];  // the pair's scores, lane + 32u
#pragma unroll
        for (int u = 0; u < RB / 32; ++u) sv[u] = part[j * RB + lane + 32 * u];
        // 32 slot ids a load, one per lane, then one row per id
        for (int s0 = s_begin[j] + warp * 32; s0 < e; s0 += NT) {
          const int mine = s0 + lane < e ? plan.sorted_slot[s0 + lane] : 0;
          const int n = min(32, e - s0);
          for (int i = 0; i < n; ++i) {
            float* dst = out + (size_t)__shfl_sync(FULL, mine, i) * vpad + cur.r0;
#pragma unroll
            for (int u = 0; u < RB / 32; ++u)
              if (lane + 32 * u < cur.rows) dst[lane + 32 * u] = sv[u];
          }
        }
      }
    }
#endif
    __syncthreads();  // the item's shared memory is free
    if (nxt.cluster < 0) break;
    cur = nxt;
    base += n_tiles;
    buf ^= 1;
  }
  cp_wait_all();
}

int chunk_queries(int d, int m, int f) {  // g: as many as fit, <= GMAX
  for (int g = GMAX; g >= 1; --g)
    if (scan_smem(d, m, f, g).total <= SMEM_CAP) return g;
  return scan_smem(d, m, f, 1).total <= 227 * 1024 ? 1 : 0;
}

template <typename TQ, typename TV, int MODE, bool VEC>
cudaError_t launch_scan(const Plan& plan, int n_slots, int n_rb,
                        const void* queries, const void* lo, const void* hi,
                        const void* vectors, const void* attrs, const void* ids,
                        const void* aux, void* out, int d, int vpad, int m,
                        int f, const ScanSmem& lay, cudaStream_t stream) {
  auto kernel = scan_kernel<TQ, TV, MODE, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, NT, lay.total)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const long long most = (long long)n_slots * n_rb;  // items <= slots x n_rb
  const int grid = (int)(most < (long long)n_sm * per_sm ? most
                                                          : (long long)n_sm * per_sm);
  kernel<<<grid, NT, lay.total, stream>>>(
      plan, n_rb, (const TQ*)queries, (const int16_t*)lo, (const int16_t*)hi,
      (const TV*)vectors, (const int16_t*)attrs, (const int*)ids,
      (const float*)aux, (float*)out, d, vpad, m, f, lay);
  return cudaGetLastError();
}

// The bits that hold x: the least b with x < 2^b.
inline int bit_length(unsigned x) {
  int b = 0;
  while (b < 32 && (x >> b) != 0) ++b;
  return b;
}

template <typename TQ, typename TV, int MODE>
cudaError_t launch(int n_slots, const void* slot_cluster, const void* slot_query,
                   int n_clusters, int n_queries, const void* queries,
                   const void* lo, const void* hi, const void* vectors,
                   const void* attrs, const void* ids, const void* aux,
                   void* out, int d, int vpad, int m, int f, void* scratch,
                   cudaStream_t stream) {
  const int g = chunk_queries(d, m, f);
  if (g < 1) return cudaErrorInvalidValue;
  const ScanSmem lay = scan_smem(d, m, f, g);
  const int n_rb = (vpad + RB - 1) / RB;
  const int n_max = n_slots < PLAN_CAP ? n_slots : PLAN_CAP;
  const Plan plan = plan_at((int*)scratch, n_max);
  const bool vec = ((size_t)d * sizeof(TV)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vectors) % 16 == 0;
  const int qbits = bit_length((unsigned)n_queries);
  const int cbits = bit_length((unsigned)n_clusters);
  if (qbits + cbits + SLOT_BITS > 64) return cudaErrorInvalidValue;
  const unsigned long long bad = (1ull << cbits) - 1;  // > every cluster
  cudaError_t err = cudaFuncSetAttribute(
      plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PLAN_CAP * 8);
  if (err != cudaSuccess) return err;
  for (int base = 0; base < n_slots; base += PLAN_CAP) {
    const int n = n_slots - base < PLAN_CAP ? n_slots - base : PLAN_CAP;
    int pc = PLAN_NT;
    while (pc < n) pc <<= 1;
    plan_kernel<<<1, PLAN_NT, (size_t)pc * 8, stream>>>(
        (const int*)slot_cluster, (const int*)slot_query, base, n, pc,
        n_clusters, n_queries, qbits, bad, g, n_rb, plan);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
#if FS_VARIANT == 3  // experiment: the plan alone
    continue;
#endif
    err = vec ? launch_scan<TQ, TV, MODE, true>(
                    plan, n, n_rb, queries, lo, hi, vectors, attrs, ids, aux,
                    out, d, vpad, m, f, lay, stream)
              : launch_scan<TQ, TV, MODE, false>(
                    plan, n, n_rb, queries, lo, hi, vectors, attrs, ids, aux,
                    out, d, vpad, m, f, lay, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The scratch filtered_scan_launch needs for n_slots slots, in bytes (the
// wrapper allocates it; int32).
extern "C" long long filtered_scan_scratch_bytes(int n_slots) {
  const int n_max = n_slots < PLAN_CAP ? n_slots : PLAN_CAP;
  return (long long)scratch_ints(n_max > 0 ? n_max : 0) * 4;
}

// Plain C entry point (bound with ctypes).  aux is the norms (mode 1) or
// scales (mode 2) pointer, null for mode 0; scratch holds
// filtered_scan_scratch_bytes(n_slots) bytes.  Returns a cudaError_t: 0 on
// a successful launch.
extern "C" int filtered_scan_launch(
    int n_slots, const void* slot_cluster, const void* slot_query,
    int n_clusters, int n_queries, const void* queries, const void* lo,
    const void* hi, const void* vectors, const void* attrs, const void* ids,
    const void* aux, void* out, int d, int vpad, int m, int f, int mode,
    int q_dtype, int v_dtype, void* scratch, void* stream) {
  if (n_slots <= 0 || vpad <= 0) return cudaSuccess;
  if (d < 1 || f < 1 || m < 0 || scratch == nullptr || n_queries < 0 ||
      n_clusters < 0)
    return cudaErrorInvalidValue;
  if ((long long)PLAN_CAP * ((vpad + RB - 1) / RB) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FS_ARGS                                                             \
  n_slots, slot_cluster, slot_query, n_clusters, n_queries, queries, lo, hi, \
      vectors, attrs, ids, aux, out, d, vpad, m, f, scratch, st
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
