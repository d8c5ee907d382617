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
// What bounds it on the H100.  Each live slot streams its cluster's rows
// (Vpad*D values) and spends 2*QB*Vpad*D flops on them; the least bytes are
// the distinct clusters' (several query tiles probe one cluster).  The
// design is the same for every dtype pair:
//
// - Tensor cores (scan_tc_kernel).  One CTA per (live slot, group of 64
//   query rows) walks the cluster in chunks of 128 rows.  The score tile
//   S = Q_tile . V_chunk^T (both operands K-major, a "TN" product) is
//   mma.sync.m16n8k16 bf16 with f32 accumulators, each of 8 MMA warps 16
//   query rows x 64 vector rows, operands read with ldmatrix (vector tiles
//   in the TMA's swizzled layout, the resident query tile and the bf16
//   planes of f32 and int8 rows in padded rows: no bank conflict either
//   way).  mma.sync and not wgmma: the pairs below are bound by bytes, or
//   near the ridge, at rates mma.sync reaches, and its fragment layouts
//   are fixed and documented.
// - Warp specialization.  The epilogue (mask and top-k fold) took as long
//   as streaming the chunk, and stalled it.  So 8 more warps run it: the
//   MMA warps hand each chunk's scores over in one shared tile (named
//   barriers: full / free) and go on streaming and multiplying the next
//   chunk while the epilogue warps mask and fold this one.  The one tile
//   ties the two sides: the kernel takes about the slower of them plus the
//   hand-over's waits (chip_smoke.py --variants times each side alone).
// - The TMA ring.  Vector tiles of 128 rows x 128 bytes (64 bytes of int8
//   rows) and, for f32 queries, their 64-row query slices arrive by
//   cp.async.bulk.tensor under 2-D tensor maps of [K*Vpad, D] and [Qpad, D]
//   (SWIZZLE_128B, SWIZZLE_64B for int8 rows; out of range reads as zero),
//   encoded on the host through the runtime's driver entry points
//   (nothing new to link) and passed as __grid_constant__ parameters.  One MMA thread
//   issues each tile; a full and an empty mbarrier a stage (complete_tx on
//   full, an arrival from each MMA warp on empty) replace the first
//   design's 256-thread cp.async issue and its block-wide bar.sync at
//   every 64-deep k-step (12 a chunk at D = 768).  The ring runs across
//   chunk edges, 5 stages deep for f32 vectors and 4 for the others
//   (RING_STAGES); a depth chosen at run time cost more in index
//   arithmetic and registers than its stages gave (PERF.md).  Rows
//   that are not 16-byte aligned with a 16-byte multiple stride (the
//   recsys D = 50 f32, the tests' D = 97 and 100, unaligned views) take
//   scalar staging loads into the same swizzled layout, with a bar.sync a
//   k-step.
// - Cluster-major order.  order_kernel (same entry point, a scratch the
//   wrapper allocates) sorts the slots by (cluster, slot), pads last, and
//   CTA x takes the x-th: the query tiles that probe one cluster start
//   together and L2 serves the repeats, where slot by slot each read its
//   own copy from HBM.  Each CTA still writes its own slot's rows.
//
// The dtype pairs, each on that body (the error bounds are per product
// q_i * v_i, before the f32 sums inside the tensor cores):
//
// - bf16 x bf16 (the engine).  64-deep tiles of bf16 rows (16 KB); the
//   query tile stays resident (64 x D bf16, 97 KB at D=768).  32 flop a
//   streamed byte at QB=64 against the bf16 ridge of ~295: bound by bytes.
//   Products exact.
// - f32 queries x bf16 vectors (the sharded search).  Each ring stage also
//   carries the 64-row f32 query slice, split at fragment load into three
//   bf16 terms h = bf16(q), m = bf16(q - h), l = bf16(q - h - m) (round to
//   nearest), all multiplied into one f32 accumulator.  The split is exact
//   (h, m and l each hold 8 of q's 24 significant bits) and bf16 products
//   are exact in f32: the products are exact.
// - f32 x f32 (the launcher's build, the recsys retrieval).  Both operands
//   split so, and the six products whose terms' orders sum to at most 2
//   (hh, hm, hl, mh, mm, lh) kept: 6 x 2*QB*Vpad*D bf16 flops against
//   Vpad*D*4 streamed bytes, 96 flop a byte at QB=32 and 192 at QB=64,
//   below the bf16 ridge.  The products dropped (ml, lm, ll) are below
//   2^-23 |q_i v_i| together, about f32's own rounding of a product: on
//   Gaussian, unit-row, six-decade and near-cancelling rows the split is as
//   close to the plain version as f32 FMA (split_scan_ref, which the CPU
//   tests hold against the TPU kernel).  Three products (hh, hm, mh) would
//   drop 2^-16 |q_i v_i| and break the f32 tolerance on cancelling dots;
//   3xTF32 would need TF32 MMAs at half the bf16 rate for the same
//   accuracy.  Each vector tile is split once into bf16 planes in shared
//   memory (to_planes), not at every fragment load: each row feeds 4 MMA
//   warps.  The raw f32 tile and the f32 query slice take 24 KB a stage
//   at 32-deep tiles; 64-deep tiles would not leave room for the planes.
// - SQ8, f32 queries x int8 vectors (quantize_index).  int8 rows stage at
//   a byte a value (64-deep tiles, 8 KB, 16-byte copies) and are widened to
//   one bf16 plane once a tile, exactly (|v| <= 128 has 8 significant
//   bits); the query is split into h, m, l as above.  Products exact.  The
//   epilogue multiplies the dot by the row scale, the row constant l2's
//   norms ride in too, as the plain version does.  16 flop a streamed byte
//   per product term at QB=64: bound by bytes.
// - The sums of these two pairs.  The tensor cores add a product's terms
//   to the accumulator rounding toward zero at the larger operand's scale,
//   so each MMA into a running dot costs up to an ulp of the dot: with the
//   six products (288 MMAs a dot at D=768) in one accumulator the error on
//   the card grew with the count of MMAs, past the bf16 body's.  So each
//   k-step's products are summed apart from zero, smallest first, and that
//   sum is added to the dot in f32 (round to nearest), as 48 f32 adds a
//   dot at D=768 would be.
// - Query rows.  A CTA takes 64 query rows, 8 MMA warps of 16 rows x 64
//   vector rows; for f32 and int8 vectors a CTA with at most 32 rows (the
//   launcher's QB=32, a tile's ragged end) tiles its warps 16 x 32 instead,
//   so no warp multiplies empty rows.
//
// - The epilogue stays exact.  The accumulators are staged through the
//   shared score tile (their fragment layout is not row-major).  Each
//   epilogue warp owns 8 query rows; lane j holds candidate j of each
//   32-row group of the chunk.  Liveness, the row constant, the DNF test
//   and the pass counts (integer ballots, in registers) come first for
//   several rows x 128 candidates at once, independent work whose latencies
//   overlap.  Only attributes whose bound interval is narrower than int16's
//   range are tested (flagged once per CTA, bounds packed lo|hi in one
//   word), and a row with a term that tests no attribute (match_all) passes
//   every live row.
// - The selection, any k <= 256.  Each row keeps its list in registers,
//   R = 1, 2, 4 or 8 slots a lane (lane j holds ranks j, j+32, ...), best
//   first by (value descending, row position ascending), the position
//   becoming the row's id at write-out: the order of the plain version's
//   top-k and of the TPU kernel's _fold_topk, earliest row first on a tie.
//   The first design inserted one candidate per warp step (R ballots and
//   3R shuffles per insert, each depending on the one before, about
//   k(1 + ln(Vpad/k)) inserts a row and slot): at k = 100 the selection
//   was 80% of the kernel's time, 8.2x its bound (PERF.md).  For R >= 2
//   the first chunk of a slot is sorted whole by a warp bitonic network
//   and becomes the list; in each later chunk the candidates strictly
//   above the row's k-th are compacted (ballot and prefix popcount, column
//   bytes in a per-warp buffer in shared memory) and folded 32 at a time:
//   sorted worst first by a bitonic network over the lanes they fill, kept
//   lane by lane against the list's last slot (the best 32 of the two, a
//   bitonic sequence), then a bitonic merge of the list that skips the
//   slots no exchange touched.  A fold costs at most 15 + 5 shuffle steps
//   per touched slot whatever the number of candidates, and 2-4 rows fold
//   in step (4 at R = 2, 2 at R = 4, 1 at R = 8: the R = 8 lists alone
//   fill the 128 registers a thread and spill), so their latencies
//   overlap.  At R = 1 (k <= 32) the same fold runs, 4 rows in step for
//   every pair, and the first chunk is not sorted: its k-th is at least the
//   k-th of the lanes' own maxima (kth_of_lanes: a 15-step sort of 32
//   values, a 5-step maximum at k = 1), so only its passing candidates at
//   or above that are folded, about k of them.  On the card this beat the
//   first design's inserts at every k and dtype pair, and the fold adds no
//   spill (PERF.md §6).  The FMA body takes the same folds with the
//   merge's steps as loops, not unrolled: less code to build for a body off
//   the main path.  k > 256 (up to Vpad) takes a third body,
//   scan_sort_kernel: one CTA per (slot, query row) scores the whole
//   cluster into shared memory and bitonic-sorts it by the same order.  It
//   reads a cluster once per query row, so it is slow; no full-size path
//   asks for k > 256.
// - One kernel a dtype pair and list width: dot and l2 are a run-time flag
//   (SQ8 is the int8 pair), which halves the instantiations and keeps the
//   library's build near two minutes.
// - Shared memory.  The survivor buffer takes 4 KB beside the ring, the
//   resident query tile and the score tile: bf16 queries keep the
//   tensor-core body up to D = 896 at M = 10 and D = 832 at M = 16, F = 2.
//   Vpad and D are walked in whole tiles with the ragged edge zero-filled
//   and masked.
//
// The first design's f32 FMA body (scan_fma_kernel: 64x64 score tiles from
// 64x32 staging slices, each thread a 4x4 micro-tile, the epilogue after
// each tile) serves only the shapes the tensor-core body cannot take: more
// than 16 attributes, or shared memory that does not fit (bf16 queries at
// D > 896 at M = 10).  The choice rests on the shapes alone;
// filtered_scan_tiled_fma_launch runs it on any pair, for comparison.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Compile-time experiment switches (off in the shipped build; chip_smoke.py
// --variants times them on the engine's operands): -DFS_SIDE=1 runs the MMA
// side alone (the epilogue frees each score tile at once and writes pads),
// -DFS_SIDE=2 the epilogue side alone (the MMA warps hand over synthetic
// scores, a hash of slot, query row and row, without streaming the
// cluster), -DFS_SIDE=3 the whole kernel without its fold (mask, liveness
// and pass counts kept); -DFS_SLOT_ORDER=1 launches the tensor-core body in
// slot order, not cluster-major.
#ifndef FS_SIDE
#define FS_SIDE 0
#endif
#ifndef FS_SLOT_ORDER
#define FS_SLOT_ORDER 0
#endif

namespace {

constexpr int QT = 64;   // query rows per CTA
constexpr int NT = 256;  // FMA body threads; the tensor-core body has 2 x NT
constexpr int RPW = QT / (NT / 32);  // query rows folded by each warp
constexpr int MAX_R = 8;  // register slots a lane: k <= 256 in registers
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory a CTA
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { kDot = 0, kL2 = 1, kSq8 = 2 };
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// ---------------------------------------------------------------------------
// The running top-k: each query row's list in registers, R slots a lane
// (entry e = 32*s + lane in slot s), best first by (value descending, row
// position in the cluster ascending): equal values keep row order, so the
// earliest row wins a tie.  Positions become ids at write-out.
// ---------------------------------------------------------------------------

constexpr int PAD_POS = 0x7fffffff;  // a pad entry's position: after all rows

// Whether (va, pa) comes before (vb, pb): value descending, then position
// ascending.
__device__ __forceinline__ bool before(float va, int pa, float vb, int pb) {
  return va > vb || (va == vb && pa < pb);
}

// Compare-exchange with lane ^ j (j < 32): keeps the earlier of the two
// where `first`, else the later.
__device__ __forceinline__ void cx_lane(float& v, int& p, int j, bool first) {
  const float ov = __shfl_xor_sync(FULL, v, j);
  const int op = __shfl_xor_sync(FULL, p, j);
  if (first == before(ov, op, v, p)) {
    v = ov;
    p = op;
  }
}

// Compare-exchange of two slots of a lane: (va, pa) keeps the earlier.
// Returns whether they swapped.
__device__ __forceinline__ bool cx_slot(float& va, int& pa, float& vb,
                                        int& pb) {
  const bool sw = before(vb, pb, va, pa);
  if (sw) {
    const float tv = va;
    const int tp = pa;
    va = vb;
    pa = pb;
    vb = tv;
    pb = tp;
  }
  return sw;
}

// The value at warp-uniform rank r of a list held R slots a lane.
template <int R>
__device__ __forceinline__ float rank_value(const float (&rv)[R], int r) {
  const int s = r >> 5;
  float x = rv[0];
#pragma unroll
  for (int j = 1; j < R; ++j) x = s == j ? rv[j] : x;
  return __shfl_sync(FULL, x, r & 31);
}

// Sorts RB rows' NS*32 entries each (slot j, lane: entry 32*j + lane), best
// first: a bitonic network, strides of a slot and more between a lane's own
// slots, the others across lanes; the rows' steps interleave.  The stages
// are loops, not unrolled: it runs once a slot, and the code stays small.
template <int RB, int NS>
__device__ __forceinline__ void warp_sort(float (&v)[RB][NS], int (&p)[RB][NS],
                                          int lane) {
#pragma unroll 1
  for (int kk = 2; kk <= 32 * NS; kk <<= 1) {
#pragma unroll
    for (int js = NS / 2; js > 0; js >>= 1) {
      if (64 * js > kk) continue;  // uniform
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s & js) continue;
        const bool up = ((32 * s) & kk) == 0;  // best first in this block
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (up)
            cx_slot(v[i][s], p[i][s], v[i][s + js], p[i][s + js]);
          else
            cx_slot(v[i][s + js], p[i][s + js], v[i][s], p[i][s]);
        }
      }
    }
#pragma unroll 1
    for (int j = min(kk >> 1, 16); j > 0; j >>= 1) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int e = 32 * s + lane;
        const bool first = ((e & j) == 0) == ((e & kk) == 0);
#pragma unroll
        for (int i = 0; i < RB; ++i) cx_lane(v[i][s], p[i][s], j, first);
      }
    }
  }
}

// One step of merge_batch's batch sort: stride j of block size kk, the
// block of the top nbp lanes worst first.
template <int RB>
__device__ __forceinline__ void batch_step(float (&b)[RB], int (&bp)[RB],
                                           int kk, int j, int nbp, int lane) {
  const bool worst_first = kk == nbp || (lane & kk) == 0;
  const bool first = ((lane & j) == 0) != worst_first;
#pragma unroll
  for (int i = 0; i < RB; ++i) cx_lane(b[i], bp[i], j, first);
}

// The k-th largest (k <= 32) of the 32 lanes' values x[i], for RB rows in
// step, in every lane: a bitonic sort of the lanes (values only, best
// first), or a butterfly maximum where k = 1.
template <int RB>
__device__ __forceinline__ void kth_of_lanes(float (&x)[RB], int k,
                                             int lane) {
  if (k == 1) {
#pragma unroll
    for (int j = 16; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < RB; ++i)
        x[i] = fmaxf(x[i], __shfl_xor_sync(FULL, x[i], j));
    return;
  }
#pragma unroll
  for (int kk = 2; kk <= 32; kk <<= 1)
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
      const bool keep_max = ((lane & j) == 0) == ((lane & kk) == 0);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float o = __shfl_xor_sync(FULL, x[i], j);
        x[i] = keep_max ? fmaxf(x[i], o) : fminf(x[i], o);
      }
    }
#pragma unroll
  for (int i = 0; i < RB; ++i) x[i] = __shfl_sync(FULL, x[i], k - 1);
}

// Merges each of RB rows' batch (b, bp): at most 32 entries a row in the
// top nbp lanes (a power of two; pads elsewhere), into the rows' lists
// lv[i0 + i] (32*R entries, best first), keeping the best 32*R.  The batch
// is sorted worst first (bitonic, nbp entries); the list's last slot keeps
// the better of itself and the batch lane by lane, the best 32 of the two
// as a bitonic sequence, which makes the whole list bitonic; a bitonic
// merge sorts it, skipping the slots that no step changed (still sorted).
// UNROLL: the lane steps unrolled (the tensor-core epilogue, where they
// are the hot path) or loops (the FMA body: less code to build).
template <int R, int RB, bool UNROLL>
__device__ __forceinline__ void merge_batch(float (&lv)[RPW][R],
                                            int (&lp)[RPW][R], int i0,
                                            float (&b)[RB], int (&bp)[RB],
                                            int nbp, int lane) {
  if constexpr (UNROLL) {
#pragma unroll
    for (int kk = 2; kk <= 32; kk <<= 1) {
      if (kk > nbp) break;  // uniform
#pragma unroll
      for (int j = kk >> 1; j > 0; j >>= 1)
        batch_step<RB>(b, bp, kk, j, nbp, lane);
    }
  } else {
#pragma unroll 1
    for (int kk = 2; kk <= nbp; kk <<= 1)
#pragma unroll 1
      for (int j = kk >> 1; j > 0; j >>= 1)
        batch_step<RB>(b, bp, kk, j, nbp, lane);
  }
#pragma unroll
  for (int i = 0; i < RB; ++i)
    if (before(b[i], bp[i], lv[i0 + i][R - 1], lp[i0 + i][R - 1])) {
      lv[i0 + i][R - 1] = b[i];
      lp[i0 + i][R - 1] = bp[i];
    }
  bool dirty[R];
#pragma unroll
  for (int s = 0; s < R; ++s) dirty[s] = s == R - 1;
#pragma unroll
  for (int js = R / 2; js > 0; js >>= 1) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (s & js) continue;
      const int t = s + js;
      if (!dirty[s] && !dirty[t]) continue;  // two sorted slots: in order
      bool sw = false;
#pragma unroll
      for (int i = 0; i < RB; ++i)
        sw |= cx_slot(lv[i0 + i][s], lp[i0 + i][s], lv[i0 + i][t],
                      lp[i0 + i][t]);
      if (__any_sync(FULL, sw)) dirty[s] = dirty[t] = true;
    }
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (!dirty[s]) continue;  // uniform
    if constexpr (UNROLL) {
#pragma unroll
      for (int j = 16; j > 0; j >>= 1)
#pragma unroll
        for (int i = 0; i < RB; ++i)
          cx_lane(lv[i0 + i][s], lp[i0 + i][s], j, (lane & j) == 0);
    } else {
#pragma unroll 1
      for (int j = 16; j > 0; j >>= 1)
#pragma unroll
        for (int i = 0; i < RB; ++i)
          cx_lane(lv[i0 + i][s], lp[i0 + i][s], j, (lane & j) == 0);
    }
  }
}

// Folds one chunk of NH*32 candidates (lane's candidate h at column
// 32*h + lane, row position pos0 + column) into the lists of RB query rows
// lv[i0 .. i0+RB).  cand[i][h]: the row's masked score (NEG_INF where the
// filter or liveness fails); value(ii, c): row ii's score at column c (a
// candidate that passed).  The candidates strictly above a row's k-th are
// compacted into `buf` (RB x NH*32 column bytes, the warp's own; by ballot
// and prefix popcount, in column order) and folded 32 at a time by
// merge_batch, the rows' batches in step.  Strictly above, and after equal
// entries: the earlier row wins a tie, as one insert at a time would.
// `first`: the lists are still empty pads.  With more than one slot a
// lane, where a row of the group has more than 32 candidates passing, the
// chunk sorted whole becomes the lists instead (a filtered chunk with
// fewer is one fold).  With one slot (k <= 32) the chunk's k-th is at
// least the k-th of the lanes' own maxima (those are k candidates), so
// only the passing candidates at or above that are folded: about k of
// them, where the sort would cost the whole chunk's network.
template <int R, int RB, int NH, bool UNROLL, typename Value>
__device__ __forceinline__ void select_chunk(float (&lv)[RPW][R],
                                             int (&lp)[RPW][R], int i0,
                                             const float (&cand)[RB][NH],
                                             bool first, int pos0, int k,
                                             unsigned char* buf, int lane,
                                             Value value) {
  constexpr int NC = 32 * NH;
  float floor_[RB];  // R = 1, first chunk: fold the candidates >= floor_
  if constexpr (R == 1) {
    if (first) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        floor_[i] = cand[i][0];
#pragma unroll
        for (int h = 1; h < NH; ++h) floor_[i] = fmaxf(floor_[i], cand[i][h]);
      }
      kth_of_lanes<RB>(floor_, k, lane);
    }
  }
  if constexpr (R > 1) {
    if (first) {
      int n_pass = 0;  // the most candidates passing in a row of the group
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        int c = 0;
#pragma unroll
        for (int h = 0; h < NH; ++h)
          c += __popc(__ballot_sync(FULL, cand[i][h] > NEG_INF));
        n_pass = max(n_pass, c);
      }
      if (n_pass > 32) {  // sorted whole, it becomes the lists
        float v[RB][NH];
        int p[RB][NH];
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            v[i][h] = cand[i][h];
            p[i][h] = pos0 + 32 * h + lane;
          }
        warp_sort<RB, NH>(v, p, lane);
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int s = 0; s < R; ++s) {
            lv[i0 + i][s] = s < NH ? v[i][s < NH ? s : 0] : NEG_INF;
            lp[i0 + i][s] = s < NH ? p[i][s < NH ? s : 0] : PAD_POS;
          }
        return;
      }
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int n[RB], n_max = 0;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const float kth = rank_value<R>(lv[i0 + i], k - 1);  // NEG_INF if first
    int base = 0;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      bool in = cand[i][h] > kth;
      if constexpr (R == 1)
        if (first) in = in && cand[i][h] >= floor_[i];
      const unsigned sel = __ballot_sync(FULL, in);
      if (sel >> lane & 1)
        buf[i * NC + base + __popc(sel & below)] =
            (unsigned char)(32 * h + lane);
      base += __popc(sel);
    }
    n[i] = base;
    n_max = max(n_max, base);
  }
  if (n_max == 0) return;  // uniform
  __syncwarp();
  for (int b0 = 0; b0 < n_max; b0 += 32) {
    const int nb_max = min(32, n_max - b0);
    const int nbp = nb_max <= 1 ? 1 : 1 << (32 - __clz(nb_max - 1));
    float b[RB];
    int bp[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int nb = min(32, max(0, n[i] - b0));
      const bool in = lane >= 32 - nb;  // the batch in the top lanes
      const int c = in ? buf[i * NC + b0 + 31 - lane] : 0;
      b[i] = in ? value(i0 + i, c) : NEG_INF;
      bp[i] = in ? pos0 + c : PAD_POS;
    }
    merge_batch<R, RB, UNROLL>(lv, lp, i0, b, bp, nbp, lane);
  }
  __syncwarp();  // buf is refilled by the next rows
}

// Writes a warp's k-list to out[0, k): values, and the ids of the rows at
// the listed positions (-1 where the value is a NEG_INF pad).
template <int R>
__device__ __forceinline__ void write_list(const float (&lv)[R],
                                           const int (&lp)[R],
                                           const int* __restrict__ row_ids,
                                           float* out_v, int* out_i, int lane,
                                           int k) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = s * 32 + lane;
    if (r < k) {
      const bool real = lv[s] > 0.5f * NEG_INF;
      out_v[r] = lv[s];
      out_i[r] = real ? row_ids[lp[s]] : -1;
    }
  }
}

template <int R>
__device__ __forceinline__ void init_list(float (&lv)[R], int (&lp)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    lv[s] = NEG_INF;
    lp[s] = PAD_POS;
  }
}

// Rows selected at once: fewer as the lists grow, to bound the registers
// (4 at one slot for every dtype pair: 2 was slower, and spilled more with
// f32 x f32; PERF.md).
template <int R>
constexpr int ROWS_AT_ONCE = R <= 2 ? 4 : R == 4 ? 2 : 1;

// A row's score from its dot: SQ8 (int8 rows) as dot · scale, l2 as
// 2·dot - ||v||^2, else the dot (aux holds the row constant).
template <bool SQ8>
__device__ __forceinline__ float row_score(float dot, float aux, bool l2) {
  if constexpr (SQ8) return dot * aux;
  return l2 ? 2.f * dot - aux : dot;
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
// f32 FMA body: the shapes the tensor-core body does not take (M > 16,
// shared memory), and the comparison entry point.
// ---------------------------------------------------------------------------

namespace ffma {

constexpr int VT = 64;  // cluster rows per chunk
constexpr int DK = 32;  // depth per staging step
constexpr int SEL = (NT / 32) * 4 * VT;  // survivor columns: a warp's 4 rows

size_t smem_bytes(int m, int f) {
  size_t floats = QT * (DK + 1) + VT * (DK + 1) + QT * (VT + 1) + VT;
  size_t ints = VT + QT + (size_t)VT * m + 2 * (size_t)QT * f * m;
  return 4 * (floats + ints) + SEL;
}

template <typename TQ, typename TV, int R>
__global__ void __launch_bounds__(NT, R == 8 ? 1 : 2) scan_fma_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const TV* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k, bool l2) {
  constexpr bool SQ8 = sizeof(TV) == 1;
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
  unsigned char* sel_s = reinterpret_cast<unsigned char*>(hi_s + QT * f * m);

  const int s = blockIdx.x;
  const int q0 = blockIdx.y * QT;  // first query row of this CTA in the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned char* sel_w = sel_s + warp * 4 * VT;  // [4][VT], the warp's own
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

  float lv[RPW][R];  // the running lists of query rows warp + 8*i
  int lp[RPW][R];
#pragma unroll
  for (int i = 0; i < RPW; ++i) init_list<R>(lv[i], lp[i]);

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
      auxs[e] = ((SQ8 || l2) && in) ? aux[crow0 + v0 + e] : 0.f;
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
        sc = row_score<SQ8>(sc, auxs[c], l2);
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

    // fold the chunk into each owned row's running top-k
    constexpr int RB = ROWS_AT_ONCE<R>;
#pragma unroll
    for (int i0 = 0; i0 < RPW; i0 += RB) {
      float cand[RB][VT / 32];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = warp + (NT / 32) * (i0 + i);
#pragma unroll
        for (int h = 0; h < VT / 32; ++h)
          cand[i][h] = r < nq ? ss[r * (VT + 1) + h * 32 + lane] : NEG_INF;
      }
      select_chunk<R, RB, VT / 32, false>(
          lv, lp, i0, cand, v0 == 0, v0, k, sel_w, lane,
          [&](int ii, int c) {
            return ss[(warp + (NT / 32) * ii) * (VT + 1) + c];
          });
    }
    __syncthreads();  // ss and the staged row constants are reused next chunk
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + (NT / 32) * i;
    if (r < nq)
      write_list<R>(lv[i], lp[i], ids + crow0, out_vals + (out_row0 + r) * k,
                    out_ids + (out_row0 + r) * k, lane, k);
  }
  __syncthreads();
  for (int e = tid; e < nq; e += NT) out_npass[out_row0 + e] = npass_s[e];
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// Tensor-core body: bf16 vectors against bf16 or f32 queries, f32 vectors
// against f32 queries, SQ8 int8 vectors against f32 queries.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int VT = 128;      // cluster rows per chunk
constexpr int SLD = VT + 8;  // f32 row stride of the score tile
constexpr int MAX_M = 16;    // attributes per row the epilogue stages
constexpr int MPT = VT * MAX_M / NT;  // attribute values staged per thread
constexpr int SEL = (NT / 32) * 4 * VT;  // survivor columns: a warp's 4 rows

// A ring tile for vectors of type TV: VT rows of KS values, dense rows of
// ROWB bytes in the order the TMA's swizzle leaves them (16-byte chunk c of
// row r at chunk c ^ (r & 7) of 128-byte rows, c ^ ((r >> 1) & 3) of
// 64-byte ones), so that ldmatrix reads 8 rows without a bank conflict;
// the scalar staging writes the same layout.  bf16 rows are multiplied
// from the tile itself; f32 and int8 rows become TERMS bf16 planes of row
// stride BLD (padded) once per tile, which the MMA warps then read: f32
// split into h, m, l (32-deep tiles, so that the ring, the planes and the
// score tile fit), int8 widened exactly.  f32 queries ride in each stage as
// a QT x KS slice, in boxes of 32 values (128-byte rows, swizzled so too).
// Ring depth (stages - 1 tiles in flight): 5 stages for f32 vectors (the
// launcher's f32 x f32 ran 2% faster than with 4), 4 for the others (a
// fifth cut the bf16 body's D range from 896 to 768, and against bf16 or
// int8 rows with f32 queries it gained nothing; PERF.md).
template <typename TV>
constexpr int RING_STAGES = sizeof(TV) == 4 ? 5 : 4;

template <typename TV>
struct Ring {
  static constexpr bool BF16 = sizeof(TV) == 2;
  static constexpr int KS = sizeof(TV) == 4 ? 32 : 64;  // depth per tile
  static constexpr int TERMS = sizeof(TV) == 4 ? 3 : 1;  // bf16 terms a value
  static constexpr int ROWB = KS * (int)sizeof(TV);  // 128, int8 64 bytes
  static constexpr int BLD = KS + 8;  // bf16 row stride of a plane
  static constexpr int QBOXES = KS / 32;  // f32 query boxes a stage
  static constexpr size_t RAW = (size_t)VT * ROWB;
  static constexpr size_t QBOX = (size_t)QT * 128;
  static constexpr size_t PLANES = BF16 ? 0 : (size_t)TERMS * VT * BLD * 2;
};

// Byte offset of 16-byte chunk c of row r in a tile of ROWB-byte rows, as
// the TMA's SWIZZLE_128B (SWIZZLE_64B for 64-byte rows) places it.
template <int ROWB>
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return r * ROWB + ((ROWB == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3)) << 4);
}

// Byte offset of f32 query value (r, c) in a stage's query slice.
__device__ __forceinline__ int qoff(int r, int c) {
  return (c >> 5) * QT * 128 + swz<128>(r, (c & 31) >> 2) + (c & 3) * 4;
}

struct Layout {  // byte offsets from the 1024-aligned base
  size_t stage, a_res, planes, ss, idss, auxs, bnd, act, attrs, sel, mbar,
      total;
};

template <typename TQ, typename TV>
__host__ __device__ inline Layout layout(int d, int m, int f) {
  using RG = Ring<TV>;
  constexpr bool F32Q = sizeof(TQ) == 4;
  Layout L;
  const size_t dp = (size_t)(d + RG::KS - 1) / RG::KS * RG::KS;
  L.stage = RG::RAW + (F32Q ? RG::QBOXES * RG::QBOX : 0);  // 1 KB multiples
  L.a_res = RING_STAGES<TV> * L.stage;  // resident bf16 query tile
  L.planes = L.a_res + (F32Q ? 0 : (size_t)QT * (dp + 8) * 2);
  L.ss = L.planes + RG::PLANES;
  L.idss = L.ss + (size_t)QT * SLD * 4;
  L.auxs = L.idss + VT * 4;
  L.bnd = L.auxs + VT * 4;
  L.act = L.bnd + (size_t)QT * f * m * 4;
  L.attrs = L.act + (size_t)QT * f * 4;
  L.sel = L.attrs + ((size_t)VT * m * 2 + 15) / 16 * 16;
  L.mbar = L.sel + SEL;  // the ring's full and empty barriers, a stage each
  L.total = L.mbar + 2 * RING_STAGES<TV> * 8 + 1024;  // + base alignment
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
// The ring's mbarriers: full[s] completes when stage s's bytes have landed
// (one arrival, the producer's, with the bytes it expects), empty[s] when
// every MMA warp is done with it (one arrival a warp).
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
// Waits for the phase of parity `parity` of barrier b to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// A 2-D box of tensor map `tm` at (c0 innermost, c1) into shared memory
// `dst`, its bytes counted on barrier b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1),
      "r"(smem_u32(b))
      : "memory");
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
// Two f32 values as three bf16x2 terms h + m + l, each rounded to nearest.
// Each difference is exact, and so is the split: h holds a value's leading
// 8 significant bits, m the next 8 and l the last 8 of its 24.
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
// Four int8 values (one word) as two bf16x2 words, exactly: byte b biased
// to u = b + 128 is the low byte of 2^23 + u (f32 bits 0x4b0000uu), less
// 2^23 + 128 that is b; |b| <= 128 has at most 8 significant bits, so the
// upper half of its f32 bits is its bf16 value.  Integer and f32 adds
// only, no conversion instructions.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + j)) -
        8388736.f);
  lo = __byte_perm(x[0], x[1], 0x7632);
  hi = __byte_perm(x[2], x[3], 0x7632);
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stages ring tile (v0, d0) by scalar loads and stores (ragged D, unaligned
// operands: the shapes the TMA cannot take) into the TMA's layout: VT x KS
// vector rows and, for f32 queries, the QT x KS f32 query slice, zero past
// the edges.
template <typename TQ, typename TV>
__device__ __forceinline__ void stage_tile(unsigned char* stage,
                                           const TV* vb, const TQ* qg, int nq,
                                           int vpad, int v0, int d0, int d,
                                           int tid) {
  using RG = Ring<TV>;
  constexpr int KS = RG::KS;
  constexpr int EPC = 16 / sizeof(TV);  // values a 16-byte chunk
#pragma unroll 4
  for (int i = 0; i < VT * KS / NT; ++i) {
    const int e = tid + NT * i, row = e / KS, c = e % KS;
    const bool in = v0 + row < vpad && d0 + c < d;
    *reinterpret_cast<TV*>(stage + swz<RG::ROWB>(row, c / EPC) +
                           c % EPC * sizeof(TV)) =
        in ? vb[(size_t)(v0 + row) * d + d0 + c] : zero<TV>();
  }
  if constexpr (sizeof(TQ) == 4) {
#pragma unroll 4
    for (int i = 0; i < QT * KS / NT; ++i) {
      const int e = tid + NT * i, row = e / KS, c = e % KS;
      const bool in = row < nq && d0 + c < d;
      *reinterpret_cast<float*>(stage + RG::RAW + qoff(row, c)) =
          in ? qg[(size_t)row * d + d0 + c] : 0.f;
    }
  }
}

// The bf16 planes of a raw ring tile ([VT][KS] f32 or int8, swizzled): f32
// values split into h, m, l (plane t at planes + t * VT * BLD), int8 values
// widened.  Each value is read by the 4 MMA warps that share its rows, so
// doing this once per tile, and not at every fragment load, saves 3/4 of
// the ALU work.
template <typename TV>
__device__ __forceinline__ void to_planes(const unsigned char* raw,
                                          __nv_bfloat16* planes, int tid) {
  using RG = Ring<TV>;
  constexpr int KS = RG::KS, BLD = RG::BLD, ROWB = RG::ROWB;
  if constexpr (sizeof(TV) == 4) {
#pragma unroll
    for (int i = 0; i < VT * KS / 4 / NT; ++i) {
      const int e = tid + NT * i, row = e / (KS / 4), c = e % (KS / 4) * 4;
      const float4 x =
          *reinterpret_cast<const float4*>(raw + swz<ROWB>(row, c / 4));
      uint32_t h[2], m[2], l[2];
      split3(make_float2(x.x, x.y), h[0], m[0], l[0]);
      split3(make_float2(x.z, x.w), h[1], m[1], l[1]);
      __nv_bfloat16* p = planes + row * BLD + c;
      *reinterpret_cast<uint2*>(p) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(p + VT * BLD) = make_uint2(m[0], m[1]);
      *reinterpret_cast<uint2*>(p + 2 * VT * BLD) = make_uint2(l[0], l[1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VT * KS / 16 / NT; ++i) {
      const int e = tid + NT * i, row = e / (KS / 16), c = e % (KS / 16) * 16;
      const uint4 x =
          *reinterpret_cast<const uint4*>(raw + swz<ROWB>(row, c / 16));
      uint32_t o[8];
      widen4(x.x, o[0], o[1]);
      widen4(x.y, o[2], o[3]);
      widen4(x.z, o[4], o[5]);
      widen4(x.w, o[6], o[7]);
      __nv_bfloat16* p = planes + row * BLD + c;
      *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(p + 8) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

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

template <typename TQ, typename TV, int R>
__global__ void __launch_bounds__(2 * NT, 1) scan_tc_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const TV* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k, bool l2,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_q, const int* __restrict__ order,
    bool tma) {
  constexpr bool SQ8 = sizeof(TV) == 1;
  using RG = Ring<TV>;
  constexpr bool F32Q = sizeof(TQ) == 4;
  constexpr int KS = RG::KS, BLD = RG::BLD, ROWB = RG::ROWB;
  constexpr int STAGES = RING_STAGES<TV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles want a 1024-byte aligned base
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout<TQ, TV>(d, m, f);
  float* ss = reinterpret_cast<float*>(smem + L.ss);        // [QT][SLD]
  int* idss = reinterpret_cast<int*>(smem + L.idss);        // [VT]
  float* auxs = reinterpret_cast<float*>(smem + L.auxs);    // [VT]
  int* bnd = reinterpret_cast<int*>(smem + L.bnd);          // [QT][f][m]
  unsigned* act_s = reinterpret_cast<unsigned*>(smem + L.act);  // [QT][f]
  int16_t* attrs_s = reinterpret_cast<int16_t*>(smem + L.attrs);  // [VT][m]

  // cluster-major: CTA x takes the x-th live slot in (cluster, slot) order
  const int s = order != nullptr ? order[blockIdx.x] : blockIdx.x;
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

  // ---- the MMA warps: stream the cluster, multiply, hand over tiles ----
  // (compiled twice, for the TMA ring and for scalar staging, and entered
  // once: one kernel a list width, the epilogue compiled once)
  auto mma_warps = [&](auto flag) {
    constexpr bool TMA = decltype(flag)::value;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const TQ* qg = queries + qrow0 * d;
    const TV* vb = vectors + crow0 * d;
    const __nv_bfloat16* a_res =
        reinterpret_cast<const __nv_bfloat16*>(smem + L.a_res);
    __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(smem + L.planes);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.mbar);
    uint64_t* empty = full + STAGES;
    const int ald = dp + 8;  // row stride of the resident query tile
    const int total = nch * nks;  // ring tiles

    if constexpr (FS_SIDE == 2) {  // synthetic scores, nothing streamed
      for (int chunk = 0; chunk < nch; ++chunk) {
        const int v0 = chunk * VT, nv = min(VT, vpad - v0);
        if (chunk > 0) bar_sync(kBarFree, 2 * NT);
        for (int e = tid; e < QT * VT; e += NT) {
          const int row = e / VT, col = e % VT;
          unsigned x = (unsigned)s * 0x9e3779b1u ^
                       (unsigned)(q0 + row) * 0x85ebca77u ^
                       (unsigned)(v0 + col) * 0xc2b2ae3du;
          x ^= x >> 16;
          x *= 0x7feb352du;
          x ^= x >> 15;
          x *= 0x846ca68bu;
          x ^= x >> 16;
          ss[row * SLD + col] = (float)(x >> 8) * (1.f / 16777216.f);
        }
        if (tid < VT)
          idss[tid] = tid < nv ? ids[crow0 + v0 + tid] : -1;
        else
          auxs[tid - VT] = (SQ8 || l2) && tid - VT < nv
                               ? aux[crow0 + v0 + tid - VT] : 0.f;
        for (int e = tid; e < VT * m; e += NT)
          attrs_s[e] = e < nv * m ? attrs[(crow0 + v0) * m + e] : 0;
        bar_arrive(kBarFull, 2 * NT);
      }
      return;
    }

    // The TMA ring: one thread (the producer) issues each tile's loads,
    // vector rows as one box of [K*Vpad, D] and f32 query slices as boxes
    // of [Qpad, D], and counts their bytes on full[stage]; every MMA warp
    // waits on full[stage], multiplies, and arrives on empty[stage], which
    // the producer waits on before it refills the stage.  No block-wide
    // barrier a k-step.
    const int qrows = min(QT, qb);  // rows of a query box
    const uint32_t tx_bytes =
        (uint32_t)(RG::RAW + (F32Q ? RG::QBOXES * qrows * 128 : 0));
    auto produce = [&](int p) {  // the producer: ring tile p into its stage
      const int st = p % STAGES;
      if (p >= STAGES) mbar_wait(&empty[st], (p / STAGES - 1) & 1);
      unsigned char* stage = smem + st * L.stage;
      mbar_expect(&full[st], tx_bytes);
      const int v0 = (p / nks) * VT, d0 = (p % nks) * KS;
      tma_load(stage, &tm_v, d0, (int)(crow0 + v0), &full[st]);
      if constexpr (F32Q) {
#pragma unroll
        for (int b = 0; b < RG::QBOXES; ++b)
          tma_load(stage + RG::RAW + b * RG::QBOX, &tm_q, d0 + 32 * b,
                   (int)qrow0, &full[st]);
      }
    };
    if constexpr (TMA) {
      if (tid == 0) {
        for (int i = 0; i < STAGES; ++i) {
          mbar_init(&full[i], 1);
          mbar_init(&empty[i], NT / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int p = 0; p < STAGES - 1 && p < total; ++p) produce(p);
      }
    }
    if constexpr (!F32Q) {  // the resident bf16 query tile, zero-padded
      __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem + L.a_res);
      if constexpr (TMA) {
        for (int e = tid; e < QT * dp / 8; e += NT) {
          const int row = e / (dp / 8), c = (e % (dp / 8)) * 8;
          const bool in = row < nq && c < d;
          cp16(a + row * ald + c, in ? qg + (size_t)row * d + c : qg, in);
        }
        cp_commit();
        cp_wait<0>();
      } else {
        for (int e = tid; e < QT * dp; e += NT) {
          const int row = e / dp, c = e % dp;
          a[row * ald + c] = (row < nq && c < d) ? qg[(size_t)row * d + c]
                                                 : __float2bfloat16(0.f);
        }
      }
    }
    if constexpr (TMA) {
      bar_sync(kBarRing, NT);  // the barriers' init and the query tile
    } else {
#pragma unroll
      for (int p = 0; p < STAGES - 1; ++p)
        if (p < total)
          stage_tile<TQ, TV>(smem + p * L.stage, vb, qg, nq, vpad,
                             (p / nks) * VT, (p % nks) * KS, d, tid);
    }

    // Warp tiling: 4 x 16 query rows by 2 x 64 vector rows, or, for f32
    // and int8 vectors where the CTA holds at most 32 query rows (the
    // launcher's QB = 32, a tile's ragged end), 2 x 16 by 4 x 32: no warp
    // multiplies empty rows.
    const bool narrow = !RG::BF16 && nq <= 32;
    const int npw = narrow ? 2 : 4;  // 16-row vector groups a warp
    const int wm = narrow ? warp & 1 : warp & 3;  // query rows wm*16 .. +15
    const int vr0 = narrow ? (warp >> 1) * 32 : (warp >> 2) * 64;
    const int g = lane >> 2, tq = lane & 3;
    // f32 query fragments: this thread's row and chunk parts of qoff
    const int qbase = (wm * 16 + g) * 128 + (tq & 1) * 8;
    const int qx = (tq >> 1) ^ (g & 1), g6 = g & 6;
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
        if ((SQ8 || l2) && tid >= VT && tid - VT < nv)
          meta_aux = aux[crow0 + v0 + tid - VT];
#pragma unroll
        for (int j = 0; j < MPT; ++j) {
          const int e = tid + NT * j;
          meta_at[j] = 0;
          if (e < nv * m) meta_at[j] = attrs[(crow0 + v0) * m + e];
        }
      }
      const unsigned char* stage = smem + (t % STAGES) * L.stage;
      if constexpr (TMA) {
        if (tid == 0 && t + STAGES - 1 < total) produce(t + STAGES - 1);
        __syncwarp();
        mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
        if constexpr (!RG::BF16)  // every warp is past the last tile's MMAs
          bar_sync(kBarRing, NT);
      } else {
        bar_sync(kBarRing, NT);  // tile t staged, tile t - 1 done with
        const int p = t + STAGES - 1;
        if (p < total)
          stage_tile<TQ, TV>(smem + (p % STAGES) * L.stage, vb, qg, nq, vpad,
                             (p / nks) * VT, (p % nks) * KS, d, tid);
      }
      if constexpr (!RG::BF16) {
        to_planes<TV>(stage, planes, tid);
        bar_sync(kBarRing, NT);
      }
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        constexpr int TA = F32Q ? 3 : 1;  // bf16 terms of a query value
        uint32_t a[TA][4];
        if constexpr (F32Q) {
          // qoff of (row wm*16 + g (+ 8), column kk*16 + 2*tq (+ 8)): the
          // rows share g = row & 7, so the swizzled chunk is the column's
          // compile-time part a XOR g's high bits, OR qx
          const unsigned char* fs =
              stage + RG::RAW + (kk >> 1) * RG::QBOX + qbase;
          auto frag = [&](int a, int row8) {
            return *reinterpret_cast<const float2*>(
                fs + row8 * 1024 + (((a ^ g6) | qx) << 4));
          };
          const int a0 = (kk & 1) * 4;
          const float2 x[4] = {frag(a0, 0), frag(a0, 1), frag(a0 + 2, 0),
                               frag(a0 + 2, 1)};
#pragma unroll
          for (int j = 0; j < 4; ++j) split3(x[j], a[0][j], a[1][j], a[2][j]);
        } else {
          ldsm_x4(a_res + (wm * 16 + (lane & 15)) * ald + ks * KS + kk * 16 +
                      (lane >> 4) * 8,
                  a[0]);
        }
        if constexpr (RG::BF16) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            const int row = vr0 + np * 16 + (lane & 7) + (lane >> 4) * 8;
            ldsm_x4(stage + swz<ROWB>(row, kk * 2 + ((lane >> 3) & 1)), b);
#pragma unroll
            for (int ta = 0; ta < TA; ++ta) {
              mma(acc[2 * np], a[ta], b[0], b[1]);
              mma(acc[2 * np + 1], a[ta], b[2], b[3]);
            }
          }
        } else {
          // The products whose terms' orders sum to at most 2, smallest
          // first: h, m, l against an int8 value; hh, hm, hl, mh, mm, lh
          // for f32 x f32 (ml, lm, ll lie below 2^-23 of the product).  A
          // k-step's products are summed apart, then added to the chunk's
          // sums in f32: the tensor cores' sums round toward zero at the
          // larger operand's scale, so they meet the k-step's own sum and
          // never the whole dot.
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np >= npw) break;  // uniform over the warp
            uint32_t b[RG::TERMS][4];
#pragma unroll
            for (int tb = 0; tb < RG::TERMS; ++tb)
              ldsm_x4(planes + tb * VT * BLD +
                          (vr0 + np * 16 + (lane & 7) + (lane >> 4) * 8) *
                              BLD +
                          kk * 16 + ((lane >> 3) & 1) * 8,
                      b[tb]);
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int o = 2; o >= 0; --o)
#pragma unroll
              for (int ta = 0; ta < TA; ++ta) {
                const int tb = o - ta;
                if (tb >= 0 && tb < RG::TERMS) {
                  mma(t0, a[ta], b[tb][0], b[tb][1]);
                  mma(t1, a[ta], b[tb][2], b[tb][3]);
                }
              }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[2 * np][c] += t0[c];
              acc[2 * np + 1][c] += t1[c];
            }
          }
        }
      }
      if constexpr (TMA) {  // this warp is done with the stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[t % STAGES]);
      }

      if (ks == nks - 1) {  // hand the chunk's scores to the epilogue warps
        if (chunk > 0) bar_sync(kBarFree, 2 * NT);  // they are done with ss
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= 2 * npw) break;  // uniform over the warp
          const int col = vr0 + j * 8 + 2 * tq;
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
  };
  if (threadIdx.x < NT) {
    if (tma)
      mma_warps(Flag<true>{});
    else
      mma_warps(Flag<false>{});
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

  constexpr int RB = ROWS_AT_ONCE<R>;  // rows masked and folded at once
  unsigned char* sel_w =
      reinterpret_cast<unsigned char*>(smem + L.sel) + warp * 4 * VT;
  float lv[RPW][R];  // the running lists of query rows warp + 8*i
  int lp[RPW][R], npass[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    init_list<R>(lv[i], lp[i]);
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
      auxc[h] = SQ8 || l2 ? auxs[h * 32 + lane] : 0.f;
      live[h] = __ballot_sync(FULL, idc[h] >= 0);
      n_live += __popc(live[h]);
    }
    // per RB rows: row constant, liveness, DNF mask and pass counts of all
    // 128 candidates first (independent, so latencies overlap; a row whose
    // filter has a term that tests no attribute passes every live row,
    // counted once per chunk), then the fold of those above the k-th
#pragma unroll
    for (int i0 = 0; i0 < RPW; i0 += RB) {
      if constexpr (FS_SIDE == 1) break;  // the MMA side alone
      float cand[RB][VT / 32];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = warp + (NT / 32) * (i0 + i);
        const bool free = r < nq && (free_rows >> (i0 + i) & 1);
        int cnt = free ? n_live : 0;
#pragma unroll
        for (int h = 0; h < VT / 32; ++h) {
          const int c = h * 32 + lane;
          const float sc = row_score<SQ8>(ss[r * SLD + c], auxc[h], l2);
          bool ok = r < nq && idc[h] >= 0;
          if (ok && !free)
            ok = dnf_pass(act_s + r * f, bnd + r * fm, attrs_s + c * m, f,
                          m);
          if (!free) cnt += __popc(__ballot_sync(FULL, ok));
          cand[i][h] = ok ? sc : NEG_INF;
        }
        npass[i0 + i] += cnt;
      }
      if constexpr (FS_SIDE != 3)
        select_chunk<R, RB, VT / 32, true>(
            lv, lp, i0, cand, chunk == 0, chunk * VT, k, sel_w, lane,
            [&](int ii, int c) {
              return row_score<SQ8>(ss[(warp + (NT / 32) * ii) * SLD + c],
                                    auxs[c], l2);
            });
    }
    if (chunk + 1 < nch) bar_arrive(kBarFree, 2 * NT);  // ss may be refilled
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + (NT / 32) * i;
    if (r < nq)
      write_list<R>(lv[i], lp[i], ids + crow0, out_vals + (out_row0 + r) * k,
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

template <typename TQ, typename TV>
__global__ void __launch_bounds__(NTS) scan_sort_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters,
    const TQ* __restrict__ queries, const int16_t* __restrict__ lo,
    const int16_t* __restrict__ hi, const TV* __restrict__ vectors,
    const int16_t* __restrict__ attrs, const int* __restrict__ ids,
    const float* __restrict__ aux, float* __restrict__ out_vals,
    int* __restrict__ out_ids, int* __restrict__ out_npass, int qb, int d,
    int vpad, int m, int f, int k, bool l2, int p) {
  constexpr bool SQ8 = sizeof(TV) == 1;
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
      acc = row_score<SQ8>(acc, SQ8 || l2 ? aux[row] : 0.f, l2);
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
      int f, int k, bool l2, int n_queries, int *order, cudaStream_t stream
#define FS_KERNEL_ARGS(TQ, TV)                                               \
  (const int*)slot_cluster, (const int*)slot_tile, (const int*)n_unique,     \
      u_cap, n_clusters, (const TQ*)queries, (const int16_t*)lo,             \
      (const int16_t*)hi, (const TV*)vectors, (const int16_t*)attrs,         \
      (const int*)ids, (const float*)aux, (float*)out_vals, (int*)out_ids,   \
      (int*)out_npass, qb, d, vpad, m, f, k, l2

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
template <typename TQ, typename TV>
cudaError_t launch_sort(FS_PARAMS) {
  auto kernel = sortk::scan_sort_kernel<TQ, TV>;
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

template <typename TQ, typename TV, int R>
cudaError_t launch_fma_r(FS_PARAMS) {
  auto kernel = ffma::scan_fma_kernel<TQ, TV, R>;
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
      vpad, m, f, k, l2, n_queries, order, stream

template <typename TQ, typename TV>
cudaError_t launch_fma(FS_PARAMS) {
  if (k > 32 * MAX_R) return launch_sort<TQ, TV>(FS_FWD);
  switch (list_slots(k)) {
    case 1: return launch_fma_r<TQ, TV, 1>(FS_FWD);
    case 2: return launch_fma_r<TQ, TV, 2>(FS_FWD);
    case 4: return launch_fma_r<TQ, TV, 4>(FS_FWD);
    default: return launch_fma_r<TQ, TV, 8>(FS_FWD);
  }
}

// The tensor-core body's launch order (cluster-major): order[x] is the
// slot the x-th CTA takes, the slots sorted by (cluster, slot), pads last.
// Each thread ranks one slot's key against every other (the keys are
// distinct), so the order is the same on every run; slot tables hold a few
// thousand slots.
__global__ void __launch_bounds__(256) order_kernel(
    const int* __restrict__ slot_cluster, const int* __restrict__ slot_tile,
    const int* __restrict__ n_unique, int u_cap, int n_clusters, int n_slots,
    int* __restrict__ order) {
  __shared__ unsigned long long keys[256];
  auto key = [&](int s) {
    const int c = slot_cluster[s];
    const bool pad = is_pad(s, slot_tile[s], c, n_unique, u_cap, n_clusters);
    return (unsigned long long)(pad ? 0xffffffffu : (unsigned)c) << 32 |
           (unsigned)s;
  };
  const int i = blockIdx.x * 256 + threadIdx.x;
  const unsigned long long mine = i < n_slots ? key(i) : ~0ull;
  int rank = 0;
  for (int b = 0; b < n_slots; b += 256) {
    __syncthreads();
    keys[threadIdx.x] = b + threadIdx.x < n_slots ? key(b + threadIdx.x) : ~0ull;
    __syncthreads();
    const int n = min(256, n_slots - b);
    for (int j = 0; j < n; ++j) rank += keys[j] < mine;
  }
  if (i < n_slots) order[rank] = i;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (nothing new
// to link); null where the driver does not give it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// A 2-D tensor map over rows x cols values of T (row stride cols), boxes of
// box_rows x box_cols, swizzled for box rows of box_cols * sizeof(T) bytes
// (128, or 64); out of range reads as zero.
template <typename T>
bool encode_2d(CUtensorMap* tm, const void* base, size_t rows, int cols,
               int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw = box_cols * sizeof(T) == 128
                                    ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(tm, tma_type<T>(), 2, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TQ, typename TV, int R>
cudaError_t launch_tc_r(FS_PARAMS, bool tma) {
  using RG = tc::Ring<TV>;
  auto kernel = tc::scan_tc_kernel<TQ, TV, R>;
  const size_t smem = tc::layout<TQ, TV>(d, m, f).total;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_v, tm_q;
  memset(&tm_v, 0, sizeof tm_v);
  memset(&tm_q, 0, sizeof tm_q);
  if (tma) {
    if (!encode_2d<TV>(&tm_v, vectors, (size_t)n_clusters * vpad, d, tc::VT,
                       RG::KS))
      return cudaErrorInvalidValue;
    if (sizeof(TQ) == 4 &&
        !encode_2d<float>(&tm_q, queries, (size_t)n_queries, d,
                          qb < QT ? qb : QT, 32))
      return cudaErrorInvalidValue;
  }
  if (FS_SLOT_ORDER) order = nullptr;
  if (order != nullptr) {
    order_kernel<<<(n_slots + 255) / 256, 256, 0, stream>>>(
        (const int*)slot_cluster, (const int*)slot_tile,
        (const int*)n_unique, u_cap, n_clusters, n_slots, order);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_slots, (qb + QT - 1) / QT);
  kernel<<<grid, 2 * NT, smem, stream>>>(FS_KERNEL_ARGS(TQ, TV), tm_v, tm_q,
                                         order, tma);
  return cudaGetLastError();
}

// Whether the tensor-core body takes a dtype pair at these shapes: at most
// MAX_M attributes, and its shared memory fits.
template <typename TQ, typename TV>
bool tc_fits(int d, int m, int f) {
  return m <= tc::MAX_M && tc::layout<TQ, TV>(d, m, f).total <= SMEM_MAX;
}

// A dtype pair: the tensor-core body where it fits (k <= 256), else the FMA
// or sort body; the choice rests on the shapes alone.  tma: the TMA ring,
// where both operands' rows are 16-byte aligned with a 16-byte multiple
// stride (else scalar staging).
template <typename TQ, typename TV>
cudaError_t launch_pair(FS_PARAMS) {
  if (!tc_fits<TQ, TV>(d, m, f) || k > 32 * MAX_R)
    return launch_fma<TQ, TV>(FS_FWD);
  const bool tma = d % (16 / sizeof(TV)) == 0 && d % (16 / sizeof(TQ)) == 0 &&
                   (uintptr_t)queries % 16 == 0 &&
                   (uintptr_t)vectors % 16 == 0;
  switch (list_slots(k)) {
    case 1: return launch_tc_r<TQ, TV, 1>(FS_FWD, tma);
    case 2: return launch_tc_r<TQ, TV, 2>(FS_FWD, tma);
    case 4: return launch_tc_r<TQ, TV, 4>(FS_FWD, tma);
    default: return launch_tc_r<TQ, TV, 8>(FS_FWD, tma);
  }
}

}  // namespace

// Which body the launcher picks for these operands: 1 = tensor cores,
// 0 = f32 FMA, -1 = refused.  For the tests and the timing script.
extern "C" int filtered_scan_tiled_body(int d, int m, int f, int mode,
                                        int q_dtype, int v_dtype) {
  const bool dot_l2 = mode == kDot || mode == kL2;
  if (dot_l2 && q_dtype == kBF16 && v_dtype == kBF16)
    return tc_fits<__nv_bfloat16, __nv_bfloat16>(d, m, f);
  if (dot_l2 && q_dtype == kF32 && v_dtype == kBF16)
    return tc_fits<float, __nv_bfloat16>(d, m, f);
  if (dot_l2 && q_dtype == kF32 && v_dtype == kF32)
    return tc_fits<float, float>(d, m, f);
  if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8)
    return tc_fits<float, int8_t>(d, m, f);
  return -1;
}

#define FS_ARGS                                                               \
  n_slots, slot_cluster, slot_tile, n_unique, u_cap, n_clusters, queries, lo, \
      hi, vectors, attrs, ids, aux, out_vals, out_ids, out_npass, qb, d,      \
      vpad, m, f, k, mode == kL2, n_queries, (int*)order, (cudaStream_t)stream
// Returns LAUNCH<TQ, TV>(FS_ARGS) for the operands' pair: bf16 or f32
// queries against bf16 vectors (f32: the sharded search) and f32 x f32, dot
// or l2 (a run-time flag), and SQ8 (f32 queries against int8 rows, dot).
#define FS_DISPATCH(LAUNCH)                                                \
  const bool dot_l2 = mode == kDot || mode == kL2;                         \
  if (dot_l2 && q_dtype == kBF16 && v_dtype == kBF16)                      \
    return LAUNCH<__nv_bfloat16, __nv_bfloat16>(FS_ARGS);                  \
  if (dot_l2 && q_dtype == kF32 && v_dtype == kBF16)                       \
    return LAUNCH<float, __nv_bfloat16>(FS_ARGS);                          \
  if (dot_l2 && q_dtype == kF32 && v_dtype == kF32)                        \
    return LAUNCH<float, float>(FS_ARGS);                                  \
  if (mode == kSq8 && q_dtype == kF32 && v_dtype == kI8)                   \
    return LAUNCH<float, int8_t>(FS_ARGS);                                 \
  return cudaErrorInvalidValue

// Plain C entry point (bound with ctypes).  n_unique may be null (every
// slot live); aux is the norms (mode 1) or scales (mode 2) pointer, null for
// mode 0; n_queries the queries' rows (Qpad); order a scratch of n_slots
// int32 for the tensor-core body's launch order (null: slot order).  One
// entry point, two launches where the tensor-core body runs (the order,
// then the scan).  Returns a cudaError_t: 0 on a successful launch.
extern "C" int filtered_scan_tiled_launch(
    int n_slots, const void* slot_cluster, const void* slot_tile,
    const void* n_unique, int u_cap, int n_clusters, const void* queries,
    const void* lo, const void* hi, const void* vectors, const void* attrs,
    const void* ids, const void* aux, void* out_vals, void* out_ids,
    void* out_npass, int qb, int d, int vpad, int m, int f, int k, int mode,
    int q_dtype, int v_dtype, int n_queries, void* order, void* stream) {
  if (n_slots <= 0) return cudaSuccess;
  if (k < 1 || k > vpad || qb < 1 || d < 1 || f < 1 || m < 0)
    return cudaErrorInvalidValue;
  FS_DISPATCH(launch_pair);
}

// The same contract on the f32 FMA body whatever the shapes (k <= 256):
// the body the tensor-core one replaced for f32 x f32 and SQ8, launched
// only to be timed and checked beside it.
extern "C" int filtered_scan_tiled_fma_launch(
    int n_slots, const void* slot_cluster, const void* slot_tile,
    const void* n_unique, int u_cap, int n_clusters, const void* queries,
    const void* lo, const void* hi, const void* vectors, const void* attrs,
    const void* ids, const void* aux, void* out_vals, void* out_ids,
    void* out_npass, int qb, int d, int vpad, int m, int f, int k, int mode,
    int q_dtype, int v_dtype, int n_queries, void* order, void* stream) {
  if (n_slots <= 0) return cudaSuccess;
  if (k < 1 || k > vpad || k > 32 * MAX_R || qb < 1 || d < 1 || f < 1 ||
      m < 0)
    return cudaErrorInvalidValue;
  FS_DISPATCH(launch_fma);
}
