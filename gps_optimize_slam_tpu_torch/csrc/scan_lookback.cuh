// K1's kernel: a single-pass inclusive scan (suffix scan under `reverse`)
// with decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA NVR-2016-002), over L
// structure-of-arrays leaves, any n, one launch, and the parts of it that K2
// (scan_tiled.cu: persistent blocks that stage the next tile ahead) shares:
// the scratch layout, the tile's steps 3 and 5 (tile_reduce, tile_finish),
// the look-back (look_back) and the store (tile_store).
//
// In K1 (scan.cu) one block of kScanThreads threads scans one tile of kScanThreads x ITEMS
// scan-order elements:
//   1. a ticket (atomicAdd) names the tile, so every tile a block waits on
//      belongs to a block that has already started (forward progress);
//   2. the leaves are staged into shared memory with consecutive threads on
//      consecutive elements (coalesced), padded by one element per 32 so
//      that the blocked per-thread reads below do not collide on banks;
//      past n the combine's identity;
//   3. each thread folds its ITEMS consecutive elements in registers,
//      leaving their running prefixes in shared memory; each warp scans the
//      thread totals with __shfl_up_sync (5 steps, no barrier), and every
//      thread then puts its lane's exclusive prefix in front of its
//      prefixes, which makes them inclusive within the warp; warp 0 scans
//      the 8 warp totals;
//   4. warp 0 publishes the tile aggregate (flag A), walks back over the
//      predecessors' flags 32 tiles at a time (one per lane) until one
//      shows its inclusive prefix (flag P), folds the window in a shuffle
//      tree, and publishes the tile's own inclusive prefix (flag P). Values
//      are written before a release store of the flag and read after an
//      acquire load of it;
//   5. every thread puts its warp's exclusive composite (tile carry, then
//      warp prefix) in front of each of its elements, so each element meets
//      its exclusive prefix (the very first with the identity), and the
//      outputs leave through shared memory, coalesced.
//
// No per-thread composite lives across the look-back (step 4): what steps 3
// and 5 share is in shared memory, which keeps the 27-leaf float64 filter's
// registers within the 255 a thread has.
//
// Argument order is the JAX one throughout: the composite earlier in scan
// order is the FIRST argument (a predecessor found walking back goes on the
// left). Under `reverse` scan order k touches position n - 1 - k, so one
// code path serves both directions.
//
// Scratch (the wrapper allocates it; the launcher zeroes the flags with one
// cudaMemsetAsync): the ticket and one flag word per tile, then per tile L
// aggregate and L inclusive values. A flag goes 0 -> A -> P; the aggregate
// slot is never rewritten once flagged, so a reader never sees it torn.
//
// Batch grid (K1 here, K2's persistent blocks the same way in scan_tiled.cu):
// leaves (L, B, n) hold B independent rows, each scanned along n (the JAX
// package's vmap of the scan). One launch covers
// every row's tiles, B * tiles(n) blocks, and the one ticket counter runs
// over all of them in row-major order (ticket t is tile t % tiles of row
// t / tiles), so every tile a block waits on still belongs to a block that
// started before it. The flags and values stay one slot per (row, tile),
// and the look-back gets its row's slice of them, so its walk stops at its
// own row's first tile (tile 0 of a row publishes its prefix at once, as
// tile 0 of a single row does). One counter and not one per row: a row's
// tiles then start in order and rows in order, which the single-row proof
// of progress covers as it is; per-row counters would need a row picked
// for each block by some other means. Each row meets the same tiles and
// the same combines within a tile as a call on that row alone; the
// look-back folds what its predecessors have published by then, as it does
// for a single row, so a row agrees with the call alone as two calls on one
// row agree: bit for bit where the combine is exact (add2 on counts, max3,
// min3), to the scan's tolerance where the walk's association rounds (the
// float64 filter showed it on the card).
//
// A batch whose rows fit in a thread-block cluster does not come here: K1
// launches it on the cluster path of scan_cluster.cuh (a cluster a row, the
// carry read from the other blocks' shared memory). This kernel takes the
// batches of longer rows, every single row and every filter launch.
//
// What bounds it on this card: bytes for the 2-4-leaf combines at long n
// (each leaf read once and written once), operations for the 27-leaf filter
// (489 flops a combine, about two combines an element), and below a few
// thousand elements launch latency. Intermediates live in shared memory,
// not in registers, so ITEMS does not raise register pressure; ITEMS is
// picked per leaf count and type to keep the tile's staging within the
// opt-in shared memory.
//
// The 27-leaf filter takes a tile of its own, work-efficient ("runs",
// tile_reduce_runs / tile_finish_runs): its combine (a 3x3 inverse, a dozen
// 3x3 products) is dear, and steps 3 and 5 above cost it about seven
// combines an element at ITEMS = 1 (a five-step ladder over every element,
// then the carry and the warp prefix composed by every thread, then the
// element). Here each thread folds a run of ITEMS consecutive elements in
// registers without writing them back (ITEMS - 1 combines), the ladder runs
// over the thread totals (5), the lane's exclusive prefix is folded into
// the run's first element in shared memory (1), the tile carry and the warp
// prefix are composed once a warp (1, the same for all its lanes), and a
// second pass folds each element from its exclusive prefix and stores it
// (ITEMS): 2 ITEMS + 6 combines a run, 3.5 an element at ITEMS = 4.
// Staging every leaf of the tile is what bounds ITEMS. The tile is 128
// threads x 4 items (27 x padded(512) values: 114 KB in float64, 57 KB in
// float32), so two float64 blocks share an SM (the combine's ~244
// registers a thread allow two blocks of 128 threads, one of 256) and one
// block's loads and stores overlap the other's combines: 256 threads x 4
// items, one block an SM, took 1.22 ms where this takes 0.86 at phase 10's
// rows (PERF.md). The runs' longer chain of dependent combines (about 18 a
// tile against 10) loses while a launch holds few tiles, so launches of
// fewer than kRunsMinF32 / kRunsMinF64 elements keep the ladder tile.
// Nothing a thread holds lives across the look-back: the runs' first
// elements carry the lane prefixes, the warp totals are in shared memory.
// rts (12 leaves) and quat_chain (4: a square root and a division a
// combine) take the runs tile too in batches of 2^15 elements or more
// (RunsTile): their ladder tile spent about five combines an element in
// serial steps, and a block's loads, folds and stores follow one another,
// so fewer combines and more blocks an SM, each folding while another
// loads, shorten a launch (phase 10's rows: rts 0.258 -> 0.211 ms,
// quat_chain 0.093 -> 0.085, PERF.md). A single row keeps the ladder tile.
#pragma once

#include "scan_ops.cuh"

namespace {

constexpr int kScanWarps = kScanThreads / 32;

enum : int { kTileEmpty = 0, kTileAggregate = 1, kTilePrefix = 2 };

// Elements per thread of the ladder tile for a combine of L leaves.
__host__ __device__ constexpr int scan_items(int L) { return L >= 27 ? 1 : L >= 12 ? 2 : 8; }

// The filter's runs tile: its items a thread, its threads a block, and the
// fewest elements of a launch (rows times n) that take it, by type; below
// them the filter keeps the ladder tile at one item a thread, whose
// shorter chain of dependent combines wins while the launch holds few
// tiles (the crossovers measured on an H100, PERF.md: float32 between a
// row of 32,768 and one of 65,536; float64 between a row of 32,768 and
// eight rows of 4,661). Staging takes 27 x padded(threads x items) values.
constexpr int kRunsItems = 4;
constexpr int kRunsThreads = 128;
constexpr long long kRunsMinF32 = 65536;
constexpr long long kRunsMinF64 = 32769;

// Which combines have the work-efficient runs tile, whether only in a
// batch grid, its items a thread and threads a block, and the fewest
// elements of a launch that take it, by type.
template <bool HAS, bool BATCH_ONLY, int ITEMS, int THREADS, long long MIN_F32, long long MIN_F64>
struct RunsShape {
  static constexpr bool kHas = HAS, kBatchOnly = BATCH_ONLY;
  static constexpr int kItems = ITEMS, kThreads = THREADS;
  static constexpr long long kMinF32 = MIN_F32, kMinF64 = MIN_F64;
};
template <class Op>
struct RunsTile : RunsShape<false, false, 1, kScanThreads, 0, 0> {};
template <typename T>
struct RunsTile<Filter<T>> : RunsShape<true, false, kRunsItems, kRunsThreads, kRunsMinF32, kRunsMinF64> {};
// rts and quat_chain in a batch grid, from 2^15 elements a launch: every
// batch measured there and past it (2 to 64 rows of 16,385, phase 10's four
// rows of up to 524,288) was faster on these tiles than on the ladder tile
// in both types (tools/scan_tile_sweep.py on an H100, PERF.md); smaller
// batched launches were not measured and keep the ladder. rts at 4 items a
// thread (within 2 % of the fastest tile at phase 10's rows in float64,
// the fastest below them); quat_chain at 8 (at 4 it lost to the ladder at
// phase 10's rows: 0.097 against 0.093 ms).
template <typename T>
struct RunsTile<RtsSuffix<T>> : RunsShape<true, true, 4, 128, 1LL << 15, 1LL << 15> {};
template <typename T>
struct RunsTile<QuatChain<T>> : RunsShape<true, true, 8, 128, 1LL << 15, 1LL << 15> {};

// Whether a launch of `batch` rows of n elements of T takes Op's runs tile.
template <class Op, typename T>
__host__ __device__ constexpr bool takes_runs(int n, int batch) {
  using R = RunsTile<Op>;
  return R::kHas && (batch > 1 || !R::kBatchOnly) &&
         (long long)n * batch >= (sizeof(T) == 4 ? R::kMinF32 : R::kMinF64);
}

// Shared-memory index of tile element e: one pad element per 32.
__host__ __device__ constexpr int padded(int e) { return e + (e >> 5); }

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <int L, typename T>
__device__ __forceinline__ void shfl_up_leaves(const T* v, int d, T* o) {
#pragma unroll
  for (int l = 0; l < L; ++l) o[l] = __shfl_up_sync(0xffffffffu, v[l], d);
}

template <int L, typename T>
__device__ __forceinline__ void shfl_down_leaves(const T* v, int d, T* o) {
#pragma unroll
  for (int l = 0; l < L; ++l) o[l] = __shfl_down_sync(0xffffffffu, v[l], d);
}

// run = have ? op(run, x) : x; the earlier composite `run` stays first.
template <class Op, typename T>
__device__ __forceinline__ void fold_after(T* run, const T* x, bool have) {
  T y[Op::L];
  if (have) {
    Op::apply(run, x, y);
    copy_leaves<Op::L>(y, run);
  } else {
    copy_leaves<Op::L>(x, run);
  }
}

// Scratch layout of one scan of n elements over tiles of THREADS x ITEMS
// (K1's items and block by default; K2 and the runs tile pick their own).
template <class Op, typename T, int ITEMS = scan_items(Op::L), int THREADS = kScanThreads>
struct LookbackLayout {
  static constexpr int kItems = ITEMS;
  static constexpr int kTile = THREADS * kItems;
  static constexpr int kStride = padded(kTile);  // shared elements per leaf row
  __host__ __device__ static int tiles(int n) { return (n + kTile - 1) / kTile; }
  // For `batch` rows of n elements: one ticket, a flag per (row, tile).
  static size_t flag_bytes(int n, int batch = 1) {
    return (size_t)(1 + (size_t)batch * tiles(n)) * sizeof(int);
  }
  static size_t values_offset(int n, int batch = 1) { return (flag_bytes(n, batch) + 15) / 16 * 16; }
  static size_t scratch_bytes(int n, int batch = 1) {
    return values_offset(n, batch) + 2 * (size_t)batch * tiles(n) * Op::L * sizeof(T);
  }
  static size_t smem_bytes() { return (size_t)Op::L * kStride * sizeof(T); }
};

// Publishes a tile's aggregate `tot` (flag A), or for tile 0 its inclusive
// prefix (flag P); one thread.
template <class Op, typename T>
__device__ __forceinline__ void publish_aggregate(int tile, const T* tot, int* flags, T* agg, T* incl) {
  constexpr int L = Op::L;
  if (tile == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) incl[l] = tot[l];
    store_release(flags, kTilePrefix);
    return;
  }
#pragma unroll
  for (int l = 0; l < L; ++l) agg[(size_t)tile * L + l] = tot[l];
  store_release(flags + tile, kTileAggregate);
}

// Warp 0's part of step 4. `tot` is the tile aggregate and `carry` the
// tile's exclusive composite (both shared); lane 0 accumulates the walk in
// `carry` (tile > 0) and publishes the tile's inclusive prefix. PUBLISHED:
// the aggregate (tile 0: the prefix) was published already
// (publish_aggregate), as K2's batch grid does as soon as a tile is reduced.
template <class Op, typename T, bool PUBLISHED = false>
__device__ __forceinline__ void look_back(int tile, const T* tot, int* flags, T* agg, T* incl,
                                          T* carry) {
  constexpr int L = Op::L;
  const int lane = threadIdx.x & 31;
  if (!PUBLISHED && lane == 0) publish_aggregate<Op, T>(tile, tot, flags, agg, incl);
  if (tile == 0) return;
  T v[L], x[L], y[L];
  bool have = false;
  for (int base = tile - 1;; base -= 32) {
    const int pred = base - lane;  // lane 0 is the nearest predecessor
    int f = kTilePrefix;           // before tile 0: never folded (tile 0 is P)
    if (pred >= 0) {
      do {
        f = load_acquire(flags + pred);
      } while (f == kTileEmpty);
    }
    const unsigned pmask = __ballot_sync(0xffffffffu, f == kTilePrefix);
    const int last = pmask ? __ffs(pmask) - 1 : 31;  // farthest lane folded
    if (lane <= last && pred >= 0) {
      const T* src = (f == kTilePrefix ? incl : agg) + (size_t)pred * L;
#pragma unroll
      for (int l = 0; l < L; ++l) v[l] = __ldcg(src + l);
    } else {
      Op::identity(v);
    }
    // Lane 0 gathers lanes [0, last]; the farther (earlier) half goes first.
    for (int d = 1; d <= last; d <<= 1) {
      shfl_down_leaves<L>(v, d, x);
      if (lane + d < 32) {
        Op::apply(x, v, y);
        copy_leaves<L>(y, v);
      }
    }
    if (lane == 0) {
      if (have) {
        Op::apply(v, carry, y);  // the window is earlier than what was walked
        copy_leaves<L>(y, carry);
      } else {
        copy_leaves<L>(v, carry);
        have = true;
      }
    }
    if (pmask) break;
  }
  if (lane == 0) {
    Op::apply(carry, tot, y);
#pragma unroll
    for (int l = 0; l < L; ++l) incl[(size_t)tile * L + l] = y[l];
    store_release(flags + tile, kTilePrefix);
  }
}

// Step 2 as K1 takes it: the tile's leaves into `s` ([L][padded(TILE)]) with
// plain loads, consecutive threads on consecutive elements. Leaf l of the
// row starts at in + l * ld.
template <class Op, typename T, int ITEMS, int THREADS = kScanThreads>
__device__ __forceinline__ void tile_load(const T* __restrict__ in, int n, size_t ld, int reverse,
                                          int k0, T* s) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(THREADS * ITEMS);
  T ident[L];
  Op::identity(ident);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const T* row = in + l * ld;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * THREADS + (int)threadIdx.x;
      const int k = k0 + e;
      s[l * STRIDE + padded(e)] = k < n ? row[reverse ? n - 1 - k : k] : ident[l];
    }
  }
}

// Step 3 on a staged tile: every element's inclusive prefix within its warp
// in place in `s`, the inclusive warp prefixes in `s_warp` (the last is the
// tile aggregate). Barriers inside; one ends the call.
template <class Op, typename T, int ITEMS>
__device__ __forceinline__ void tile_reduce(T* s, T (*s_warp)[Op::L]) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(kScanThreads * ITEMS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T acc[L], x[L], y[L];
  const int e0 = tid * ITEMS;
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = s[l * STRIDE + padded(e0)];
  for (int i = 1; i < ITEMS; ++i) {
    const int at = padded(e0 + i);
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = s[l * STRIDE + at];
    Op::apply(acc, x, y);
    copy_leaves<L>(y, acc);
#pragma unroll
    for (int l = 0; l < L; ++l) s[l * STRIDE + at] = y[l];
  }

#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    shfl_up_leaves<L>(acc, d, x);
    if (lane >= d) {
      Op::apply(x, acc, y);
      copy_leaves<L>(y, acc);
    }
  }
  if (lane == 31) copy_leaves<L>(acc, s_warp[warp]);
  if (ITEMS == 1) {
    // acc is now the lane's inclusive prefix within the warp.
#pragma unroll
    for (int l = 0; l < L; ++l) s[l * STRIDE + padded(e0)] = acc[l];
  } else {
    shfl_up_leaves<L>(acc, 1, x);  // the lane's exclusive prefix
    if (lane > 0) {
      for (int i = 0; i < ITEMS; ++i) {
        const int at = padded(e0 + i);
#pragma unroll
        for (int l = 0; l < L; ++l) acc[l] = s[l * STRIDE + at];
        Op::apply(x, acc, y);
#pragma unroll
        for (int l = 0; l < L; ++l) s[l * STRIDE + at] = y[l];
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    T w[L];
    if (lane < kScanWarps) copy_leaves<L>(s_warp[lane], w);
    else Op::identity(w);
#pragma unroll
    for (int d = 1; d < kScanWarps; d <<= 1) {
      shfl_up_leaves<L>(w, d, x);
      if (lane >= d) {
        Op::apply(x, w, y);
        copy_leaves<L>(y, w);
      }
    }
    if (lane < kScanWarps) copy_leaves<L>(w, s_warp[lane]);
  }
  __syncthreads();
}

// Step 5: the warp's exclusive composite (tile carry, warp prefix) in front
// of each element; without one (tile 0, warp 0) the elements are final, but
// the very first still meets the identity. A barrier ends the call.
template <class Op, typename T, int ITEMS>
__device__ __forceinline__ void tile_finish(int tile, T* s, T (*s_warp)[Op::L], const T* s_carry) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(kScanThreads * ITEMS);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int e0 = tid * ITEMS;
  T acc[L], x[L], y[L];
  bool have = false;
  if (tile > 0) {
    copy_leaves<L>(s_carry, acc);
    have = true;
  }
  if (warp > 0) {
    fold_after<Op, T>(acc, s_warp[warp - 1], have);
    have = true;
  }
  if (!have && tid == 0) {
    have = true;
    Op::identity(acc);
  }
  if (have) {
    const int items = tile > 0 || warp > 0 ? ITEMS : 1;
    for (int i = 0; i < items; ++i) {
      const int at = padded(e0 + i);
#pragma unroll
      for (int l = 0; l < L; ++l) x[l] = s[l * STRIDE + at];
      Op::apply(acc, x, y);
#pragma unroll
      for (int l = 0; l < L; ++l) s[l * STRIDE + at] = y[l];
    }
  }
  __syncthreads();
}

// A barrier of the THREADS threads that scan a tile: the whole block
// (__syncthreads) where BAR < 0, else named barrier BAR, which K2's batch
// grid takes so that its producer warp is not held at the compute warps'
// barriers.
template <int BAR, int THREADS>
__device__ __forceinline__ void tile_sync() {
  if constexpr (BAR < 0) __syncthreads();
  else asm volatile("bar.sync %0, %1;" ::"n"(BAR), "n"(THREADS) : "memory");
}

// Leaf l's scan-order element e of a staged tile: K1's layout
// (s[l * STRIDE + padded(e)]), or a staged tile of K2's batch grid, which
// names its own (StagedTile, scan_tiled.cu).
template <int STRIDE, typename T>
__device__ __forceinline__ T& tile_at(T* s, int l, int e) {
  return s[l * STRIDE + padded(e)];
}
template <int STRIDE, class Tile>
__device__ __forceinline__ auto& tile_at(const Tile& s, int l, int e) {
  return s(l, e);
}

// Step 3 of the runs tile: each thread folds its ITEMS consecutive elements
// into a total, the warp's ladder scans the totals, the lane's exclusive
// prefix within the warp is folded into its run's first element in place,
// and the inclusive warp prefixes go to `s_warp` (the last is the tile
// aggregate). Barriers inside (tile_sync<BAR, THREADS>); one ends the call.
template <class Op, typename T, int ITEMS, int THREADS, int BAR = -1, class Tile>
__device__ __forceinline__ void tile_reduce_runs(const Tile& s, T (*s_warp)[Op::L]) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(THREADS * ITEMS);
  constexpr int WARPS = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = tid * ITEMS;
  T acc[L], x[L], y[L];
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = tile_at<STRIDE>(s, l, e0);
  for (int i = 1; i < ITEMS; ++i) {
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = tile_at<STRIDE>(s, l, e0 + i);
    Op::apply(acc, x, y);
    copy_leaves<L>(y, acc);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    shfl_up_leaves<L>(acc, d, x);
    if (lane >= d) {
      Op::apply(x, acc, y);
      copy_leaves<L>(y, acc);
    }
  }
  if (lane == 31) copy_leaves<L>(acc, s_warp[warp]);
  shfl_up_leaves<L>(acc, 1, x);  // the lane's exclusive prefix within the warp
  if (lane > 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = tile_at<STRIDE>(s, l, e0);
    Op::apply(x, acc, y);
#pragma unroll
    for (int l = 0; l < L; ++l) tile_at<STRIDE>(s, l, e0) = y[l];
  }
  tile_sync<BAR, THREADS>();
  if (warp == 0) {
    T w[L];
    if (lane < WARPS) copy_leaves<L>(s_warp[lane], w);
    else Op::identity(w);
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      shfl_up_leaves<L>(w, d, x);
      if (lane >= d) {
        Op::apply(x, w, y);
        copy_leaves<L>(y, w);
      }
    }
    if (lane < WARPS) copy_leaves<L>(w, s_warp[lane]);
  }
  tile_sync<BAR, THREADS>();
}

// Step 5 of the runs tile: the warp's exclusive composite (tile carry, then
// the earlier warps' prefix), composed once a warp, starts each thread's
// second pass over its run, which stores every element's inclusive prefix;
// without one (tile 0, warp 0) the first thread starts from the identity,
// as the plain ladder's very first element meets it, and the others from
// their first element, which holds their lane prefix already. A barrier
// ends the call.
template <class Op, typename T, int ITEMS, int THREADS, int BAR = -1, class Tile>
__device__ __forceinline__ void tile_finish_runs(int tile, const Tile& s, T (*s_warp)[Op::L], const T* s_carry) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(THREADS * ITEMS);
  const int tid = threadIdx.x, warp = tid >> 5;
  T acc[L], x[L], y[L];
  bool have = false;
  if (tile > 0) {
    copy_leaves<L>(s_carry, acc);
    have = true;
  }
  if (warp > 0) {
    fold_after<Op, T>(acc, s_warp[warp - 1], have);
    have = true;
  }
  if (!have && tid == 0) {
    have = true;
    Op::identity(acc);
  }
  for (int i = 0; i < ITEMS; ++i) {
    const int e = tid * ITEMS + i;
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = tile_at<STRIDE>(s, l, e);
    if (have) {
      Op::apply(acc, x, y);
      copy_leaves<L>(y, acc);
    } else {
      copy_leaves<L>(x, acc);
      have = true;
    }
#pragma unroll
    for (int l = 0; l < L; ++l) tile_at<STRIDE>(s, l, e) = acc[l];
  }
  tile_sync<BAR, THREADS>();
}

// The finished tile from `s` to the output leaves, coalesced; leaf l of the
// row starts at out + l * ld.
template <class Op, typename T, int ITEMS, int THREADS = kScanThreads>
__device__ __forceinline__ void tile_store(const T* s, T* __restrict__ out, int n, size_t ld,
                                           int reverse, int k0) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(THREADS * ITEMS);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    T* row = out + l * ld;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * THREADS + (int)threadIdx.x;
      const int k = k0 + e;
      if (k < n) row[reverse ? n - 1 - k : k] = s[l * STRIDE + padded(e)];
    }
  }
}

template <class Op, typename T, int ITEMS, bool RUNS, int THREADS>
__global__ void __launch_bounds__(THREADS)
lookback_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int batch, int reverse,
                     int* ticket, T* agg, T* incl) {
  constexpr int L = Op::L;
  constexpr int WARPS = THREADS / 32;
  using Layout = LookbackLayout<Op, T, ITEMS, THREADS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [L][padded(TILE)]
  __shared__ T s_warp[WARPS][L];         // warp totals, then inclusive warp prefixes
  __shared__ T s_carry[L];               // the tile's exclusive composite
  __shared__ int s_tile;
  int* flags = ticket + 1;

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  // The ticket names a (row, tile); the row's leaves and its scratch slice.
  const int tiles = Layout::tiles(n);
  const int row = s_tile / tiles, tile = s_tile % tiles;
  const size_t ld = (size_t)batch * n;
  in += (size_t)row * n, out += (size_t)row * n;
  flags += (size_t)row * tiles, agg += (size_t)row * tiles * L, incl += (size_t)row * tiles * L;
  const int k0 = tile * Layout::kTile;

  static_assert(RUNS || THREADS == kScanThreads, "the ladder tile's steps are kScanThreads wide");
  tile_load<Op, T, ITEMS, THREADS>(in, n, ld, reverse, k0, s);
  __syncthreads();
  if constexpr (RUNS) tile_reduce_runs<Op, T, ITEMS, THREADS>(s, s_warp);
  else tile_reduce<Op, T, ITEMS>(s, s_warp);
  if (threadIdx.x < 32) {
    look_back<Op, T>(tile, s_warp[WARPS - 1], flags, agg, incl, s_carry);
  }
  __syncthreads();
  if constexpr (RUNS) tile_finish_runs<Op, T, ITEMS, THREADS>(tile, s, s_warp, s_carry);
  else tile_finish<Op, T, ITEMS>(tile, s, s_warp, s_carry);
  tile_store<Op, T, ITEMS, THREADS>(s, out, n, ld, reverse, k0);
}

// K1's launch: zero the ticket and flags, then one grid over every row's
// tiles, the ladder tile or (the filter, from kRunsMinF32 / kRunsMinF64 elements)
// the runs tile. `scratch` holds LookbackScratch's bytes.
template <class Op, typename T>
struct LookbackScan {
  template <int ITEMS, bool RUNS, int THREADS>
  static cudaError_t launch(const void* in, void* out, int n, int batch, int reverse, void* scratch,
                            cudaStream_t stream) {
    using Layout = LookbackLayout<Op, T, ITEMS, THREADS>;
    const long long blocks = (long long)batch * Layout::tiles(n);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    char* base = static_cast<char*>(scratch);
    T* agg = reinterpret_cast<T*>(base + Layout::values_offset(n, batch));
    T* incl = agg + (size_t)blocks * Op::L;
    const size_t smem = Layout::smem_bytes();
    cudaError_t e = allow_smem(lookback_scan_kernel<Op, T, ITEMS, RUNS, THREADS>, smem);
    if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, Layout::flag_bytes(n, batch), stream);
    if (e != cudaSuccess) return e;
    lookback_scan_kernel<Op, T, ITEMS, RUNS, THREADS><<<(unsigned)blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, batch, reverse,
        reinterpret_cast<int*>(base), agg, incl);
    return cudaGetLastError();
  }
  static cudaError_t run(const void* in, void* out, int n, int batch, int reverse, void* scratch,
                         cudaStream_t stream) {
    if (n <= 0 || batch <= 0) return batch < 0 ? cudaErrorInvalidValue : cudaSuccess;
    using R = RunsTile<Op>;
    if constexpr (R::kHas) {
      if (takes_runs<Op, T>(n, batch))
        return launch<R::kItems, true, R::kThreads>(in, out, n, batch, reverse, scratch, stream);
    }
    return launch<scan_items(Op::L), false, kScanThreads>(in, out, n, batch, reverse, scratch, stream);
  }
};

// Scratch bytes of LookbackScan for `batch` rows of n elements, written to
// *bytes.
template <class Op, typename T>
struct LookbackScratch {
  static cudaError_t run(int n, int batch, long long* bytes) {
    using R = RunsTile<Op>;
    *bytes = takes_runs<Op, T>(n, batch)
                 ? (long long)LookbackLayout<Op, T, R::kItems, R::kThreads>::scratch_bytes(n, batch)
                 : (long long)LookbackLayout<Op, T>::scratch_bytes(n, batch);
    return cudaSuccess;
  }
};

// Elements per tile of a launch of `batch` rows of n elements, written to
// *tile.
template <class Op, typename T>
struct LookbackTile {
  static cudaError_t run(int n, int batch, int* tile) {
    using R = RunsTile<Op>;
    *tile = takes_runs<Op, T>(n, batch) ? LookbackLayout<Op, T, R::kItems, R::kThreads>::kTile
                                       : LookbackLayout<Op, T>::kTile;
    return cudaSuccess;
  }
};

}  // namespace
