// K1's batch grid for short rows: a thread-block cluster a row, its carry
// read from the other blocks' shared memory (distributed shared memory), no
// look-back.
//
// Where a row of (L, B, n) leaves fits in at most kClusterMax tiles, the
// launch is B clusters of C = tiles(n) blocks (grid B * C, cluster
// dimension C, cudaLaunchKernelEx); block rank r of cluster b scans
// scan-order tile r of row b:
//   1. it stages its tile and reduces it (steps 2 and 3 of
//      scan_lookback.cuh, the ladder tile or the runs tile), which leaves
//      the tile aggregate in its own shared memory (the last warp prefix);
//   2. the cluster barrier (barrier.cluster arrive.release / wait.acquire)
//      makes every rank's aggregate visible to the cluster;
//   3. warp 0 of rank r > 0 reads the aggregates of ranks 0..r-1 through
//      distributed shared memory (cluster.map_shared_rank), lane k the
//      aggregate of rank r - 1 - k, and folds them in the look-back's
//      shuffle-down tree (the farther, earlier half first): the carry is
//      the composite of ranks 0..r-1, the earlier composite always the
//      FIRST argument, the JAX order; under `reverse` scan order is already
//      reversed, so the same code serves both directions;
//   4. it arrives on the cluster barrier (it reads no other block's shared
//      memory after this), finishes and stores its tile (step 5 and the
//      store of scan_lookback.cuh), and waits on the barrier before it
//      exits, so no block's shared memory goes while another may read it.
//
// Against the look-back path (lookback_scan_kernel) a launch is one kernel
// node: no ticket, no flags, no scratch and so no memset, and no
// acquire/release round trips through L2. The fold order is fixed by the
// ranks, so a row's result does not depend on timing: two launches on the
// same leaves give the same bits, and a row in a batch gives the bits of
// the same row in any other batch of the same n.
//
// The tile (the runs tile of scan_lookback.cuh, 128 threads, 4 or 8 items
// a thread) is chosen per combine from the times measured on an H100
// (ClusterTile below): the first entry of the combine's list that covers n
// in at most kClusterMax tiles. A row longer than the last entry covers
// takes the look-back path. Single rows (B = 1) and the 27-leaf filter
// always take the look-back path.
#pragma once

#include <cooperative_groups.h>

#include "scan_lookback.cuh"

namespace {

// The most blocks a cluster of this path has. Past the portable 8 the
// kernel needs cudaFuncAttributeNonPortableClusterSizeAllowed: clusters of
// 10 blocks (4 items a thread) were 3-16 % faster than of 5 (8 items) for
// quat_chain, mobius and rts at the fleet and the KITTI batch on an H100,
// and 16 blocks faster than 8 at 16 rows of 8,192 (PERF.md).
constexpr int kClusterMax = 16;
constexpr int kClusterPortable = 8;

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

template <class Op, typename T, int ITEMS, bool RUNS, int THREADS>
__global__ void __launch_bounds__(THREADS)
cluster_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int batch, int reverse) {
  namespace cg = cooperative_groups;
  constexpr int L = Op::L;
  constexpr int WARPS = THREADS / 32;
  static_assert(RUNS || THREADS == kScanThreads, "the ladder tile's steps are kScanThreads wide");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [L][padded(TILE)]
  __shared__ T s_warp[WARPS][L];         // warp totals, then inclusive warp prefixes
  __shared__ T s_carry[L];               // the tile's exclusive composite
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = (int)(blockIdx.x / cluster.num_blocks());
  const size_t ld = (size_t)batch * n;
  in += (size_t)row * n, out += (size_t)row * n;
  const int k0 = rank * THREADS * ITEMS;

  tile_load<Op, T, ITEMS, THREADS>(in, n, ld, reverse, k0, s);
  __syncthreads();
  if constexpr (RUNS) tile_reduce_runs<Op, T, ITEMS, THREADS>(s, s_warp);
  else tile_reduce<Op, T, ITEMS>(s, s_warp);
  cluster_arrive();
  cluster_wait();  // every rank's aggregate, s_warp[WARPS - 1], is visible
  if (rank > 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    T v[L], x[L], y[L];
    if (lane < rank) {
      const T* agg = cluster.map_shared_rank(&s_warp[WARPS - 1][0], (unsigned)(rank - 1 - lane));
#pragma unroll
      for (int l = 0; l < L; ++l) v[l] = agg[l];
    } else {
      Op::identity(v);
    }
    // Lane 0 gathers lanes [0, rank - 1]; the farther (earlier) half goes first.
    for (int d = 1; d < rank; d <<= 1) {
      shfl_down_leaves<L>(v, d, x);
      if (lane + d < 32) {
        Op::apply(x, v, y);
        copy_leaves<L>(y, v);
      }
    }
    if (lane == 0) copy_leaves<L>(v, s_carry);
  }
  cluster_arrive();  // no other block's shared memory is read after this
  __syncthreads();
  if constexpr (RUNS) tile_finish_runs<Op, T, ITEMS, THREADS>(rank, s, s_warp, s_carry);
  else tile_finish<Op, T, ITEMS>(rank, s, s_warp, s_carry);
  tile_store<Op, T, ITEMS, THREADS>(s, out, n, ld, reverse, k0);
  cluster_wait();  // every block has read what it needs of this one's
}

// One launch of cluster_scan_kernel over `batch` rows of n elements, a
// cluster of tiles(n) blocks a row. cudaErrorInvalidConfiguration where the
// cluster is larger than kClusterMax or the card cannot hold one; the
// caller raises on it and runs nothing in its place.
template <class Op, typename T, int ITEMS, bool RUNS, int THREADS>
cudaError_t cluster_launch(const void* in, void* out, int n, int batch, int reverse, cudaStream_t stream) {
  using Layout = LookbackLayout<Op, T, ITEMS, THREADS>;
  const int C = Layout::tiles(n);
  const long long blocks = (long long)batch * C;
  if (C < 1 || C > kClusterMax || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kernel = cluster_scan_kernel<Op, T, ITEMS, RUNS, THREADS>;
  const size_t smem = Layout::smem_bytes();
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess && C > kClusterPortable)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Whether a cluster of C fits on the card, asked once for each C.
  static int fits[kClusterMax + 1] = {};
  if (fits[C] == 0) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    fits[C] = clusters > 0 ? 1 : -1;
  }
  if (fits[C] < 0) return cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(in), static_cast<T*>(out), n, batch, reverse);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The cluster path's tile of a combine: the runs tile of kClusterThreads
// threads at the items a thread it may take, smallest first (0 ends the
// list; the filter has none). From tools/scan_tile_sweep.py on an H100
// (PERF.md), at the fleet (64 x 4,661), the KITTI batch (11 rows of up to
// 4,661) and 16 and 64 rows of 8,192 and 16,384: the runs tile at 128
// threads beat the ladder tile at 256 threads for every combine and type
// at the fleet, and came within 6 % of it on the KITTI batch; quat_chain,
// mobius and rts were fastest at 4 items a thread (10 blocks a row of
// 4,661), the cheap combines at 8 (5 blocks); rts at 8 items lost to the
// look-back path's runs tile at 16 rows of 16,384 (36.3 against 28.3 us),
// so its rows past 16 tiles of 4 items take the look-back path.
constexpr int kClusterThreads = 128;

template <int I0, int I1>
struct ClusterItems {
  static constexpr int kItems[2] = {I0, I1};
};
template <class Op>
struct ClusterTile : ClusterItems<0, 0> {};
template <typename T>
struct ClusterTile<QuatChain<T>> : ClusterItems<4, 8> {};
template <typename T>
struct ClusterTile<Mobius<T>> : ClusterItems<4, 8> {};
template <typename T>
struct ClusterTile<RtsSuffix<T>> : ClusterItems<4, 0> {};
template <typename T>
struct ClusterTile<Affine3<T>> : ClusterItems<8, 0> {};
template <typename T>
struct ClusterTile<Add2<T>> : ClusterItems<8, 0> {};
template <typename T>
struct ClusterTile<Max3<T>> : ClusterItems<8, 0> {};
template <typename T>
struct ClusterTile<Min3<T>> : ClusterItems<8, 0> {};

// Index into ClusterTile<Op>::kItems of the tile a launch of `batch` rows
// of n elements takes on the cluster path, or -1 for the look-back path.
template <class Op>
__host__ constexpr int cluster_choice(int n, int batch) {
  if (batch < 2 || n < 1) return -1;
  for (int i = 0; i < 2 && ClusterTile<Op>::kItems[i] > 0; ++i)
    if ((long long)n <= (long long)kClusterMax * kClusterThreads * ClusterTile<Op>::kItems[i]) return i;
  return -1;
}

// The elements a tile and the blocks a cluster of that launch, 0 on the
// look-back path.
template <class Op>
__host__ constexpr int cluster_tile(int n, int batch) {
  const int i = cluster_choice<Op>(n, batch);
  return i < 0 ? 0 : kClusterThreads * ClusterTile<Op>::kItems[i];
}

template <class Op>
__host__ constexpr int cluster_size(int n, int batch) {
  const int tile = cluster_tile<Op>(n, batch);
  return tile ? (n + tile - 1) / tile : 0;
}

// The launch of the cluster path's tile number i.
template <class Op, typename T, int I>
cudaError_t cluster_run_at(const void* in, void* out, int n, int batch, int reverse, cudaStream_t stream) {
  constexpr int kItems = ClusterTile<Op>::kItems[I];
  if constexpr (kItems > 0)
    return cluster_launch<Op, T, kItems, true, kClusterThreads>(in, out, n, batch, reverse, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
