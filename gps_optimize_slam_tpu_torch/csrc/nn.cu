// K3: per query, the minimum over valid candidates of the squared distance
// sum_k (a_k - b_k)^2, walking only the candidate tiles that the spatial
// pruning kept for the query's tile.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// nn_min_dist2 (_nn_kernel_resident). Its keep lists (the per-32-point AABB
// bounds of _tile_keep_mask and their stable compaction) come from the
// keep-list kernel (nn_keep.cu), which K4 (nn_grid.cu) shares; the torch
// wrapper is ops/kernels.py:nn_resident. Distances stay in difference form:
// the |a|^2 - 2ab + |b|^2 expansion cancels catastrophically at UTM/ENU
// magnitudes (0.18 m against 7e-8 m error in float32,
// pallas_kernels.py:11-20), so there is no tensor-core form.
//
// What bounds it on this card: operations. A (query, candidate) pair costs
// 10 uncontracted float operations (3 differences, 3 squares, 3 sums, a
// minimum), and at the main path's size, 4,661 x 4,661, pruning at
// 1024-candidate tiles removes little: on chip_smoke.py's random walks the
// keep lists hold 159 of the 37 x 5 = 185 tile pairs (it prints the count as
// kept_tile_pairs). So the work is ~2e7 pairs: 7 microseconds of the whole
// card's float32 rate, or a tenth of a millisecond when 37 blocks of four
// warps each walk their lists alone, one dependent chain and four scalar
// shared-memory loads a candidate (this kernel's first design: 0.097 ms on
// an H100 at 700 W, where this one takes 0.015 ms).
//
// Design:
//   - Fill the card. A block owns kSub queries of one 128-query tile, not the
//     whole tile: the 128 / kSub blocks of a tile share its keep list
//     (order[i], nkept[i]). The launcher takes 16 queries a block at the
//     main path's sizes (4,661 queries: 292 blocks on 132 SMs, where the
//     first design had 37) and 32 where the grid is large anyway.
//   - Split the tile, not the list. The 256 threads of a block are kSub / Q
//     query lanes x slices: a thread holds Q queries in registers and scans
//     every slices-th 16-byte vector of each staged candidate tile. The
//     slices' minima meet in shared memory once, at the end. One block owns
//     a query, so there are no atomics and the output needs no pre-fill.
//   - One load, several pairs: nn_tile.cuh's tile_min reads a vector of 4
//     (float32) or 2 (float64) candidates a row, a broadcast within the warp.
//   - Stage ahead: two shared-memory buffers (16 KB a tile in float32, 32 KB
//     in float64) filled by cp.async, tile k + 1 in flight while tile k is
//     scanned.
// Padding queries (past n) are computed on zeros and never written; a block
// whose queries are all padding returns at once.
//
// Batch grid: a batch of B sequences (the JAX package's vmap of the kernel:
// each row its own queries, packed candidates and keep lists) is the
// grid's y dimension. A block offsets every pointer by its row and then
// walks only its own row's lists, so each row's minima equal those of a
// call on that row alone, bit for bit. The 16-or-32-query rule below is
// decided from the B * n_tiles query tiles the launch really has; at
// B = 64 rows of 4,661 poses that is 2,368 tiles, so a batch takes the
// 32-query blocks that the single-row rule kept for large grids.
#include "nn_tile.cuh"

namespace {

constexpr int kNnThreads = 256;

template <typename T, int kSub, int Q>
__global__ void __launch_bounds__(kNnThreads)
nn_kernel(const T* __restrict__ traj, int n, const T* __restrict__ cand,
          const int* __restrict__ order, const int* __restrict__ nkept, int n_tiles,
          int m_tiles, T* __restrict__ out) {
  constexpr int kLanes = kSub / Q;              // threads across the block's queries
  constexpr int kSlices = kNnThreads / kLanes;  // threads across a tile's vectors
  constexpr int kSubs = kNnTileN / kSub;        // blocks a query tile
  constexpr int kTileElems = 4 * kNnTileM;
  static_assert(kLanes >= 1 && kLanes * Q == kSub && kLanes * kSlices == kNnThreads &&
                    kSubs * kSub == kNnTileN, "kSub and Q must cut the block evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][4][kNnTileM]
  __shared__ T fold[kSlices][kSub];

  const size_t row = blockIdx.y;
  traj += row * 3 * n, out += row * n;
  cand += row * (size_t)m_tiles * kTileElems;
  order += row * (size_t)n_tiles * m_tiles, nkept += row * n_tiles;
  const int i = blockIdx.x / kSubs;
  const int q0 = i * kNnTileN + (blockIdx.x % kSubs) * kSub;
  if (q0 >= n) return;
  const int lane = threadIdx.x % kLanes, slice = threadIdx.x / kLanes;
  T ax[Q], ay[Q], az[Q], best[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int q = q0 + lane + j * kLanes;
    ax[j] = ay[j] = az[j] = 0;
    if (q < n) {
      ax[j] = traj[3 * (size_t)q];
      ay[j] = traj[3 * (size_t)q + 1];
      az[j] = traj[3 * (size_t)q + 2];
    }
    best[j] = Limits<T>::inf();
  }

  const int kn = nkept[i];
  const int* tiles = order + (size_t)i * m_tiles;
  if (kn > 0) stage_tile<T, kNnThreads>(buf, cand + (size_t)tiles[0] * kTileElems);
  for (int k = 0; k < kn; ++k) {
    const int slot = k & 1;
    if (k + 1 < kn) {
      stage_tile<T, kNnThreads>(buf + (slot ^ 1) * kTileElems, cand + (size_t)tiles[k + 1] * kTileElems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_min<T, Q>(buf + slot * kTileElems, slice, kSlices, ax, ay, az, best);
    __syncthreads();  // the slot is restaged two tiles on
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) fold[slice][lane + j * kLanes] = best[j];
  __syncthreads();
  const int mine = threadIdx.x;  // one thread a query folds its slices
  if (mine < kSub && q0 + mine < n) {
    T b = fold[0][mine];
    for (int s = 1; s < kSlices; ++s) b = min_keep(b, fold[s][mine]);
    out[q0 + mine] = b;
  }
}

template <typename T, int kSub, int Q>
cudaError_t launch_as(int batch, const T* traj, int n, const T* cand, const int* order,
                      const int* nkept, int n_tiles, int m_tiles, T* out, cudaStream_t s) {
  const size_t smem = 2 * 4 * kNnTileM * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nn_kernel<T, kSub, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)(n_tiles * (kNnTileN / kSub)), (unsigned)batch);
  nn_kernel<T, kSub, Q><<<grid, kNnThreads, smem, s>>>(traj, n, cand, order, nkept, n_tiles,
                                                       m_tiles, out);
  return cudaGetLastError();
}

// Blocks of 16 queries (two a thread) while that keeps the grid at 2048
// blocks or fewer, about 15 an SM; blocks of 32 queries (four a thread)
// beyond, where the card is full either way and more pairs a shared-memory
// load win: the crossover measured on this card lies between 256 and 512
// query tiles in float32 and float64 (PERF.md).
constexpr int kSmallGridTiles = 256;

template <typename T>
cudaError_t launch(int batch, const void* traj, int n, const void* cand, const int* order,
                   const int* nkept, int n_tiles, int m_tiles, void* out, cudaStream_t s) {
  if ((long long)n_tiles * kNnTileN < n || n_tiles < 1 || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const long long tiles = (long long)batch * n_tiles;  // the launch's query tiles
  const auto run = tiles <= kSmallGridTiles ? launch_as<T, 16, 2> : launch_as<T, 32, 4>;
  return run(batch, static_cast<const T*>(traj), n, static_cast<const T*>(cand), order, nkept,
             n_tiles, m_tiles, static_cast<T*>(out), s);
}

}  // namespace

// Per row of a batch of `batch` rows, rows contiguous one after another:
// traj (n, 3); cand (m_tiles, 4, 1024); order (n_tiles, m_tiles) kept tiles
// first; nkept (n_tiles,); out (n,). Returns a cudaError_t.
GPS_EXPORT int gps_nn_min_dist2(int dtype, int batch, const void* traj, int n, const void* cand,
                                const int* order, const int* nkept, int n_tiles, int m_tiles,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(batch, traj, n, cand, order, nkept, n_tiles, m_tiles, out, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(batch, traj, n, cand, order, nkept, n_tiles, m_tiles, out, s);
  return (int)cudaErrorInvalidValue;
}
