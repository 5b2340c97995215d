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
// What bounds it on this card: the instructions a (query, candidate) pair
// costs, not bytes. nn_tile.cuh's tile_min spends 7 arithmetic ones on a
// pair (3 differences, 1 multiply, 2 fused multiply-adds, a minimum, which
// in float64 is a compare on the FP64 pipe and two selects), where the
// first designs spent 10 (a validity row added as a fourth term, nothing
// contracted). The candidate tiles of long or batched launches are staged
// once for many queries, so the bytes (each packed tile read from L2 once
// a block) stay far below the instructions' time.
//
// Design:
//   - Fill the card. A block owns kSub queries of one 128-query tile, and
//     the 128 / kSub blocks of a tile share its keep list (order[i],
//     nkept[i]). The wrapper picks kSub from the launch's query tiles
//     (ops/kernels.py:resident_block, where the times that set the tiers
//     are): 16 queries a block (two a thread) at the main path's sizes
//     (4,661 queries: 292 blocks on 132 SMs), 32 (four a thread) where the
//     grid is large anyway, and 64 (eight a thread) at grids of thousands
//     of query tiles (long rows, batches), where each staged tile and each
//     16-byte shared-memory load then feed twice the pairs of a 32-query
//     block.
//   - Split the tile, not the list. The 256 threads of a block are kSub / Q
//     query lanes x slices: a thread holds Q queries in registers and scans
//     every slices-th 16-byte vector of each staged candidate tile. The
//     slices' minima meet in shared memory once, at the end, in the staging
//     buffers (free by then). One block owns a query, so there are no
//     atomics and the output needs no pre-fill.
//   - One load, several pairs: tile_min reads a vector of 4 (float32) or 2
//     (float64) candidates a row, a broadcast within the warp.
//   - Stage ahead: two shared-memory buffers (12 KB a tile in float32, 24 KB
//     in float64) filled by cp.async, tile k + 1 in flight while tile k is
//     scanned.
// Padding queries (past n) are computed on zeros and never written; a block
// whose queries are all padding returns at once.
//
// Batch grid: a batch of B sequences (the JAX package's vmap of the kernel:
// each row its own queries, packed candidates and keep lists) is the
// grid's y dimension. A block offsets every pointer by its row and then
// walks only its own row's lists, so each row's minima equal those of a
// call on that row alone, bit for bit: a query's minimum is the same
// doubles whatever the block size, so every tier gives the same bits.
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
  static_assert(kLanes >= 1 && kLanes * Q == kSub && kLanes * kSlices == kNnThreads &&
                    kSubs * kSub == kNnTileN, "kSub and Q must cut the block evenly");
  static_assert(kSlices * kSub <= 2 * kNnTileElems, "the fold must fit in the staging buffers");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][3][kNnTileM]; at the end the fold, [kSlices][kSub]

  const size_t row = blockIdx.y;
  traj += row * 3 * n, out += row * n;
  cand += row * (size_t)m_tiles * kNnTileElems;
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
  if (kn > 0) stage_tile<T, kNnThreads>(buf, cand + (size_t)tiles[0] * kNnTileElems);
  for (int k = 0; k < kn; ++k) {
    const int slot = k & 1;
    if (k + 1 < kn) {
      stage_tile<T, kNnThreads>(buf + (slot ^ 1) * kNnTileElems, cand + (size_t)tiles[k + 1] * kNnTileElems);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_min<T, Q>(buf + slot * kNnTileElems, slice, kSlices, ax, ay, az, best);
    __syncthreads();  // the slot is restaged two tiles on, or holds the fold
  }

  T* fold = buf;
#pragma unroll
  for (int j = 0; j < Q; ++j) fold[slice * kSub + lane + j * kLanes] = best[j];
  __syncthreads();
  const int mine = threadIdx.x;  // one thread a query folds its slices
  if (mine < kSub && q0 + mine < n) {
    T b = fold[mine];
    for (int s = 1; s < kSlices; ++s) b = min_keep(b, fold[s * kSub + mine]);
    out[q0 + mine] = b;
  }
}

template <typename T, int kSub, int Q>
cudaError_t launch_as(int batch, const T* traj, int n, const T* cand, const int* order,
                      const int* nkept, int n_tiles, int m_tiles, T* out, cudaStream_t s) {
  constexpr size_t smem = 2 * kNnTileElems * sizeof(T);
  static_assert(smem <= 48 * 1024, "the staging buffers fit the default dynamic shared memory");
  const dim3 grid((unsigned)(n_tiles * (kNnTileN / kSub)), (unsigned)batch);
  nn_kernel<T, kSub, Q><<<grid, kNnThreads, smem, s>>>(traj, n, cand, order, nkept, n_tiles,
                                                       m_tiles, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int batch, const void* traj, int n, const void* cand, const int* order,
                   const int* nkept, int n_tiles, int m_tiles, int queries_per_block, void* out,
                   cudaStream_t s) {
  if ((long long)n_tiles * kNnTileN < n || n_tiles < 1 || batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  decltype(&launch_as<T, 16, 2>) run = nullptr;
  switch (queries_per_block) {
    case 16: run = launch_as<T, 16, 2>; break;
    case 32: run = launch_as<T, 32, 4>; break;
    case 64: run = launch_as<T, 64, 8>; break;
    default: return cudaErrorInvalidValue;
  }
  return run(batch, static_cast<const T*>(traj), n, static_cast<const T*>(cand), order, nkept,
             n_tiles, m_tiles, static_cast<T*>(out), s);
}

}  // namespace

// Per row of a batch of `batch` rows, rows contiguous one after another:
// traj (n, 3); cand (m_tiles, 3, 1024); order (n_tiles, m_tiles) kept tiles
// first; nkept (n_tiles,); out (n,). queries_per_block: 16, 32 or 64 (the
// wrapper's rule, ops/kernels.py:resident_block). Returns a cudaError_t.
GPS_EXPORT int gps_nn_min_dist2(int dtype, int batch, const void* traj, int n, const void* cand,
                                const int* order, const int* nkept, int n_tiles, int m_tiles,
                                int queries_per_block, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(batch, traj, n, cand, order, nkept, n_tiles, m_tiles, queries_per_block, out, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(batch, traj, n, cand, order, nkept, n_tiles, m_tiles, queries_per_block, out, s);
  return (int)cudaErrorInvalidValue;
}
