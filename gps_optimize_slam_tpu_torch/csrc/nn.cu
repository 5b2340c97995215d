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
// pallas_kernels.py:11-20).
//
// Design: one block per tile of 128 queries, one query per thread. For each
// kept candidate tile (1024 candidates, rows x, y, z and a validity row that
// holds 0 for a valid and +inf for an invalid or padded candidate), the block
// stages the tile in shared memory (16 KB in float32, 32 KB in float64) and
// every thread runs the unrolled 4-term difference form against all 1024
// candidates. NaN distances never win the minimum.
//
// What bounds it on this card: at the main path's sizes (4661 x 4661 with a
// few percent of tiles kept) the work is ~1e7 subtract-multiply-adds and the
// launch latency; with 37 blocks for 4661 queries the card is far from full.
// Smaller query tiles or splitting the candidate walk across blocks would
// fill it; that is later work.
#include "common.cuh"

namespace {

constexpr int kNnTileN = 128;   // queries per block, one per thread
constexpr int kNnTileM = 1024;  // candidates per tile

template <typename T>
__global__ void __launch_bounds__(kNnTileN)
nn_kernel(const T* __restrict__ traj, int n, const T* __restrict__ cand,
          const int* __restrict__ order, const int* __restrict__ nkept, int m_tiles,
          T* __restrict__ out) {
  __shared__ T sb[4][kNnTileM];
  const int i = blockIdx.x;
  const int q = i * kNnTileN + threadIdx.x;
  T ax = 0, ay = 0, az = 0;
  if (q < n) {
    ax = traj[3 * (size_t)q];
    ay = traj[3 * (size_t)q + 1];
    az = traj[3 * (size_t)q + 2];
  }
  T best = Limits<T>::inf();
  const int kn = nkept[i];
  for (int k = 0; k < kn; ++k) {
    const T* blk = cand + (size_t)order[(size_t)i * m_tiles + k] * 4 * kNnTileM;
    __syncthreads();
    for (int c = threadIdx.x; c < 4 * kNnTileM; c += kNnTileN) sb[c / kNnTileM][c % kNnTileM] = blk[c];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kNnTileM; ++c) {
      const T d0 = ax - sb[0][c];
      const T d1 = ay - sb[1][c];
      const T d2 = az - sb[2][c];
      const T d3 = T(0) - sb[3][c];
      const T d = d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      best = d < best ? d : best;
    }
  }
  if (q < n) out[q] = best;
}

template <typename T>
cudaError_t launch(const void* traj, int n, const void* cand, const int* order,
                   const int* nkept, int n_tiles, int m_tiles, void* out, cudaStream_t s) {
  nn_kernel<T><<<n_tiles, kNnTileN, 0, s>>>(static_cast<const T*>(traj), n,
                                            static_cast<const T*>(cand), order, nkept,
                                            m_tiles, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// traj (n, 3); cand (m_tiles, 4, 1024); order (n_tiles, m_tiles) kept tiles
// first; nkept (n_tiles,); out (n,). Returns a cudaError_t.
GPS_EXPORT int gps_nn_min_dist2(int dtype, const void* traj, int n, const void* cand,
                                const int* order, const int* nkept, int n_tiles, int m_tiles,
                                void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32) return (int)launch<float>(traj, n, cand, order, nkept, n_tiles, m_tiles, out, s);
  if (dtype == GPS_F64) return (int)launch<double>(traj, n, cand, order, nkept, n_tiles, m_tiles, out, s);
  return (int)cudaErrorInvalidValue;
}
