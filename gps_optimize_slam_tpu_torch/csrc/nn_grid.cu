// K4: per query, the minimum over valid candidates of the squared distance
// sum_k (a_k - b_k)^2, on a 1-D grid over the kept work only: one block per
// (query tile, run of at most kRun kept candidate tiles).
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// nn_min_dist2 (_nn_kernel, the pipelined 2-D grid), which the JAX package
// takes when the candidate image exceeds its 8 MiB VMEM budget
// (m_pad * 8 * 4 B, m_pad > 262,144: pallas_kernels.py:263). That kernel
// visits every (query tile, candidate tile) pair and skips the pairs its
// keep mask drops. Here the keep lists come from the keep-list kernel
// (nn_keep.cu) as K3 takes them, order[i, :nkept[i]] ascending, and the
// wrapper (ops/kernels.py:nn_grid) cuts each query tile's list into runs of
// kRun tiles: ends[i] is the inclusive prefix sum of ceil(nkept / kRun), so
// block b finds its query tile by a binary search over ends. No block
// exists for a dropped pair, and a query tile with many kept tiles is
// spread over several blocks.
//
// Each block (128 queries, one per thread) double-buffers its candidate
// tiles in shared memory with cp.async: K3's operand layout, (m_tiles, 4,
// 1024) rows x, y, z and a validity row (0 valid, +inf invalid or padded),
// so validity is folded into the staged tile. While tile k is scanned,
// tile k + 1 loads. Every thread scans the staged tile with the function K3
// scans it with (nn_tile.cuh: tile_min, 16-byte shared-memory loads, the
// validity row added as the distance's last term), and the block folds its
// per-query minimum into the output with an
// atomicMin on the bit pattern: non-negative IEEE values order like their
// bits as integers (int for float32, unsigned long long for float64). The
// wrapper fills the output with +inf first; a NaN distance never wins a
// minimum, so it never reaches the atomic. The minimum does not depend on
// the order of blocks or tiles, so K4 equals K3 bit for bit on the same
// inputs (--fmad=false: no contraction).
//
// Batch grid: a batch of B sequences (the JAX package's vmap of its
// pipelined kernel, which adds a row axis to its grid; each row its own
// queries, packed candidates, keep lists and output) in one launch over one
// work list: ends is the inclusive prefix sum of the runs over every row's
// query tiles, row after row, (B * n_tiles,), and block b finds its (row,
// query tile) by the one binary search, so no block is idle and B has no
// limit of its own. (Grid y as the row, each row its own list and the
// largest row's count of blocks a row, timed level with it on this card;
// it is not kept.) A block offsets every pointer by its row and then does
// the single-row block's work, so each row's minima equal those of a call
// on that row alone, and K3's batch grid, bit for bit.
//
// What bounds it on this card: operations, 8 flops a kept (query,
// candidate) pair for the 3-term function (the kernel spends 10 with the
// validity term), 128 x 1024 pairs a kept tile pair; the keep lists are
// nn_keep.cu's cost.
#include "nn_tile.cuh"

namespace {

constexpr int kGridTileN = kNnTileN;  // queries per block, one per thread
constexpr int kRun = 4;               // kept candidate tiles per block at most

__device__ __forceinline__ void atomic_min_nonneg(float* addr, float v) {
  atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
}

__device__ __forceinline__ void atomic_min_nonneg(double* addr, double v) {
  atomicMin(reinterpret_cast<unsigned long long*>(addr),
            static_cast<unsigned long long>(__double_as_longlong(v)));
}

template <typename T>
__global__ void __launch_bounds__(kGridTileN)
nn_grid_kernel(const T* __restrict__ traj, int n, const T* __restrict__ cand,
               const int* __restrict__ order, const int* __restrict__ nkept,
               const int* __restrict__ ends, int n_tiles, int m_tiles, int batch,
               T* __restrict__ out) {
  constexpr int kTileElems = 4 * kNnTileM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][4][kNnTileM]
  const int b = blockIdx.x;
  int lo = 0, hi = batch * n_tiles - 1;  // the first entry j with ends[j] > b
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] > b) hi = mid;
    else lo = mid + 1;
  }
  const int k0 = (b - (lo > 0 ? ends[lo - 1] : 0)) * kRun;
  const int row = lo / n_tiles, i = lo % n_tiles;  // the row, and the query tile within it
  traj += (size_t)row * 3 * n, out += (size_t)row * n;
  cand += (size_t)row * m_tiles * kTileElems;
  order += (size_t)row * n_tiles * m_tiles, nkept += (size_t)row * n_tiles;
  const int k1 = min(nkept[i], k0 + kRun);
  const int* tiles = order + (size_t)i * m_tiles;

  auto stage = [&](int k, int slot) {
    stage_tile<T, kGridTileN>(buf + slot * kTileElems, cand + (size_t)tiles[k] * kTileElems);
  };

  const int q = i * kGridTileN + threadIdx.x;
  T ax[1] = {0}, ay[1] = {0}, az[1] = {0};
  if (q < n) {
    ax[0] = traj[3 * (size_t)q];
    ay[0] = traj[3 * (size_t)q + 1];
    az[0] = traj[3 * (size_t)q + 2];
  }
  const T inf = Limits<T>::inf();
  T best[1] = {inf};
  stage(k0, 0);
  for (int k = k0; k < k1; ++k) {
    const int slot = (k - k0) & 1;
    if (k + 1 < k1) {
      stage(k + 1, slot ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_min<T, 1>(buf + slot * kTileElems, 0, 1, ax, ay, az, best);
    __syncthreads();  // the slot is restaged two tiles on
  }
  if (q < n && best[0] < inf) atomic_min_nonneg(out + q, best[0]);
}

template <typename T>
cudaError_t launch(int batch, const void* traj, int n, const void* cand, const int* order, const int* nkept,
                   const int* ends, int n_tiles, int m_tiles, int n_items, void* out, cudaStream_t s) {
  if ((long long)n_tiles * kGridTileN < n || n_tiles < 1 || n_items < 0 || batch < 1 ||
      (long long)batch * n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (n_items == 0) return cudaSuccess;
  const size_t smem = 2 * 4 * kNnTileM * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(nn_grid_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  nn_grid_kernel<T><<<n_items, kGridTileN, smem, s>>>(
      static_cast<const T*>(traj), n, static_cast<const T*>(cand), order, nkept, ends, n_tiles,
      m_tiles, batch, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Kept candidate tiles per block; the wrapper cuts the keep lists by it.
GPS_EXPORT int gps_nn_grid_run() { return kRun; }

// Per row of a batch of `batch` rows, rows contiguous one after another:
// traj (n, 3); cand (m_tiles, 4, 1024) as K3 takes it; order (n_tiles,
// m_tiles) kept tiles first, ascending; nkept (n_tiles,); out (n,) filled
// with +inf by the caller. ends (batch * n_tiles,): the inclusive prefix
// sum of ceil(nkept / kRun) over all rows' query tiles, n_items its last
// value. Returns a cudaError_t.
GPS_EXPORT int gps_nn_grid(int dtype, int batch, const void* traj, int n, const void* cand, const int* order,
                           const int* nkept, const int* ends, int n_tiles, int m_tiles, int n_items,
                           void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(batch, traj, n, cand, order, nkept, ends, n_tiles, m_tiles, n_items, out, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(batch, traj, n, cand, order, nkept, ends, n_tiles, m_tiles, n_items, out, s);
  return (int)cudaErrorInvalidValue;
}
