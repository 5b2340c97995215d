// K4: per query, the minimum over valid candidates of the squared distance
// sum_k (a_k - b_k)^2, over a work list of the kept work only: one item per
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
// item b finds its query tile by a binary search over ends. No item exists
// for a dropped pair, and a query tile with many kept tiles is spread over
// several items.
//
// The list's length, ends[last], is read on the device: each block draws
// items from a ticket counter (zeroed before the launch) until a ticket
// passes it, so the blocks share the items as they finish them whatever
// each item's tile count. The grid is sized without the length, as many
// blocks as the card holds at once (the SM count times the blocks an SM
// fits, at most the items a list could have), so the host reads nothing
// from the keep lists and a CUDA graph can hold the launch. Tickets, not
// blocks striding the list by the grid's size: the items' tile counts
// differ, and a stride leaves the blocks unevenly loaded. Against one block
// an item with the length read on the host, the tickets time 0.98-1.10x
// (tools/k4_launch_compare.py, H100 80GB HBM3 at 700 W).
//
// Each item (128 queries, one per thread) double-buffers its candidate
// tiles in shared memory with cp.async: K3's operand layout, (m_tiles, 3,
// 1024) rows x, y, z with +inf coordinates for a masked or padded
// candidate, so validity is folded into the staged tile. While tile k is
// scanned, tile k + 1 loads. Every thread scans the staged tile with the
// function K3 scans it with (nn_tile.cuh: tile_min, 16-byte shared-memory
// loads, the distance contracted by hand into two fused multiply-adds),
// and the block folds its per-query minimum into the output with an
// atomicMin on the bit pattern: non-negative IEEE values order like their
// bits as integers (int for float32, unsigned long long for float64). The
// wrapper fills the output with +inf first; a NaN distance never wins a
// minimum, so it never reaches the atomic. The minimum does not depend on
// the order of blocks or tiles, so K4 equals K3 bit for bit on the same
// inputs.
//
// Batch grid: a batch of B sequences (the JAX package's vmap of its
// pipelined kernel, which adds a row axis to its grid; each row its own
// queries, packed candidates, keep lists and output) in one launch over one
// work list: ends is the inclusive prefix sum of the runs over every row's
// query tiles, row after row, (B * n_tiles,), and item b finds its (row,
// query tile) by the one binary search, so no block is idle and B has no
// limit of its own. (Grid y as the row, each row its own list and the
// largest row's count of blocks a row, timed level with it on this card;
// it is not kept.) A block offsets every pointer by its row and then does
// the single-row block's work, so each row's minima equal those of a call
// on that row alone, and K3's batch grid, bit for bit.
//
// What bounds it on this card: operations, 8 flops a kept (query,
// candidate) pair (the kernel issues 7 instructions for them, nn_tile.cuh),
// 128 x 1024 pairs a kept tile pair; the keep lists are nn_keep.cu's cost.
#include <atomic>

#include "nn_tile.cuh"

namespace {

constexpr int kGridTileN = kNnTileN;  // queries per block, one per thread
constexpr int kRun = 4;               // kept candidate tiles per item at most

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
               int* __restrict__ ticket, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_item;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][3][kNnTileM]
  const int entries = batch * n_tiles;
  const int n_items = ends[entries - 1];  // the work list's length, the same for every thread
  const T inf = Limits<T>::inf();
  // The next item: a ticket drawn from the counter. Every item holds at
  // least one tile, so the tile loop's barriers keep thread 0 from drawing
  // again before all threads have read s_item.
  auto draw = [&]() {
    if (threadIdx.x == 0) s_item = atomicAdd(ticket, 1);
    __syncthreads();
    return s_item;
  };
  for (int b = draw(); b < n_items; b = draw()) {
    int lo = 0, hi = entries - 1;  // the first entry j with ends[j] > b
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ends[mid] > b) hi = mid;
      else lo = mid + 1;
    }
    const int k0 = (b - (lo > 0 ? ends[lo - 1] : 0)) * kRun;
    const int row = lo / n_tiles, i = lo % n_tiles;  // the row, and the query tile within it
    const T* row_traj = traj + (size_t)row * 3 * n;
    const T* row_cand = cand + (size_t)row * m_tiles * kNnTileElems;
    const int k1 = min(nkept[(size_t)row * n_tiles + i], k0 + kRun);
    const int* tiles = order + ((size_t)row * n_tiles + i) * m_tiles;

    auto stage = [&](int k, int slot) {
      stage_tile<T, kGridTileN>(buf + slot * kNnTileElems, row_cand + (size_t)tiles[k] * kNnTileElems);
    };

    const int q = i * kGridTileN + threadIdx.x;
    T ax[1] = {0}, ay[1] = {0}, az[1] = {0};
    if (q < n) {
      ax[0] = row_traj[3 * (size_t)q];
      ay[0] = row_traj[3 * (size_t)q + 1];
      az[0] = row_traj[3 * (size_t)q + 2];
    }
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
      tile_min<T, 1>(buf + slot * kNnTileElems, 0, 1, ax, ay, az, best);
      __syncthreads();  // the slot is restaged two tiles on, or by the next item
    }
    if (q < n && best[0] < inf) atomic_min_nonneg(out + (size_t)row * n + q, best[0]);
  }
}

constexpr int kMaxDevices = 64;

// Blocks of K4 a card runs at once, by device ordinal (the launch goes to
// the current device, which the wrapper makes the tensors' own), found once
// a device and dtype: the first call of a key runs outside any capture.
// The mesh launches from one host thread a device, so the cache is atomic;
// threads that find it empty at once compute and store the same count.
template <typename T>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static std::atomic<int> blocks_of[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int count = blocks_of[device].load(std::memory_order_relaxed);
  if (count == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_grid_kernel<T>, kGridTileN, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    count = sms * per_sm;
    blocks_of[device].store(count, std::memory_order_relaxed);
  }
  *blocks = count;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(int batch, const void* traj, int n, const void* cand, const int* order, const int* nkept,
                   const int* ends, int n_tiles, int m_tiles, int max_items, int* ticket, void* out,
                   cudaStream_t s) {
  if ((long long)n_tiles * kGridTileN < n || n_tiles < 1 || max_items < 0 || batch < 1 ||
      ticket == nullptr || (long long)batch * n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (max_items == 0) return cudaSuccess;
  // Two staged tiles (48 KB in float64) and the static ticket slot pass
  // the 48 KB a block may hold without opting in.
  const size_t smem = 2 * kNnTileElems * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(nn_grid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (e == cudaSuccess) e = resident_blocks<T>(smem, &blocks);
  if (e == cudaSuccess) e = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (e != cudaSuccess) return e;
  nn_grid_kernel<T><<<min(max_items, blocks), kGridTileN, smem, s>>>(
      static_cast<const T*>(traj), n, static_cast<const T*>(cand), order, nkept, ends, n_tiles,
      m_tiles, batch, ticket, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Kept candidate tiles per item; the wrapper cuts the keep lists by it.
GPS_EXPORT int gps_nn_grid_run() { return kRun; }

// Per row of a batch of `batch` rows, rows contiguous one after another:
// traj (n, 3); cand (m_tiles, 3, 1024) as K3 takes it; order (n_tiles,
// m_tiles) kept tiles first, ascending; nkept (n_tiles,); out (n,) filled
// with +inf by the caller. ends (batch * n_tiles,): the inclusive prefix
// sum of ceil(nkept / kRun) over all rows' query tiles, whose last value
// the kernel reads; max_items is at least that value (the wrapper passes
// the most the lists could hold), and the grid is the card's resident
// blocks, at most max_items. ticket: one int of scratch, the items'
// counter. Returns a cudaError_t.
GPS_EXPORT int gps_nn_grid(int dtype, int batch, const void* traj, int n, const void* cand, const int* order,
                           const int* nkept, const int* ends, int n_tiles, int m_tiles, int max_items, int* ticket,
                           void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(batch, traj, n, cand, order, nkept, ends, n_tiles, m_tiles, max_items, ticket, out, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(batch, traj, n, cand, order, nkept, ends, n_tiles, m_tiles, max_items, ticket, out, s);
  return (int)cudaErrorInvalidValue;
}
