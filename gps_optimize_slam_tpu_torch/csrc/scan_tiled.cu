// K2: the inclusive associative scan (suffix scan when `reverse`) of K1 for
// leaves beyond the single-block budget, as a multi-block scan with a carried
// composite.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_tiled (_tiled_scan_kernel). That kernel walks a
// sequential grid of (Rb, 128) tiles and carries the running composite from
// one grid step to the next in VMEM scratch. Blocks on this card run in no
// order, so the carry needs a second pass: reduce-then-scan in three
// launches over tiles of kTile = 256 threads x 8 elements:
//   1. tile_totals_kernel: each block reduces its contiguous tile (in scan
//      order) to one composite, in the JAX combine's argument order;
//   2. K1's look-back scan (LookbackScan, scan_lookback.cuh) scans the
//      (L, n_blocks) block totals; block b reads its exclusive carry at
//      b - 1;
//   3. tile_scan_kernel: each block reduces its threads' sub-ranges again,
//      scans them in shared memory as K1 does, and every thread then walks
//      its elements from the carry: combine(block carry, thread prefix)
//      first, then one combine per element. The carry is always the FIRST
//      argument.
// Under `reverse` the blocks and the elements are walked back to front
// (scan order k touches position n - 1 - k), so the carry is the later
// composite and still the first argument (pallas_scan.py:269-275). The
// ragged last tile holds the combine's identity past n.
//
// What bounds it on this card: at the chunked path's 262,145-524,289
// elements the inputs are 4-113 MB, so the floor is memory bandwidth (each
// leaf read once and written once: 56.6 MB for the 27-leaf filter in float32
// at 262,145 elements, ~17 us at 3.35 TB/s). This design reads the input
// three times and writes the output once, and each thread's eight elements
// are contiguous, so a warp's loads are strided (they lean on L1/L2 for the
// neighbouring elements); the filter's 27-leaf combine (~300 flops, a 3x3
// inverse) keeps 255 registers and one block per SM in float64. A
// one-pass decoupled look-back and coalesced staging are later work.
#include "scan_lookback.cuh"

namespace {

constexpr int kTiledItems = 8;                       // elements per thread
constexpr int kTile = kScanThreads * kTiledItems;   // elements per block

// Composite of scan-order elements [lo, hi) of one thread; the identity when
// the range is empty (past n).
template <class Op, typename T>
__device__ __forceinline__ void thread_total(const T* __restrict__ in, int n, int lo, int hi,
                                             int reverse, T* acc) {
  constexpr int L = Op::L;
  T x[L], y[L];
  Op::identity(acc);
  for (int k = lo; k < hi; ++k) {
    load_leaves<L>(in, n, reverse ? n - 1 - k : k, x);
    if (k == lo) {
      copy_leaves<L>(x, acc);
    } else {
      Op::apply(acc, x, y);
      copy_leaves<L>(y, acc);
    }
  }
}

// 1. One composite per block tile, written to totals[l * n_blocks + b].
template <class Op, typename T>
__global__ void __launch_bounds__(kScanThreads)
tile_totals_kernel(const T* __restrict__ in, T* __restrict__ totals, int n, int n_blocks,
                   int reverse) {
  constexpr int L = Op::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tot = reinterpret_cast<T*>(smem_raw);  // [L][kScanThreads]
  const int b = blockIdx.x;
  const int lo = min(n, b * kTile + (int)threadIdx.x * kTiledItems);
  const int hi = min(n, lo + kTiledItems);
  T acc[L];
  thread_total<Op, T>(in, n, lo, hi, reverse, acc);
  block_scan<Op, T>(acc, tot);
  if (threadIdx.x == kScanThreads - 1) {
#pragma unroll
    for (int l = 0; l < L; ++l) totals[(size_t)l * n_blocks + b] = acc[l];
  }
}

// 3. The tile's scan with the block's exclusive carry folded in first.
template <class Op, typename T>
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(const T* __restrict__ in, const T* __restrict__ scanned, T* __restrict__ out,
                 int n, int n_blocks, int reverse) {
  constexpr int L = Op::L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tot = reinterpret_cast<T*>(smem_raw);  // [L][kScanThreads]
  const int b = blockIdx.x;
  const int lo = min(n, b * kTile + (int)threadIdx.x * kTiledItems);
  const int hi = min(n, lo + kTiledItems);
  T acc[L], carry[L], x[L], y[L];
  thread_total<Op, T>(in, n, lo, hi, reverse, acc);
  block_scan<Op, T>(acc, tot);
  block_exclusive<Op, T>(tot, carry);
  if (b > 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) x[l] = scanned[(size_t)l * n_blocks + b - 1];
    Op::apply(x, carry, y);
    copy_leaves<L>(y, carry);
  }
  for (int k = lo; k < hi; ++k) {
    const int p = reverse ? n - 1 - k : k;
    load_leaves<L>(in, n, p, x);
    Op::apply(carry, x, y);
    copy_leaves<L>(y, carry);
    store_leaves<L>(out, n, p, y);
  }
}

// Scratch of one tiled scan of n elements: K1's scratch for the block
// totals' scan, then the totals and their scan (L x n_blocks each).
template <class Op, typename T>
struct TiledLayout {
  static int blocks(int n) { return (n + kTile - 1) / kTile; }
  static size_t totals_offset(int n) {
    return (LookbackLayout<Op, T>::scratch_bytes(blocks(n)) + 15) / 16 * 16;
  }
  static size_t scratch_bytes(int n) {
    return totals_offset(n) + 2 * (size_t)Op::L * blocks(n) * sizeof(T);
  }
};

template <class Op, typename T>
struct TiledScan {
  static cudaError_t run(const void* in, void* out, void* scratch, long long scratch_bytes, int n,
                         int reverse, cudaStream_t stream) {
    using Layout = TiledLayout<Op, T>;
    const int n_blocks = Layout::blocks(n);
    if (scratch_bytes < (long long)Layout::scratch_bytes(n)) return cudaErrorInvalidValue;
    T* totals = reinterpret_cast<T*>(static_cast<char*>(scratch) + Layout::totals_offset(n));
    T* scanned = totals + (size_t)Op::L * n_blocks;
    const size_t smem = scan_smem_bytes<Op, T>();
    cudaError_t e = allow_smem(tile_totals_kernel<Op, T>, smem);
    if (e == cudaSuccess) e = allow_smem(tile_scan_kernel<Op, T>, smem);
    if (e != cudaSuccess) return e;
    const T* x = static_cast<const T*>(in);
    tile_totals_kernel<Op, T><<<n_blocks, kScanThreads, smem, stream>>>(x, totals, n, n_blocks,
                                                                       reverse);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    e = LookbackScan<Op, T>::run(totals, scanned, n_blocks, 0, scratch, stream);
    if (e != cudaSuccess) return e;
    tile_scan_kernel<Op, T><<<n_blocks, kScanThreads, smem, stream>>>(
        x, scanned, static_cast<T*>(out), n, n_blocks, reverse);
    return cudaGetLastError();
  }
};

template <class Op, typename T>
struct TiledScratch {
  static cudaError_t run(int n, long long* bytes) {
    *bytes = (long long)TiledLayout<Op, T>::scratch_bytes(n);
    return cudaSuccess;
  }
};

}  // namespace

// Op codes are the order of ops/scan.py:OPS. `scratch` holds
// gps_scan_tiled_scratch_bytes(op, dtype, n) bytes. Returns a cudaError_t.
GPS_EXPORT int gps_scan_tiled(int op, int dtype, const void* in, void* out, void* scratch,
                              long long scratch_bytes, int n, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)dispatch_op<TiledScan, float>(op, in, out, scratch, scratch_bytes, n, reverse, s);
  if (dtype == GPS_F64)
    return (int)dispatch_op<TiledScan, double>(op, in, out, scratch, scratch_bytes, n, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Scratch bytes of gps_scan_tiled for n elements; -1 for an unknown op or
// dtype.
GPS_EXPORT long long gps_scan_tiled_scratch_bytes(int op, int dtype, int n) {
  long long bytes = -1;
  if (dtype == GPS_F32) dispatch_op<TiledScratch, float>(op, n, &bytes);
  if (dtype == GPS_F64) dispatch_op<TiledScratch, double>(op, n, &bytes);
  return bytes;
}
