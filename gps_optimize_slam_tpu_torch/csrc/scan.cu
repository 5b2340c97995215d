// K1: inclusive associative scan (suffix scan when `reverse`) over L
// structure-of-arrays leaves, in one launch of many blocks.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_vmem (_scan_kernel -> _ladder). That kernel holds the
// leaves in VMEM and runs a Hillis-Steele ladder over (R, 128) tiles on one
// core. Here the leaves (L, n) stay in device memory and a grid of tiles
// scans them in a single pass. The wrapper (ops/scan.py) routes a scan here
// up to 65,536 elements, the crossover measured on an H100, and to K2
// (scan_tiled.cu) beyond it; the kernel itself takes any n. A launch takes
// one of two paths, chosen here from the shape (no option):
//   - a batch (B > 1) of rows that each fit in a thread-block cluster
//     (every combine but the filter): the cluster path of scan_cluster.cuh,
//     a cluster a row, the carry of a tile folded from the aggregates of
//     the row's earlier tiles in the other blocks' shared memory; one
//     kernel node, no scratch;
//   - every other launch: decoupled look-back (lookback_scan_kernel in
//     scan_lookback.cuh), a ticket, flags and values in scratch zeroed by
//     one memset, over every row's tiles.
// Both fold with the eight combines of scan_ops.cuh.
//
// What bounds it on this card: at the main path's sizes (n = 271 .. 4661,
// 1-19 tiles) launch latency and the chain of dependent combines of one
// tile; at long n the bytes for 2-4 leaves and the 27-leaf filter's
// operations, which its work-efficient runs tile keeps near two combines
// an element (see scan_lookback.cuh).
#include "scan_cluster.cuh"

// The cluster path's launch, compiled in scan_cluster.cu (its own nvcc
// process, beside this one).
cudaError_t gps_cluster_scan(int op, int dtype, const void* in, void* out, int n, int batch, int reverse,
                             cudaStream_t stream);

namespace {

// The cluster size of K1's launch of `batch` rows of n elements (0: the
// look-back path), written to *c.
template <class Op, typename T>
struct K1Cluster {
  static cudaError_t run(int n, int batch, int* c) {
    *c = cluster_size<Op>(n, batch);
    return cudaSuccess;
  }
};

template <class Op, typename T>
struct K1Tile {
  static cudaError_t run(int n, int batch, int* tile) {
    if (cluster_size<Op>(n, batch) > 0) {
      *tile = cluster_tile<Op>(n, batch);
      return cudaSuccess;
    }
    return LookbackTile<Op, T>::run(n, batch, tile);
  }
};

int cluster_of(int op, int dtype, int n, int batch) {
  int c = -1;
  if (dtype == GPS_F32) dispatch_op<K1Cluster, float>(op, n, batch, &c);
  if (dtype == GPS_F64) dispatch_op<K1Cluster, double>(op, n, batch, &c);
  return c;
}

}  // namespace

// Op codes are the order of ops/scan.py:OPS. `in` and `out` are (L, batch,
// n) leaves, each of the `batch` rows scanned on its own; `scratch` holds
// gps_scan_scratch_bytes(op, dtype, n, batch) bytes (none on the cluster
// path, which never reads it). Returns a cudaError_t.
GPS_EXPORT int gps_scan(int op, int dtype, const void* in, void* out, int n, int batch,
                        int reverse, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && cluster_of(op, dtype, n, batch) > 0)
    return (int)gps_cluster_scan(op, dtype, in, out, n, batch, reverse, s);
  if (dtype == GPS_F32)
    return (int)dispatch_op<LookbackScan, float>(op, in, out, n, batch, reverse, scratch, s);
  if (dtype == GPS_F64)
    return (int)dispatch_op<LookbackScan, double>(op, in, out, n, batch, reverse, scratch, s);
  return (int)cudaErrorInvalidValue;
}

// Scratch bytes of gps_scan for `batch` rows of n elements (0 on the
// cluster path); -1 for an unknown op or dtype.
GPS_EXPORT long long gps_scan_scratch_bytes(int op, int dtype, int n, int batch) {
  const int c = cluster_of(op, dtype, n, batch);
  if (c != 0) return c < 0 ? -1 : 0;
  long long bytes = -1;
  if (dtype == GPS_F32) dispatch_op<LookbackScratch, float>(op, n, batch, &bytes);
  if (dtype == GPS_F64) dispatch_op<LookbackScratch, double>(op, n, batch, &bytes);
  return bytes;
}

// Elements per tile of gps_scan for this combine and dtype at `batch` rows
// of n elements (the cluster path's tile, or the look-back path's, whose
// filter, rts and quat_chain tiles depend on them); -1 for an unknown op or
// dtype.
GPS_EXPORT int gps_scan_tile(int op, int dtype, int n, int batch) {
  int tile = -1;
  if (dtype == GPS_F32) dispatch_op<K1Tile, float>(op, n, batch, &tile);
  if (dtype == GPS_F64) dispatch_op<K1Tile, double>(op, n, batch, &tile);
  return tile;
}

// Blocks a cluster of gps_scan at `batch` rows of n elements: one cluster a
// row where a row fits in at most kClusterMax tiles of its combine's
// cluster tile and batch > 1, else 0 (the look-back path); -1 for an
// unknown op or dtype.
GPS_EXPORT int gps_scan_cluster(int op, int dtype, int n, int batch) { return cluster_of(op, dtype, n, batch); }

GPS_EXPORT const char* gps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
