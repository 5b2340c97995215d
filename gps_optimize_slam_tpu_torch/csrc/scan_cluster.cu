// K1's batch grid for short rows (scan_cluster.cuh): the cluster path's
// instantiations, one per combine (but the filter), type and tile, in a
// translation unit of their own so that nvcc builds them beside scan.cu.
#include "scan_cluster.cuh"

namespace {

template <class Op, typename T>
struct ClusterScan {
  static cudaError_t run(const void* in, void* out, int n, int batch, int reverse, cudaStream_t stream) {
    switch (cluster_choice<Op>(n, batch)) {
      case 0: return cluster_run_at<Op, T, 0>(in, out, n, batch, reverse, stream);
      case 1: return cluster_run_at<Op, T, 1>(in, out, n, batch, reverse, stream);
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// The cluster path of gps_scan (scan.cu), which calls it only where
// cluster_size gives a cluster.
cudaError_t gps_cluster_scan(int op, int dtype, const void* in, void* out, int n, int batch, int reverse,
                             cudaStream_t stream) {
  if (dtype == GPS_F32) return dispatch_op<ClusterScan, float>(op, in, out, n, batch, reverse, stream);
  if (dtype == GPS_F64) return dispatch_op<ClusterScan, double>(op, in, out, n, batch, reverse, stream);
  return cudaErrorInvalidValue;
}
