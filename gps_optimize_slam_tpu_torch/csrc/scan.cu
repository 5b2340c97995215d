// K1: inclusive associative scan (suffix scan when `reverse`) over L
// structure-of-arrays leaves, one thread block per scan.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_vmem (_scan_kernel -> _ladder). That kernel holds the
// leaves in VMEM and runs a Hillis-Steele ladder over (R, 128) tiles. Here the
// leaves (L, n) stay in device memory and one block of 256 threads runs
// reduce-then-scan (scan_kernel in scan_ops.cuh, with the eight combines).
// The wrapper (ops/scan.py) routes a scan here while the JAX package's
// VMEM budget holds (2 * L * n_pad * itemsize <= 4 MiB, n_pad = n rounded
// up to 128) and to K2 (scan_tiled.cu) beyond it; the kernel itself takes
// any n.
//
// What bounds it on this card: latency on one SM. At the main path's sizes
// (n = 271 .. 4661) the data is a few hundred KB at most, and the scan is a
// chain of ~2n/256 + 8 dependent combines per thread, each of which runs
// ~300 flops for the 27-leaf filter. The design keeps every intermediate in
// registers (spilled to local memory for the filter in float64) and touches
// device memory twice per element. A batch grid over sequences is later
// work.
#include "scan_ops.cuh"

namespace {

template <class Op, typename T>
struct BlockScan {
  static cudaError_t run(const void* in, void* out, int n, int reverse, cudaStream_t stream) {
    const size_t smem = scan_smem_bytes<Op, T>();
    cudaError_t e = allow_smem(scan_kernel<Op, T>, smem);
    if (e != cudaSuccess) return e;
    scan_kernel<Op, T><<<1, kScanThreads, smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, reverse);
    return cudaGetLastError();
  }
};

}  // namespace

// Op codes are the order of ops/scan.py:OPS. Returns a cudaError_t.
GPS_EXPORT int gps_scan(int op, int dtype, const void* in, void* out, int n, int reverse,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32) return (int)dispatch_op<BlockScan, float>(op, in, out, n, reverse, s);
  if (dtype == GPS_F64) return (int)dispatch_op<BlockScan, double>(op, in, out, n, reverse, s);
  return (int)cudaErrorInvalidValue;
}

GPS_EXPORT const char* gps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
