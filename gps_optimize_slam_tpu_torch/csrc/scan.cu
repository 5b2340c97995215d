// K1: inclusive associative scan (suffix scan when `reverse`) over L
// structure-of-arrays leaves, in one launch of many blocks.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_vmem (_scan_kernel -> _ladder). That kernel holds the
// leaves in VMEM and runs a Hillis-Steele ladder over (R, 128) tiles on one
// core. Here the leaves (L, n) stay in device memory and a grid of tiles
// scans them in a single pass with decoupled look-back
// (lookback_scan_kernel in scan_lookback.cuh, with the eight combines of
// scan_ops.cuh). The wrapper (ops/scan.py) routes a scan here up to 65,536
// elements, the crossover measured on an H100, and to K2 (scan_tiled.cu)
// beyond it; the kernel itself takes any n.
//
// What bounds it on this card: at the main path's sizes (n = 271 .. 4661,
// 1-19 tiles) launch latency and the chain of dependent combines of one
// tile (ITEMS + 5 + 3 + the look-back + ITEMS); at long n the bytes for
// 2-4 leaves and the 27-leaf filter's operations (see scan_lookback.cuh).
#include "scan_lookback.cuh"

// Op codes are the order of ops/scan.py:OPS. `scratch` holds
// gps_scan_scratch_bytes(op, dtype, n) bytes. Returns a cudaError_t.
GPS_EXPORT int gps_scan(int op, int dtype, const void* in, void* out, int n, int reverse,
                        void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)dispatch_op<LookbackScan, float>(op, in, out, n, reverse, scratch, s);
  if (dtype == GPS_F64)
    return (int)dispatch_op<LookbackScan, double>(op, in, out, n, reverse, scratch, s);
  return (int)cudaErrorInvalidValue;
}

// Scratch bytes of gps_scan for n elements; -1 for an unknown op or dtype.
GPS_EXPORT long long gps_scan_scratch_bytes(int op, int dtype, int n) {
  long long bytes = -1;
  if (dtype == GPS_F32) dispatch_op<LookbackScratch, float>(op, n, &bytes);
  if (dtype == GPS_F64) dispatch_op<LookbackScratch, double>(op, n, &bytes);
  return bytes;
}

// Elements per tile of gps_scan for this combine; -1 for an unknown op.
GPS_EXPORT int gps_scan_tile(int op) {
  int tile = -1;
  dispatch_op<LookbackTile, float>(op, &tile);
  return tile;
}

GPS_EXPORT const char* gps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
