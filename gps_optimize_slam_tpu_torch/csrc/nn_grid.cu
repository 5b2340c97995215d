// K4: per query, the minimum over valid candidates of the squared distance
// sum_k (a_k - b_k)^2, on a 2-D grid of (query tile, candidate tile) blocks
// gated by the spatial-pruning keep mask.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// nn_min_dist2 (_nn_kernel, the pipelined 2-D grid), which the JAX package
// takes when the candidate image exceeds its 8 MiB VMEM budget
// (m_pad * 8 * 4 B, m_pad > 262,144: pallas_kernels.py:263). The wrapper
// (ops/kernels.py:nn_grid) computes the same keep mask as K3's, in row
// blocks of query tiles, and the same routing rule.
//
// Design: block (i, j) takes query tile i (128 queries, one per thread) and
// candidate tile j (1024 candidates). It returns at once when keep[i, j] is
// 0; the branch is uniform across the block and comes before any barrier.
// Otherwise it stages tile j's x, y and z rows and its validity bytes in
// shared memory (12 KB in float32, 24 KB in float64), every thread runs the
// unrolled 3-term difference form against the 1024 candidates in the order
// K3 (nn.cu) uses, invalid candidates at +inf, and the block folds its
// per-query minimum into the output with an atomicMin on the bit pattern:
// non-negative IEEE values order like their bits as integers (int for
// float32, unsigned long long for float64). The wrapper fills the output with
// +inf first. A NaN distance never wins a block's minimum, so it never
// reaches the atomic. The minimum does not depend on block order, and K3's
// fourth term is (0 - 0)^2 = +0 for a valid candidate, so K4 equals K3 bit
// for bit on the same inputs (--fmad=false: no contraction).
//
// What bounds it on this card: with the car-like trajectories of the
// chunked evaluation a few percent of the (i, j) pairs are kept, so the
// floor is reading the operands once (n * 3 + m * 3.x values) and the cost
// is the kept pairs' subtract-multiply-adds (128 x 1024 x 8 flops a kept
// block) plus one scheduling slot for each skipped block; at 524,288 x
// 524,288 that is a 4,096 x 512 grid. A persistent walk over compacted
// keep lists (as K3 does) is later work.
#include "common.cuh"

namespace {

constexpr int kGridTileN = 128;   // queries per block, one per thread
constexpr int kGridTileM = 1024;  // candidates per tile

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
               const unsigned char* __restrict__ valid, long long m_pad,
               const int* __restrict__ keep, int m_tiles, T* __restrict__ out) {
  const int i = blockIdx.x;
  const int j = blockIdx.y;
  if (keep[(size_t)i * m_tiles + j] == 0) return;
  __shared__ T sb[3][kGridTileM];
  __shared__ unsigned char sv[kGridTileM];
  const size_t c0 = (size_t)j * kGridTileM;
  for (int c = threadIdx.x; c < kGridTileM; c += kGridTileN) {
    sb[0][c] = cand[c0 + c];
    sb[1][c] = cand[(size_t)m_pad + c0 + c];
    sb[2][c] = cand[2 * (size_t)m_pad + c0 + c];
    sv[c] = valid[c0 + c];
  }
  const int q = i * kGridTileN + threadIdx.x;
  T ax = 0, ay = 0, az = 0;
  if (q < n) {
    ax = traj[3 * (size_t)q];
    ay = traj[3 * (size_t)q + 1];
    az = traj[3 * (size_t)q + 2];
  }
  __syncthreads();
  const T inf = Limits<T>::inf();
  T best = inf;
#pragma unroll 4
  for (int c = 0; c < kGridTileM; ++c) {
    const T d0 = ax - sb[0][c];
    const T d1 = ay - sb[1][c];
    const T d2 = az - sb[2][c];
    const T d = sv[c] ? d0 * d0 + d1 * d1 + d2 * d2 : inf;
    best = d < best ? d : best;
  }
  if (q < n && best < inf) atomic_min_nonneg(out + q, best);
}

template <typename T>
cudaError_t launch(const void* traj, int n, const void* cand, const unsigned char* valid,
                   long long m_pad, const int* keep, int n_tiles, int m_tiles, void* out,
                   cudaStream_t s) {
  if (m_pad != (long long)m_tiles * kGridTileM || m_tiles > 65535 || (long long)n_tiles * kGridTileN < n)
    return cudaErrorInvalidValue;
  const dim3 grid(n_tiles, m_tiles);
  nn_grid_kernel<T><<<grid, kGridTileN, 0, s>>>(static_cast<const T*>(traj), n,
                                               static_cast<const T*>(cand), valid, m_pad, keep,
                                               m_tiles, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// traj (n, 3); cand (3, m_pad) rows x, y, z; valid (m_pad,) bytes; keep
// (n_tiles, m_tiles) int32; out (n,) filled with +inf by the caller.
// Returns a cudaError_t.
GPS_EXPORT int gps_nn_grid(int dtype, const void* traj, int n, const void* cand,
                           const unsigned char* valid, long long m_pad, const int* keep,
                           int n_tiles, int m_tiles, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(traj, n, cand, valid, m_pad, keep, n_tiles, m_tiles, out, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(traj, n, cand, valid, m_pad, keep, n_tiles, m_tiles, out, s);
  return (int)cudaErrorInvalidValue;
}
