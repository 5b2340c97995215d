// K5: Sim(3) RANSAC consensus counts. For every trial t,
//   count[t] = #{ i : valid_i and |s_t R_t p_i + t_t - d_i|^2 < thr2 }.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// ransac_counts (_ransac_count_kernel). The TPU kernel puts the residual on
// the MXU as a centred 18-term quadratic form, whose rounding flips counts
// near the threshold. Here the residual is the exact elementwise form, in the
// order of ops/ransac.py (s * (R p) + t - d, squared, summed), so the counts
// equal the plain PyTorch version; the caller still re-ranks its top 16.
//
// Design: one block of 256 threads per trial; threads stride over the
// points, count in registers, and a warp-shuffle reduction plus one shared
// word per warp gives the int32 count. The points (n x 7 values) stay in L2
// across the 1000 blocks.
//
// What bounds it on this card: ~20 flops per trial x point, 1000 x 4661
// ~ 1e8 flops at the main path's size, well under a millisecond of the card's
// float32 and float64 rates; at this size launch latency and the tail of the
// last wave dominate.
#include "common.cuh"

namespace {

constexpr int kCountThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const T* __restrict__ src, const T* __restrict__ dst,
             const uint8_t* __restrict__ valid, int n, const T* __restrict__ R,
             const T* __restrict__ t, const T* __restrict__ s, T thr2,
             int* __restrict__ out) {
  const int trial = blockIdx.x;
  const T* r = R + 9 * (size_t)trial;
  const T r00 = r[0], r01 = r[1], r02 = r[2];
  const T r10 = r[3], r11 = r[4], r12 = r[5];
  const T r20 = r[6], r21 = r[7], r22 = r[8];
  const T t0 = t[3 * (size_t)trial], t1 = t[3 * (size_t)trial + 1], t2 = t[3 * (size_t)trial + 2];
  const T sc = s[trial];
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kCountThreads) {
    if (!valid[i]) continue;
    const T p0 = src[3 * (size_t)i], p1 = src[3 * (size_t)i + 1], p2 = src[3 * (size_t)i + 2];
    const T e0 = sc * (p0 * r00 + p1 * r01 + p2 * r02) + t0 - dst[3 * (size_t)i];
    const T e1 = sc * (p0 * r10 + p1 * r11 + p2 * r12) + t1 - dst[3 * (size_t)i + 1];
    const T e2 = sc * (p0 * r20 + p1 * r21 + p2 * r22) + t2 - dst[3 * (size_t)i + 2];
    const T res2 = e0 * e0 + e1 * e1 + e2 * e2;
    cnt += res2 < thr2 ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  __shared__ int warp_sums[kCountThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kCountThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if (lane == 0) out[trial] = cnt;
  }
}

template <typename T>
cudaError_t launch(const void* src, const void* dst, const uint8_t* valid, int n,
                   const void* R, const void* t, const void* s, int T_trials, double thr2,
                   int* out, cudaStream_t st) {
  count_kernel<T><<<T_trials, kCountThreads, 0, st>>>(
      static_cast<const T*>(src), static_cast<const T*>(dst), valid, n,
      static_cast<const T*>(R), static_cast<const T*>(t), static_cast<const T*>(s),
      static_cast<T>(thr2), out);
  return cudaGetLastError();
}

}  // namespace

// src, dst (n, 3); valid (n,) bool; R (T, 3, 3); t (T, 3); s (T,); out (T,)
// int32. Returns a cudaError_t.
GPS_EXPORT int gps_ransac_counts(int dtype, const void* src, const void* dst,
                                 const void* valid, int n, const void* R, const void* t,
                                 const void* s, int n_trials, double thr2, void* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* o = static_cast<int*>(out);
  if (dtype == GPS_F32) return (int)launch<float>(src, dst, v, n, R, t, s, n_trials, thr2, o, st);
  if (dtype == GPS_F64) return (int)launch<double>(src, dst, v, n, R, t, s, n_trials, thr2, o, st);
  return (int)cudaErrorInvalidValue;
}
