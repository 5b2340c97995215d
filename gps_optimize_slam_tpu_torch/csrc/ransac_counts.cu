// K5: Sim(3) RANSAC consensus counts. For every trial t,
//   count[t] = #{ i : valid_i and |s_t R_t p_i + t_t - d_i|^2 < thr2 }.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// ransac_counts (_ransac_count_kernel). The TPU kernel puts the residual on
// the MXU as a centred 18-term quadratic form, whose rounding flips counts
// near the threshold. Here the residual is the exact elementwise form, in the
// order of ops/ransac.py (s * (R p) + t - d, squared, summed, uncontracted:
// --fmad=false), so the counts equal the plain PyTorch version; the caller
// still re-ranks its top 16.
//
// What bounds it on this card: operations, ~28 uncontracted float
// operations a (trial, point) pair plus ~7 to load a trial and count a hit
// (1000 x 4,661 pairs at the main path's size: ~6 microseconds of the card's
// float32 rate, beside which the launch and the first loads still show), once
// no pair costs more than that. The kernel's first design, one block a
// trial that strode over the points, re-read every point for every trial:
// seven strided loads a pair, 116 MB through L1/L2 a call, the load pipe
// four times as busy as the arithmetic.
//
// Design: the loops turned inside out. The grid is (chunks of 256 points) x
// (chunks of 32 trials): 608 blocks at 1000 x 4,661. A thread keeps one
// point (p, d, valid) in registers, loaded once; the block stages its trials
// in shared memory as records of 16 values (R row-major, t, s, padding), and
// every thread walks them: a trial's record is four (float32) or eight
// (float64) broadcast 16-byte loads. A warp sums its threads' hits for a
// trial with one __reduce_add_sync and lane u keeps the sum of trial u, so
// after the walk each lane adds one sum to the block's shared counters; the
// block folds those into the output with one integer atomicAdd a trial.
// Integer sums are exact in any order, so the counts do not change from run
// to run. The wrapper zeroes the output. Several points a thread and longer
// trial chunks were measured too: they win only at tens of thousands of
// points, which no caller sends (PERF.md).
#include "common.cuh"

namespace {

constexpr int kCountThreads = 256;
constexpr int kCountTrials = 32;  // trials a block: one a lane of a warp

template <typename T>
__global__ void __launch_bounds__(kCountThreads)
count_kernel(const T* __restrict__ src, const T* __restrict__ dst,
             const uint8_t* __restrict__ valid, int n, const T* __restrict__ R,
             const T* __restrict__ t, const T* __restrict__ s, int n_trials, T thr2,
             int* __restrict__ out) {
  using V = typename Vec16<T>::type;
  constexpr int kVecs = (int)sizeof(T);  // a record of 16 values is sizeof(T) 16-byte loads
  __shared__ __align__(16) T par[kCountTrials][16];
  __shared__ int cnt[kCountTrials];
  const int trial0 = blockIdx.y * kCountTrials;
  const int tc = min(kCountTrials, n_trials - trial0);
  for (int idx = threadIdx.x; idx < tc * 16; idx += kCountThreads) {
    const int k = idx & 15;
    const size_t g = (size_t)trial0 + (idx >> 4);
    T v = 0;
    if (k < 9) v = R[9 * g + k];
    else if (k < 12) v = t[3 * g + (k - 9)];
    else if (k == 12) v = s[g];
    par[idx >> 4][k] = v;
  }
  if (threadIdx.x < kCountTrials) cnt[threadIdx.x] = 0;

  const long long i = (long long)blockIdx.x * kCountThreads + threadIdx.x;
  const bool ok = i < n && valid[i];
  T p0 = 0, p1 = 0, p2 = 0, d0 = 0, d1 = 0, d2 = 0;
  if (ok) {
    p0 = src[3 * i], p1 = src[3 * i + 1], p2 = src[3 * i + 2];
    d0 = dst[3 * i], d1 = dst[3 * i + 1], d2 = dst[3 * i + 2];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int mine = 0;  // this warp's hits of trial trial0 + lane
#pragma unroll 4
  for (int u = 0; u < tc; ++u) {
    __align__(16) T r[16];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      reinterpret_cast<V*>(r)[k] = reinterpret_cast<const V*>(par[u])[k];
    const T e0 = r[12] * (p0 * r[0] + p1 * r[1] + p2 * r[2]) + r[9] - d0;
    const T e1 = r[12] * (p0 * r[3] + p1 * r[4] + p2 * r[5]) + r[10] - d1;
    const T e2 = r[12] * (p0 * r[6] + p1 * r[7] + p2 * r[8]) + r[11] - d2;
    const T res2 = e0 * e0 + e1 * e1 + e2 * e2;
    const int hit = (ok && res2 < thr2) ? 1 : 0;
    const int total = __reduce_add_sync(0xffffffffu, hit);
    if (lane == u) mine = total;
  }
  if (mine != 0) atomicAdd(&cnt[lane], mine);
  __syncthreads();
  if (threadIdx.x < tc && cnt[threadIdx.x] != 0) atomicAdd(out + trial0 + threadIdx.x, cnt[threadIdx.x]);
}

template <typename T>
cudaError_t launch(const void* src, const void* dst, const uint8_t* valid, int n,
                   const void* R, const void* t, const void* s, int n_trials, double thr2,
                   int* out, cudaStream_t st) {
  if (n < 1 || n_trials < 1) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kCountThreads - 1) / kCountThreads),
                  (unsigned)((n_trials + kCountTrials - 1) / kCountTrials));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  count_kernel<T><<<grid, kCountThreads, 0, st>>>(
      static_cast<const T*>(src), static_cast<const T*>(dst), valid, n,
      static_cast<const T*>(R), static_cast<const T*>(t), static_cast<const T*>(s), n_trials,
      static_cast<T>(thr2), out);
  return cudaGetLastError();
}

}  // namespace

// src, dst (n, 3); valid (n,) bool; R (T, 3, 3); t (T, 3); s (T,); out (T,)
// int32, zeroed by the caller. Returns a cudaError_t.
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
