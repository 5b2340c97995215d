// The operands of K3 (nn.cu) and K4 (nn_grid.cu): per tile of 128
// queries, the ascending list of the 1024-candidate tiles that may hold a
// nearest neighbour, and its length; and the candidates packed in tiles.
//
// Replaces the array code around the Pallas kernels of
// gps_optimize_slam_tpu/ops/pallas_kernels.py: nn_min_dist2 (the sanitised,
// padded copies at :241-252, _tile_keep_mask at :174, the stable argsort
// at :267-269 and the packed candidate image), which the port first ran as
// float64 PyTorch code (ops/kernels.py:tile_keep_mask and
// pack_candidates_plain, the plain versions). The mask is the same bit for
// bit: the same float64 operations in the same order, with no contraction
// (--fmad=false).
//
// Design, two launches:
//   1. segment_boxes_kernel: one warp per 32-point segment (queries, then
//      candidates), a lane per point, coalesced loads; NaN -> 0 and
//      +-inf -> +-3.4e38 in float64; pad rows replicate the last query;
//      candidates past m or masked out are left out of their box (an empty
//      box is lo = +inf, hi = -inf). Boxes are (6, segments) float64, lo
//      then hi per axis. The candidate warps also write the packed tiles
//      (m_tiles, 4, 1024): the raw x, y, z rows (0 past m) and a validity
//      row (0 valid, +inf masked out or past m).
//   2. keep_lists_kernel: one block of 256 threads per query tile (4 query
//      segments, their boxes in registers). Pass A streams every candidate
//      box (a thread per segment, coalesced) and takes, per query segment,
//      thr = min_j ub; pass B tests lb <= thr + 1e-5 (thr + 1) for every
//      candidate segment. The 32 segments of a candidate tile are one
//      warp's lanes, so a ballot ORs them into the tile's bit, and a
//      prefix over the 8 warps' bits writes the kept tiles in ascending
//      order (no sort) to order[i, :nkept[i]]. Entries past nkept[i] are
//      not written; neither kernel reads them.
//
// What bounds it on this card: operations. Both passes take every
// (query segment, candidate segment) pair: 2 x n_sub x m_sub pairs of ~24
// float64 flops (2.7e8 pairs at 524,288 x 524,288: ~0.4 ms at 34 TFLOP/s).
// The candidate boxes (48 B a segment) are read from L2 by every block.
#include "common.cuh"

namespace {

constexpr int kSub = 32;                      // points per segment
constexpr int kTileM = 1024;                  // candidates per candidate tile
constexpr int kSegsPerTile = kTileM / kSub;
constexpr int kQuerySegs = 128 / kSub;        // query segments per query tile
constexpr int kKeepThreads = 256;
constexpr int kKeepWarps = kKeepThreads / 32;
constexpr double kBig = 3.4e38;               // where +-inf is clamped for the bounds

__device__ __forceinline__ double sanitise(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0 ? kBig : -kBig;
  return v;
}

template <typename T>
__global__ void segment_boxes_kernel(const T* __restrict__ traj, int n, int n_sub,
                                     const T* __restrict__ cand, const unsigned char* __restrict__ mask,
                                     int m, int m_sub, double* __restrict__ tbox,
                                     double* __restrict__ cbox, T* __restrict__ cand4) {
  const int seg_all = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg_all >= n_sub + m_sub) return;  // uniform across the warp
  const bool query = seg_all < n_sub;
  const int seg = query ? seg_all : seg_all - n_sub;
  const long long p = (long long)seg * kSub + lane;
  const double inf = Limits<double>::inf();
  double lo[3], hi[3];
  if (query) {
    const long long q = p < n ? p : n - 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) lo[d] = hi[d] = sanitise((double)traj[3 * q + d]);
  } else {
    const bool valid = p < m && mask[p] != 0;
    T* packed = cand4 + (size_t)(seg / kSegsPerTile) * 4 * kTileM + p % kTileM;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T raw = p < m ? cand[3 * p + d] : T(0);
      packed[(size_t)d * kTileM] = raw;
      const double v = valid ? sanitise((double)raw) : 0.0;
      lo[d] = valid ? v : inf;
      hi[d] = valid ? v : -inf;
    }
    packed[3 * (size_t)kTileM] = valid ? T(0) : Limits<T>::inf();
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const double a = __shfl_xor_sync(0xffffffffu, lo[d], s);
      const double b = __shfl_xor_sync(0xffffffffu, hi[d], s);
      lo[d] = a < lo[d] ? a : lo[d];
      hi[d] = b > hi[d] ? b : hi[d];
    }
  }
  if (lane == 0) {
    double* box = query ? tbox : cbox;
    const int count = query ? n_sub : m_sub;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      box[(size_t)d * count + seg] = lo[d];
      box[(size_t)(3 + d) * count + seg] = hi[d];
    }
  }
}

__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }

// Squared box-to-box distance bounds, in the order of the plain version:
// lb = (g0*g0 + g1*g1) + g2*g2 with g = max(max(qlo - chi, clo - qhi), 0),
// ub the same over s = max(qhi - clo, chi - qlo).
__device__ __forceinline__ double lower_bound(const double* qlo, const double* qhi,
                                              const double* clo, const double* chi) {
  double g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = dmax(dmax(qlo[d] - chi[d], clo[d] - qhi[d]), 0.0);
  return g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
}

__device__ __forceinline__ double upper_bound(const double* qlo, const double* qhi,
                                              const double* clo, const double* chi) {
  double s[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) s[d] = dmax(qhi[d] - clo[d], chi[d] - qlo[d]);
  return s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
}

__device__ __forceinline__ void load_box(const double* __restrict__ box, int count, int seg,
                                         double* lo, double* hi) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = box[(size_t)d * count + seg];
    hi[d] = box[(size_t)(3 + d) * count + seg];
  }
}

__global__ void __launch_bounds__(kKeepThreads)
keep_lists_kernel(const double* __restrict__ tbox, int n_sub, const double* __restrict__ cbox,
                  int m_sub, int m_tiles, int* __restrict__ order, int* __restrict__ nkept) {
  __shared__ double s_thr[kKeepWarps][kQuerySegs];
  __shared__ int s_kept[2][kKeepWarps];
  const int i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double qlo[kQuerySegs][3], qhi[kQuerySegs][3], clo[3], chi[3];
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) load_box(tbox, n_sub, i * kQuerySegs + s, qlo[s], qhi[s]);

  // Pass A: per query segment, the least upper bound over all candidates.
  double thr[kQuerySegs];
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) thr[s] = Limits<double>::inf();
  for (int j = tid; j < m_sub; j += kKeepThreads) {
    load_box(cbox, m_sub, j, clo, chi);
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) {
      const double ub = upper_bound(qlo[s], qhi[s], clo, chi);
      thr[s] = ub < thr[s] ? ub : thr[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double v = __shfl_xor_sync(0xffffffffu, thr[s], o);
      thr[s] = v < thr[s] ? v : thr[s];
    }
    if (lane == 0) s_thr[warp][s] = thr[s];
  }
  __syncthreads();
  double bound[kQuerySegs];
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) {
    double t = s_thr[0][s];
#pragma unroll
    for (int w = 1; w < kKeepWarps; ++w) t = s_thr[w][s] < t ? s_thr[w][s] : t;
    bound[s] = t + 1e-5 * (t + 1.0);
  }

  // Pass B: a candidate tile is kept when any of its 32 segments (one
  // warp's lanes) passes for any query segment; kept tiles are written in
  // ascending order.
  int count = 0;
  for (int base = 0; base < m_sub; base += kKeepThreads) {
    const int j = base + tid;
    bool keep = false;
    if (j < m_sub) {
      load_box(cbox, m_sub, j, clo, chi);
#pragma unroll
      for (int s = 0; s < kQuerySegs; ++s) keep |= lower_bound(qlo[s], qhi[s], clo, chi) <= bound[s];
    }
    const int kept = __ballot_sync(0xffffffffu, keep) != 0;
    const int buf = (base / kKeepThreads) & 1;  // two buffers: one barrier an iteration
    if (lane == 0) s_kept[buf][warp] = kept;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kKeepWarps; ++w) {
      before += w < warp ? s_kept[buf][w] : 0;
      total += s_kept[buf][w];
    }
    if (lane == 0 && kept) order[(size_t)i * m_tiles + count + before] = base / kSub + warp;
    count += total;
  }
  if (tid == 0) nkept[i] = count;
}

template <typename T>
cudaError_t launch(const void* traj, int n, const void* cand, const unsigned char* mask, int m,
                   double* boxes, int n_tiles, int m_tiles, int* order, int* nkept, void* cand4,
                   cudaStream_t s) {
  if (n < 1 || m < 0 || (long long)n_tiles * 128 < n || (long long)m_tiles * kTileM < m)
    return cudaErrorInvalidValue;
  const int n_sub = n_tiles * kQuerySegs, m_sub = m_tiles * kSegsPerTile;
  double* tbox = boxes;
  double* cbox = boxes + 6 * (size_t)n_sub;
  const int warps_per_block = kKeepThreads / 32;
  const int blocks = (n_sub + m_sub + warps_per_block - 1) / warps_per_block;
  segment_boxes_kernel<T><<<blocks, kKeepThreads, 0, s>>>(
      static_cast<const T*>(traj), n, n_sub, static_cast<const T*>(cand), mask, m, m_sub, tbox, cbox,
      static_cast<T*>(cand4));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  keep_lists_kernel<<<n_tiles, kKeepThreads, 0, s>>>(tbox, n_sub, cbox, m_sub, m_tiles, order, nkept);
  return cudaGetLastError();
}

}  // namespace

// traj (n, 3), cand (m, 3) in the working dtype, mask (m,) bytes; boxes
// 6 * (4 * n_tiles + 32 * m_tiles) float64 of scratch; out: order (n_tiles,
// m_tiles) and nkept (n_tiles,) int32, cand4 (m_tiles, 4, 1024) in the
// working dtype. Returns a cudaError_t.
GPS_EXPORT int gps_nn_keep(int dtype, const void* traj, int n, const void* cand,
                           const unsigned char* mask, int m, double* boxes, int n_tiles,
                           int m_tiles, int* order, int* nkept, void* cand4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(traj, n, cand, mask, m, boxes, n_tiles, m_tiles, order, nkept, cand4, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(traj, n, cand, mask, m, boxes, n_tiles, m_tiles, order, nkept, cand4, s);
  return (int)cudaErrorInvalidValue;
}
