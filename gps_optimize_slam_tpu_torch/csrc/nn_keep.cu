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
//   1. segment_boxes_kernel: blocks of 32 warps, one warp per 32-point
//      segment (queries, then one block per candidate tile), a lane per
//      point, coalesced loads; NaN -> 0 and +-inf -> +-3.4e38 in float64;
//      pad rows replicate the last query; candidates past m or masked out
//      are left out of their box (an empty box is lo = +inf, hi = -inf).
//      Boxes are (6, segments) float64, lo then hi per axis. A candidate
//      block also writes its packed tile (m_tiles, 4, 1024): the raw x, y, z
//      rows (0 past m) and a validity row (0 valid, +inf masked out or past
//      m); and the tile's own box, the min/max over its 32 segment boxes
//      (empty segments drop out of a min/max by themselves; a tile with no
//      valid candidate keeps the empty box).
//   2. keep_lists_kernel<Q>: one block of 256 threads per Q consecutive
//      query tiles (4 Q query segments, their boxes in shared memory; Q is
//      4, 2 or 1, the largest that still leaves two blocks for each of the
//      card's 132 SMs). The candidate tile boxes (48 B a tile) sit in shared
//      memory for the whole block when they fit (896 tiles), so a block
//      reads them from L2 once; only the tiles that survive a tile-level
//      test have their 32 segment boxes read, once a pass, by a warp (a
//      lane a segment) that tests them against all 4 Q query segments.
//        Pass A, thr[q] = min over candidate segments of ub(q, segment):
//      a first sweep over the tile boxes (a thread a tile) seeds every
//      thr[q] with min over tiles of ub(block box, tile), the box around
//      all the block's query segments, which no segment of a tile with a
//      valid candidate exceeds for any q; then, 256 tiles at a time, the
//      tiles with lb(q, tile) <= thr[q] for some q are compacted into a
//      list and the warps fold their segments' ub into thr (lane-private
//      minima, folded into shared memory after each 256 tiles, so the test
//      sharpens as it goes). The test for "some q" starts with one bound
//      from the block box against the largest thr, which rules out most
//      tiles at a sixteenth of the cost and decides nothing else.
//        Pass B, keep = lb(q, segment) <= thr[q] + 1e-5 (thr[q] + 1): the
//      same tile-level test against the slackened bound, the survivors'
//      segments tested per query tile (one ballot each), and warp t of the
//      block writes query tile t's kept tiles in ascending order by a
//      prefix over the survivors' bits (no sort) to order[i, :nkept[i]].
//      Entries past nkept[i] are not written; neither NN kernel reads them.
//
// Why the tile-level test is exact. A tile box contains each of its
// non-empty segments' boxes, so per axis its gap to a query box is no larger
// and its span no smaller; subtraction, max, the squares of non-negative
// numbers and the sums are monotone under round-to-nearest, and both levels
// use the same expressions in the same order, so in floating point
//     lb(block, tile) <= lb(q, tile) <= lb(q, segment)
//                     <= ub(q, segment) <= ub(q, tile) <= ub(block, tile).
// A tile skipped in pass A has lb(q, tile) > thr[q] for the thr of that
// moment, which only falls: none of its segments can lower any thr, and a
// minimum does not depend on the order or on what was skipped above it, so
// thr is the same double as the plain version's. A tile skipped in pass B
// has no segment that passes. An empty box gives lb = ub = +inf (never NaN:
// the differences are +-inf, never inf - inf), so with every candidate
// masked thr = +inf and every tile is kept, as in the JAX mask.
//
// What bounds it on this card: with the tile-level tests the work is three
// sweeps over (block, candidate tile) pairs (1.6e6 at 524,288 x 524,288,
// ~17 float64 operations each) plus the few tiles near a block, so the
// floor is the bytes: the coordinates read once, the packed
// candidates and the lists written once. A block reads 24 KB of tile boxes
// and 1.5 KB a surviving tile and pass from L2, where the first version
// read 1.6 MB a query tile.
#include "common.cuh"

namespace {

constexpr int kSub = 32;                      // points per segment
constexpr int kTileM = 1024;                  // candidates per candidate tile
constexpr int kSegsPerTile = kTileM / kSub;
constexpr int kQuerySegs = 128 / kSub;        // query segments per query tile
constexpr int kBoxThreads = 32 * kSegsPerTile;  // a candidate tile a block
constexpr int kKeepThreads = 256;
constexpr int kKeepWarps = kKeepThreads / 32;
constexpr int kMaxQ = 4;            // query tiles a block, at most
constexpr int kFillBlocks = 2 * 132;  // blocks that fill an H100: two an SM
constexpr int kCachedTiles = 896;   // tile boxes held in shared memory (42 KB)
constexpr double kBig = 3.4e38;               // where +-inf is clamped for the bounds

__device__ __forceinline__ double sanitise(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0 ? kBig : -kBig;
  return v;
}

// The warp's box from its lanes' boxes, left in every lane.
__device__ __forceinline__ void warp_box(double* lo, double* hi) {
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
}

template <typename T>
__global__ void __launch_bounds__(kBoxThreads)
segment_boxes_kernel(const T* __restrict__ traj, int n, int n_sub, int q_blocks,
                     const T* __restrict__ cand, const unsigned char* __restrict__ mask, int m,
                     int m_sub, int m_tiles, double* __restrict__ tbox, double* __restrict__ cbox,
                     double* __restrict__ tilebox, T* __restrict__ cand4) {
  __shared__ double s_box[6][kSegsPerTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool query = (int)blockIdx.x < q_blocks;  // uniform across the block
  const int tile = (int)blockIdx.x - q_blocks;    // of a candidate block
  const int seg = (query ? (int)blockIdx.x : tile) * kSegsPerTile + warp;
  if (query && seg >= n_sub) return;  // query blocks meet no barrier
  const long long p = (long long)seg * kSub + lane;
  const double inf = Limits<double>::inf();
  double lo[3], hi[3];
  if (query) {
    const long long q = p < n ? p : n - 1;
#pragma unroll
    for (int d = 0; d < 3; ++d) lo[d] = hi[d] = sanitise((double)traj[3 * q + d]);
  } else {
    const bool valid = p < m && mask[p] != 0;
    T* packed = cand4 + (size_t)tile * 4 * kTileM + p % kTileM;
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
  warp_box(lo, hi);
  if (lane == 0) {
    double* box = query ? tbox : cbox;
    const int count = query ? n_sub : m_sub;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      box[(size_t)d * count + seg] = lo[d];
      box[(size_t)(3 + d) * count + seg] = hi[d];
      if (!query) {
        s_box[d][warp] = lo[d];
        s_box[3 + d][warp] = hi[d];
      }
    }
  }
  if (query) return;
  __syncthreads();
  if (warp == 0) {  // the tile's box: a lane a segment
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = s_box[d][lane];
      hi[d] = s_box[3 + d][lane];
    }
    warp_box(lo, hi);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        tilebox[(size_t)d * m_tiles + tile] = lo[d];
        tilebox[(size_t)(3 + d) * m_tiles + tile] = hi[d];
      }
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

// The block's query boxes in shared memory, (6, QS): lo then hi per axis;
// and the box around all of them.
template <int QS>
struct QueryBoxes {
  double v[6][QS];
  double all[6];
  __device__ __forceinline__ double lb_all(const double* clo, const double* chi) const {
    return lower_bound(all, all + 3, clo, chi);
  }
  __device__ __forceinline__ double ub_all(const double* clo, const double* chi) const {
    return upper_bound(all, all + 3, clo, chi);
  }
  __device__ __forceinline__ double lb(int q, const double* clo, const double* chi) const {
    const double qlo[3] = {v[0][q], v[1][q], v[2][q]}, qhi[3] = {v[3][q], v[4][q], v[5][q]};
    return lower_bound(qlo, qhi, clo, chi);
  }
  __device__ __forceinline__ double ub(int q, const double* clo, const double* chi) const {
    const double qlo[3] = {v[0][q], v[1][q], v[2][q]}, qhi[3] = {v[3][q], v[4][q], v[5][q]};
    return upper_bound(qlo, qhi, clo, chi);
  }
};

// The minimum over the warp's lanes, in every lane.
__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// *slot = min(*slot, v) in shared memory. The bounds are non-negative
// doubles or +inf, which order as their bit patterns do, so the minimum
// across warps is an integer atomicMin.
__device__ __forceinline__ void shared_min(double* slot, double v) {
  atomicMin(reinterpret_cast<unsigned long long*>(slot), (unsigned long long)__double_as_longlong(v));
}

// Folds the lanes' private minima for one query tile's segments into the
// block's thr.
__device__ __forceinline__ void fold_thr(const double* mine, double* s_thr) {
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) {
    const double v = warp_min(mine[s]);
    if ((threadIdx.x & 31) == 0) shared_min(&s_thr[s], v);
  }
}

// Whether the candidate tile box (clo, chi) can matter to the block:
// lb(q, tile) <= limit[q] for some of its Q * 4 query segments. The block
// box's bound goes first: above the largest limit it rules the tile out for
// every q, as the loop would, at a sixteenth of the cost.
template <int Q>
__device__ __forceinline__ bool tile_near(const QueryBoxes<Q * kQuerySegs>& boxes, const double* limit,
                                          const double* clo, const double* chi) {
  double most = 0.0;
  for (int q = 0; q < Q * kQuerySegs; ++q) most = dmax(most, limit[q]);
  if (!(boxes.lb_all(clo, chi) <= most)) return false;
  bool near = false;
#pragma unroll 1
  for (int i = 0; i < Q && !near; ++i) {
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) {
      const int q = i * kQuerySegs + s;
      near |= boxes.lb(q, clo, chi) <= limit[q];
    }
  }
  return near;
}

// The tiles t (one a thread, ascending with the thread index) with `keep`
// set, compacted in ascending order into s_list; returns their count.
// Two barriers; the second ends the call.
__device__ __forceinline__ int compact_tiles(bool keep, int t, int* s_wcount, int* s_list) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bits = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_wcount[warp] = __popc(bits);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kKeepWarps; ++w) {
    before += w < warp ? s_wcount[w] : 0;
    total += s_wcount[w];
  }
  if (keep) s_list[before + __popc(bits & ((1u << lane) - 1u))] = t;
  __syncthreads();
  return total;
}

template <int Q>
__global__ void __launch_bounds__(kKeepThreads, 2)
keep_lists_kernel(const double* __restrict__ tbox, int n_sub, int n_tiles,
                  const double* __restrict__ cbox, int m_sub, const double* __restrict__ tilebox,
                  int m_tiles, int cached, int* __restrict__ order, int* __restrict__ nkept) {
  constexpr int QS = Q * kQuerySegs;
  extern __shared__ double s_tilebox[];  // (6, m_tiles) when `cached`
  __shared__ QueryBoxes<QS> s_q;
  __shared__ double s_lim[QS];  // the running thr in pass A, the slackened bound in pass B
  __shared__ int s_list[kKeepThreads];
  __shared__ unsigned char s_flag[kKeepThreads];
  __shared__ int s_wcount[kKeepWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first_tile = blockIdx.x * Q;
  const double inf = Limits<double>::inf();

  // The last block may hold fewer than Q query tiles: the missing ones
  // replicate the last segment, which changes no bound, and write nothing.
  if (tid < 6 * QS) {
    const int q = tid % QS, seg = first_tile * kQuerySegs + q;
    s_q.v[tid / QS][q] = tbox[(size_t)(tid / QS) * n_sub + (seg < n_sub ? seg : n_sub - 1)];
  }
  if (tid < QS) s_lim[tid] = inf;
  if (cached) {
    for (int k = tid; k < 6 * m_tiles; k += kKeepThreads) s_tilebox[k] = tilebox[k];
  }
  const double* __restrict__ tb = cached ? s_tilebox : tilebox;
  __syncthreads();
  if (tid < 6) {
    double v = s_q.v[tid][0];
    for (int q = 1; q < QS; ++q) v = (tid < 3 ? s_q.v[tid][q] < v : s_q.v[tid][q] > v) ? s_q.v[tid][q] : v;
    s_q.all[tid] = v;
  }
  __syncthreads();

  // The loops over the block's query tiles are not unrolled (one query
  // tile's 4 segments at a time), so the registers do not grow with Q and
  // two blocks share an SM.
  double mine[kQuerySegs], clo[3], chi[3];

  // Pass A, seed: thr[q] = min over tiles of ub(block box, tile box), an
  // upper bound of every thr[q] (the block box contains q's box).
  {
    double seed = inf;
    for (int t = tid; t < m_tiles; t += kKeepThreads) {
      load_box(tb, m_tiles, t, clo, chi);
      const double ub = s_q.ub_all(clo, chi);
      seed = ub < seed ? ub : seed;
    }
    seed = warp_min(seed);
    if (lane == 0) {
      for (int q = 0; q < QS; ++q) shared_min(&s_lim[q], seed);
    }
  }
  __syncthreads();

  // Pass A: the segments of the tiles the running thr cannot rule out.
  for (int base = 0; base < m_tiles; base += kKeepThreads) {
    const int t = base + tid;
    bool near = false;
    if (t < m_tiles) {
      load_box(tb, m_tiles, t, clo, chi);
      near = tile_near<Q>(s_q, s_lim, clo, chi);
    }
    const int count = compact_tiles(near, t, s_wcount, s_list);
    if (warp < count) {
#pragma unroll 1
      for (int i = 0; i < Q; ++i) {
#pragma unroll
        for (int s = 0; s < kQuerySegs; ++s) mine[s] = inf;
        for (int k = warp; k < count; k += kKeepWarps) {
          load_box(cbox, m_sub, s_list[k] * kSegsPerTile + lane, clo, chi);
#pragma unroll
          for (int s = 0; s < kQuerySegs; ++s) {
            const double ub = s_q.ub(i * kQuerySegs + s, clo, chi);
            mine[s] = ub < mine[s] ? ub : mine[s];
          }
        }
        fold_thr(mine, s_lim + i * kQuerySegs);
      }
    }
    __syncthreads();
  }
  if (tid < QS) s_lim[tid] = s_lim[tid] + 1e-5 * (s_lim[tid] + 1.0);
  __syncthreads();

  // Pass B: a candidate tile is kept for a query tile when any of its 32
  // segments (one warp's lanes) passes for any of the query tile's 4
  // segments. Warp i < Q counts and writes query tile i's kept tiles.
  int kept = 0;
  for (int base = 0; base < m_tiles; base += kKeepThreads) {
    const int t = base + tid;
    bool near = false;
    if (t < m_tiles) {
      load_box(tb, m_tiles, t, clo, chi);
      near = tile_near<Q>(s_q, s_lim, clo, chi);
    }
    const int count = compact_tiles(near, t, s_wcount, s_list);
    for (int k = warp; k < count; k += kKeepWarps) {
      load_box(cbox, m_sub, s_list[k] * kSegsPerTile + lane, clo, chi);
      unsigned flags = 0;
#pragma unroll 1
      for (int i = 0; i < Q; ++i) {
        bool keep = false;
#pragma unroll
        for (int s = 0; s < kQuerySegs; ++s) {
          const int q = i * kQuerySegs + s;
          keep |= s_q.lb(q, clo, chi) <= s_lim[q];
        }
        if (__ballot_sync(0xffffffffu, keep) != 0) flags |= 1u << i;
      }
      if (lane == 0) s_flag[k] = (unsigned char)flags;
    }
    __syncthreads();
    if (warp < Q && first_tile + warp < n_tiles) {
      int* row = order + (size_t)(first_tile + warp) * m_tiles;
      for (int k0 = 0; k0 < count; k0 += 32) {
        const int k = k0 + lane;
        const bool keep = k < count && ((s_flag[k] >> warp) & 1u) != 0;
        const unsigned bits = __ballot_sync(0xffffffffu, keep);
        if (keep) row[kept + __popc(bits & ((1u << lane) - 1u))] = s_list[k];
        kept += __popc(bits);
      }
    }
    __syncthreads();
  }
  if (warp < Q && lane == 0 && first_tile + warp < n_tiles) nkept[first_tile + warp] = kept;
}

template <int Q>
cudaError_t launch_keep(const double* tbox, int n_sub, int n_tiles, const double* cbox, int m_sub,
                        const double* tilebox, int m_tiles, int* order, int* nkept, cudaStream_t s) {
  const int cached = m_tiles <= kCachedTiles;
  const size_t smem = cached ? 6 * (size_t)m_tiles * sizeof(double) : 0;
  keep_lists_kernel<Q><<<(n_tiles + Q - 1) / Q, kKeepThreads, smem, s>>>(
      tbox, n_sub, n_tiles, cbox, m_sub, tilebox, m_tiles, cached, order, nkept);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* traj, int n, const void* cand, const unsigned char* mask, int m,
                   double* boxes, int n_tiles, int m_tiles, int* order, int* nkept, void* cand4,
                   cudaStream_t s) {
  if (n < 1 || m < 0 || (long long)n_tiles * 128 < n || (long long)m_tiles * kTileM < m)
    return cudaErrorInvalidValue;
  const int n_sub = n_tiles * kQuerySegs, m_sub = m_tiles * kSegsPerTile;
  double* tbox = boxes;
  double* cbox = tbox + 6 * (size_t)n_sub;
  double* tilebox = cbox + 6 * (size_t)m_sub;
  const int q_blocks = (n_sub + kSegsPerTile - 1) / kSegsPerTile;
  segment_boxes_kernel<T><<<q_blocks + m_tiles, kBoxThreads, 0, s>>>(
      static_cast<const T*>(traj), n, n_sub, q_blocks, static_cast<const T*>(cand), mask, m, m_sub,
      m_tiles, tbox, cbox, tilebox, static_cast<T*>(cand4));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // As many query tiles a block as still leave kFillBlocks blocks.
  if (n_tiles >= kMaxQ * kFillBlocks)
    return launch_keep<kMaxQ>(tbox, n_sub, n_tiles, cbox, m_sub, tilebox, m_tiles, order, nkept, s);
  if (n_tiles >= 2 * kFillBlocks)
    return launch_keep<2>(tbox, n_sub, n_tiles, cbox, m_sub, tilebox, m_tiles, order, nkept, s);
  return launch_keep<1>(tbox, n_sub, n_tiles, cbox, m_sub, tilebox, m_tiles, order, nkept, s);
}

}  // namespace

// traj (n, 3), cand (m, 3) in the working dtype, mask (m,) bytes; boxes
// 6 * (4 * n_tiles + 33 * m_tiles) float64 of scratch (the query segments',
// the candidate segments' and the candidate tiles' boxes); out: order (n_tiles,
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
