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
// Design, three levels of candidate boxes and a warp per query tile:
//   1. segment_boxes_kernel: blocks of 256 threads for 32 segments of 32
//      points (queries, then one block per candidate tile), 8 lanes a
//      segment and a thread four of its points, 8 apart (a load's lanes
//      read runs of 8 consecutive points): a segment's box takes 3
//      rounds of shuffles, where a warp a segment took 5, and a tile's box
//      5 more for its whole block; NaN -> 0 and +-inf -> +-3.4e38 in float64;
//      pad rows replicate the last query; candidates past m or masked out
//      are left out of their box (an empty box is lo = +inf, hi = -inf).
//      Boxes are (6, segments) float64, lo then hi per axis. A candidate
//      block also writes its packed tile (m_tiles, 3, 1024): rows x, y, z,
//      a valid candidate's raw coordinates and +inf in all three for one
//      masked out or past m (validity folded into the coordinates, the
//      contract of nn_tile.cuh); and the tile's own box, the min/max over
//      its 32 segment boxes (empty segments drop out of a min/max by
//      themselves; a tile with no valid candidate keeps the empty box).
//   2. group_boxes_kernel, only where a row has more than 32 candidate
//      tiles: a warp per group of 32 tiles (32,768 candidates), a lane a
//      tile, writes the group's box, the min/max over its tile boxes.
//   3. keep_lists_kernel<S>: S warps for each query tile, 8 warps a block,
//      no block-wide staging; S = 1 unless the launch has too few query
//      tiles to fill the card and a row has several groups, then 2, 4 or 8
//      (keep_split: the most that keeps the launch within 16 warps an SM
//      and gives each warp a group of its own). The lanes of a warp hold 32
//      boxes of one level at a time: groups, then the tiles of one group,
//      then the segments of one tile; each level's bounds against the query
//      tile's 4 segments rule out the next level's boxes before they are
//      read, and the folds are shuffles and ballots (no __syncthreads at
//      S = 1).
//        Pass A, thr[q] = min over candidate segments of ub(q, segment):
//      thr starts as the minimum over groups of ub(q, group) (at one group,
//      +inf); the warp visits its groups nearest first while one has
//      lb(q, group) < thr[q] for some q; a visit reads the group's 32 tile
//      boxes, folds their ub into thr, and then reads the segment boxes of
//      up to 2 of the tiles with lb(q, tile) < thr[q] for some q at once
//      (the lowest first), folds the segments' ub, and tests the tiles
//      again, until none is left. With S > 1 warps a query tile, warp j
//      takes the groups g = j mod S, and the warps fold their thr into the
//      shared one after each group (an integer atomicMin: the bounds are
//      non-negative doubles or +inf, which order as their bit patterns),
//      each taking what the others found so far; one barrier ends pass A.
//        Pass B, keep = lb(q, segment) <= thr[q] + 1e-5 (thr[q] + 1): the
//      groups in ascending order with lb(q, group) <= that bound, their
//      tiles likewise, and the segments of up to 2 such tiles at once; a
//      tile is kept when a ballot over its 32 segments finds one that
//      passes for some q. The kept tiles of a group form one 32-bit word,
//      written at S = 1 straight to order[i, :nkept[i]] in ascending order
//      (a prefix over the word's bits, no sort); at S > 1 the words of 32
//      groups at a time go to shared memory, and after a barrier warp 0 of
//      the query tile writes them in order. When some thr[q] is +inf (every
//      candidate of the row masked), every segment passes for that q, and
//      every tile is written without a box being read. Entries past
//      nkept[i] are not written; neither NN kernel reads them.
//      The tile bounds of the last group visited in pass A stay in shared
//      memory (a lane's own column), so pass B does not read that group's
//      tile boxes again.
//
// Why it is exact. A group box contains its tiles' boxes and a tile box its
// non-empty segments' boxes, so per axis the gap to a query box is no larger
// and the span no smaller; subtraction, max, the squares of non-negative
// numbers and the sums are monotone under round-to-nearest, and every level
// uses the same expressions in the same order, so in floating point
//     lb(q, group) <= lb(q, tile) <= lb(q, segment)
//                  <= ub(q, segment) <= ub(q, tile) <= ub(q, group).
// Every value folded into thr is therefore at least the true minimum T (a
// group's or tile's ub bounds a segment's), and the segment that attains T
// is always read: its tile and group have lb <= T <= thr, and a box is left
// out of pass A only when lb >= thr, where none of its segments can lower thr
// below its value of that moment. A minimum does not depend on the order, so
// thr ends as the plain version's double. A box left out of pass B has
// lb > bound, and so does every segment in it. An empty box gives
// lb = ub = +inf (never NaN: the differences are +-inf, never inf - inf).
//
// What bounds it on this card: its floor is the bytes (the coordinates
// read once, the packed candidates and the lists written once); what holds
// it above that at the main path's shapes is latency. The boxes a query
// tile reads are few (the groups, one group's tiles, the segments of the
// few tiles near it), from L2, so a warp's time is a short chain of
// dependent L2 round trips and the bounds between them; the level of
// groups keeps the chain short at any number of candidate tiles, where a
// block of query tiles once swept every candidate tile three times.
// Where a launch has few query tiles and a row many groups, one warp a
// query tile leaves most of the card idle, and a row whose every tile is
// kept (shuffled candidates) is a long serial walk for it: S warps split it.
// (PERF.md §6, on an H100 at 700 W: both launches 0.022 ms at the fleet
// against a 0.0034 ms bytes bound, 0.114 at phase 10's operands against
// 0.046; the list kernel at 700 x 524,288 shuffled 0.062 ms at S = 8, 0.43
// at S = 1, tools/keep_launch_compare.py.)
//
// Batch grid: a batch of B sequences (the JAX package's vmap: each row its
// own queries, candidates and mask) is the y dimension of every launch. A
// block offsets every pointer by its row (coordinates, mask, its row's
// slice of the box scratch, lists and packed tiles) and does the work of
// the single-row kernel on them, so a query tile lists and tests only its
// own row's candidate tiles, and each row's lists and packed candidates
// equal those of a call on that row alone, bit for bit (the lists do not
// depend on S). S is chosen from the B * n_tiles query tiles of the
// launch; a block's query tiles never span two rows.
#include "common.cuh"

namespace {

constexpr int kSub = 32;                      // points per segment
constexpr int kTileM = 1024;                  // candidates per candidate tile
constexpr int kSegsPerTile = kTileM / kSub;
constexpr int kQuerySegs = 128 / kSub;        // query segments per query tile
constexpr int kBoxThreads = 256;              // a block of the box step: 32 segments, a candidate tile
constexpr int kBoxPoints = kTileM / kBoxThreads;  // points a thread, one segment's
constexpr int kSegLanes = kSub / kBoxPoints;      // lanes a segment
constexpr int kGroupTiles = 32;               // candidate tiles a group: a lane each
constexpr int kKeepThreads = 256;
constexpr int kKeepWarps = kKeepThreads / 32;
constexpr int kMaxSplit = 8;                  // warps a query tile, at most
constexpr long long kFillWarps = 16 * 132;    // 16 of the 64 warps an SM holds, on the H100's 132 SMs
constexpr int kBatch = 2;                     // tiles whose segment boxes a warp reads at once
constexpr double kBig = 3.4e38;               // where +-inf is clamped for the bounds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double sanitise(double v) {
  if (isnan(v)) return 0.0;
  if (isinf(v)) return v > 0 ? kBig : -kBig;
  return v;
}

__device__ __forceinline__ double dmin(double a, double b) { return a < b ? a : b; }
__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }

// A row's slice of the box scratch: the query segments', the candidate
// segments', the candidate tiles' and the groups' boxes, (6, count) each.
__host__ __device__ __forceinline__ size_t box_stride(int n_sub, int m_sub, int m_tiles, int groups) {
  return 6 * ((size_t)n_sub + m_sub + m_tiles + groups);
}

// The box over each aligned run of 2 * kLast lanes (offsets kFirst to
// kLast), folded into the lanes' boxes that cover kFirst lanes each; left
// in every lane of the run.
template <int kFirst, int kLast>
__device__ __forceinline__ void lanes_box(double* lo, double* hi) {
#pragma unroll
  for (int s = kFirst; s <= kLast; s <<= 1) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const double a = __shfl_xor_sync(kFull, lo[d], s);
      const double b = __shfl_xor_sync(kFull, hi[d], s);
      lo[d] = a < lo[d] ? a : lo[d];
      hi[d] = b > hi[d] ? b : hi[d];
    }
  }
}

// Box k of a (6, count) array; the empty box for k outside [0, count).
__device__ __forceinline__ void load_box(const double* __restrict__ box, int count, int k,
                                         double* lo, double* hi) {
  const double inf = Limits<double>::inf();
  const bool in = (unsigned)k < (unsigned)count;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = in ? box[(size_t)d * count + k] : inf;
    hi[d] = in ? box[(size_t)(3 + d) * count + k] : -inf;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBoxThreads)
segment_boxes_kernel(const T* __restrict__ traj, int n, int n_sub, int q_blocks,
                     const T* __restrict__ cand, const unsigned char* __restrict__ mask, int m,
                     int m_sub, int m_tiles, int groups, double* __restrict__ tbox,
                     double* __restrict__ cbox, double* __restrict__ tilebox, T* __restrict__ cand3) {
  __shared__ double s_box[6][kBoxThreads / 32];
  const size_t batch_row = blockIdx.y, stride = box_stride(n_sub, m_sub, m_tiles, groups);
  traj += batch_row * 3 * n, cand += batch_row * 3 * m, mask += batch_row * m;
  tbox += batch_row * stride, cbox += batch_row * stride, tilebox += batch_row * stride;
  cand3 += batch_row * (size_t)m_tiles * 3 * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool query = (int)blockIdx.x < q_blocks;  // uniform across the block
  const int tile = (int)blockIdx.x - q_blocks;    // of a candidate block
  const int seg = (query ? (int)blockIdx.x : tile) * kSegsPerTile + (int)threadIdx.x / kSegLanes;
  // Point j of the thread: p0 + kSegLanes j, so that the lanes of one load
  // read runs of 8 consecutive points.
  const long long p0 = (long long)seg * kSub + threadIdx.x % kSegLanes;
  const double inf = Limits<double>::inf();
  double lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  if (query) {
#pragma unroll
    for (int j = 0; j < kBoxPoints; ++j) {
      const long long q = p0 + kSegLanes * j < n ? p0 + kSegLanes * j : n - 1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const double v = sanitise((double)traj[3 * q + d]);
        lo[d] = v < lo[d] ? v : lo[d];
        hi[d] = v > hi[d] ? v : hi[d];
      }
    }
  } else {
    T* packed = cand3 + (size_t)tile * 3 * kTileM + p0 % kTileM;
#pragma unroll
    for (int j = 0; j < kBoxPoints; ++j) {
      const long long p = p0 + kSegLanes * j;
      const bool valid = p < m && mask[p] != 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const T raw = valid ? cand[3 * p + d] : Limits<T>::inf();
        packed[(size_t)d * kTileM + kSegLanes * j] = raw;
        const double v = sanitise((double)raw);
        lo[d] = valid && v < lo[d] ? v : lo[d];
        hi[d] = valid && v > hi[d] ? v : hi[d];
      }
    }
  }
  lanes_box<1, kSegLanes / 2>(lo, hi);  // the segment's box, in its 8 lanes
  if (threadIdx.x % kSegLanes == 0 && (!query || seg < n_sub)) {
    double* box = query ? tbox : cbox;
    const int count = query ? n_sub : m_sub;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      box[(size_t)d * count + seg] = lo[d];
      box[(size_t)(3 + d) * count + seg] = hi[d];
    }
  }
  if (query) return;  // query blocks meet no barrier
  lanes_box<kSegLanes, 16>(lo, hi);  // the warp's 4 segments
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_box[d][warp] = lo[d];
      s_box[3 + d][warp] = hi[d];
    }
  }
  __syncthreads();
  if (warp == 0) {  // the tile's box: a lane a warp's box
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = lane < kBoxThreads / 32 ? s_box[d][lane] : inf;
      hi[d] = lane < kBoxThreads / 32 ? s_box[3 + d][lane] : -inf;
    }
    lanes_box<1, kBoxThreads / 64>(lo, hi);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        tilebox[(size_t)d * m_tiles + tile] = lo[d];
        tilebox[(size_t)(3 + d) * m_tiles + tile] = hi[d];
      }
    }
  }
}

// A group's box from its tiles' boxes: a warp a group, a lane a tile.
__global__ void __launch_bounds__(kKeepThreads)
group_boxes_kernel(int n_sub, int m_sub, int m_tiles, int groups, double* __restrict__ boxes) {
  const size_t stride = box_stride(n_sub, m_sub, m_tiles, groups);
  const double* __restrict__ tilebox = boxes + blockIdx.y * stride + 6 * ((size_t)n_sub + m_sub);
  double* __restrict__ groupbox = boxes + blockIdx.y * stride + 6 * ((size_t)n_sub + m_sub + m_tiles);
  const int lane = threadIdx.x & 31;
  const int g = (int)blockIdx.x * kKeepWarps + (int)(threadIdx.x >> 5);
  if (g >= groups) return;
  double lo[3], hi[3];
  load_box(tilebox, m_tiles, g * kGroupTiles + lane, lo, hi);
  lanes_box<1, 16>(lo, hi);
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      groupbox[(size_t)d * groups + g] = lo[d];
      groupbox[(size_t)(3 + d) * groups + g] = hi[d];
    }
  }
}

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

// The minimum over the warp's lanes, in every lane.
__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dmin(__shfl_xor_sync(kFull, v, o), v);
  return v;
}

// The warp's query tile: its 4 segment boxes, (6, 4) in shared memory.
struct QueryTile {
  const double (*v)[kQuerySegs];
  __device__ __forceinline__ void get(int s, double* lo, double* hi) const {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = v[d][s];
      hi[d] = v[3 + d][s];
    }
  }
  __device__ __forceinline__ double lb(int s, const double* clo, const double* chi) const {
    double lo[3], hi[3];
    get(s, lo, hi);
    return lower_bound(lo, hi, clo, chi);
  }
};

// The lowest (at most kBatch) set bits of *bits, taken out of it: tk[k] a
// bit's index or -1.
__device__ __forceinline__ void take_batch(unsigned* bits, int* tk) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    tk[k] = *bits ? __ffs(*bits) - 1 : -1;
    *bits &= *bits - 1u;
  }
}

// The segment boxes (lane = segment) of the tiles g * 32 + tk[k]; the
// empty box (lb = ub = +inf) for tk[k] = -1.
__device__ __forceinline__ void load_segments(const double* __restrict__ cbox, int m_sub, int g,
                                              const int* tk, double (*lo)[3], double (*hi)[3]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kBatch; ++k)
    load_box(cbox, tk[k] >= 0 ? m_sub : 0, (g * kGroupTiles + tk[k]) * kSegsPerTile + lane, lo[k], hi[k]);
}

// A lane's bounds of the query segments against its box, (4, 32) per warp
// in shared memory (each lane reads only its own column).
using LaneBounds = double (*)[32];

// lbg[q][lane] = lb(q, group g) for a group of this warp (part of S); +inf
// for one that is not (or past the last); 0 for the only group of a row,
// which has no box.
template <int S>
__device__ __forceinline__ void group_lb(const QueryTile& qt, const double* __restrict__ groupbox,
                                         int groups, int g, int part, LaneBounds lbg) {
  const int lane = threadIdx.x & 31;
  const bool mine = g < groups && g % S == part;
  double lo[3], hi[3];
  load_box(groupbox, mine && groups > 1 ? groups : 0, g, lo, hi);
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s)
    lbg[s][lane] = !mine ? Limits<double>::inf() : groups == 1 ? 0.0 : qt.lb(s, lo, hi);
}

// Pass A's visit of group g: its tiles' ub folded into thr, their lb left
// in lbt (a lane a tile), then the segments of the tiles that may still
// lower thr, kBatch tiles at a time, the lowest first.
__device__ __forceinline__ void fold_group(const QueryTile& qt, const double* __restrict__ tilebox,
                                           int m_tiles, const double* __restrict__ cbox, int m_sub, int g,
                                           double* thr, LaneBounds lbt) {
  const int lane = threadIdx.x & 31;
  {
    double clo[3], chi[3];
    load_box(tilebox, m_tiles, g * kGroupTiles + lane, clo, chi);
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) {
      double lo[3], hi[3];
      qt.get(s, lo, hi);
      lbt[s][lane] = lower_bound(lo, hi, clo, chi);
      thr[s] = dmin(thr[s], warp_min(upper_bound(lo, hi, clo, chi)));
    }
  }
  unsigned seen = 0;
  for (;;) {
    bool want = false;
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) want |= lbt[s][lane] < thr[s];
    unsigned near = __ballot_sync(kFull, want) & ~seen;
    if (!near) break;
    seen |= near;
    int tk[kBatch];
    take_batch(&near, tk);
    seen &= ~near;  // the tiles beyond this batch stay to be tested again
    double clo[kBatch][3], chi[kBatch][3];
    load_segments(cbox, m_sub, g, tk, clo, chi);
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) {
      double lo[3], hi[3];
      qt.get(s, lo, hi);
      double best = Limits<double>::inf();
#pragma unroll
      for (int k = 0; k < kBatch; ++k) best = dmin(best, upper_bound(lo, hi, clo[k], chi[k]));
      thr[s] = dmin(thr[s], warp_min(best));
    }
  }
}

// Pass B's visit of group g: the word of its kept tiles (bit t for tile
// g * 32 + t). The tiles' lb are read again unless g was pass A's last
// group (`cached`).
__device__ __forceinline__ unsigned kept_tiles(const QueryTile& qt, const double* __restrict__ tilebox,
                                               int m_tiles, const double* __restrict__ cbox, int m_sub,
                                               int g, const double* bound, int* cached, LaneBounds lbt) {
  const int lane = threadIdx.x & 31;
  if (g != *cached) {
    double clo[3], chi[3];
    load_box(tilebox, m_tiles, g * kGroupTiles + lane, clo, chi);
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) lbt[s][lane] = qt.lb(s, clo, chi);
    *cached = g;
  }
  bool want = false;
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) want |= lbt[s][lane] <= bound[s];
  unsigned near = __ballot_sync(kFull, want), word = 0;
  while (near) {
    int tk[kBatch];
    take_batch(&near, tk);
    double clo[kBatch][3], chi[kBatch][3];
    load_segments(cbox, m_sub, g, tk, clo, chi);
    bool hit[kBatch] = {};
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) {
      double lo[3], hi[3];
      qt.get(s, lo, hi);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) hit[k] |= lower_bound(lo, hi, clo[k], chi[k]) <= bound[s];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (tk[k] >= 0 && __ballot_sync(kFull, hit[k])) word |= 1u << tk[k];
    }
  }
  return word;
}

// Writes the kept tiles of `word` (group g) at out[kept...], ascending.
__device__ __forceinline__ void emit(int* __restrict__ out, unsigned word, int g, int* kept) {
  const int lane = threadIdx.x & 31;
  if ((word >> lane) & 1u) out[*kept + __popc(word & ((1u << lane) - 1u))] = g * kGroupTiles + lane;
  *kept += __popc(word);
}

// Folds this warp's thr into its query tile's shared thr (S > 1) and takes
// what the other warps have found.
__device__ __forceinline__ void share_thr(double* thr, unsigned long long* s_thr) {
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) {
    unsigned long long old = 0;
    if ((threadIdx.x & 31) == 0) old = atomicMin(&s_thr[s], (unsigned long long)__double_as_longlong(thr[s]));
    thr[s] = dmin(thr[s], __longlong_as_double((long long)__shfl_sync(kFull, old, 0)));
  }
}

// The warps a query tile for a launch of `query_tiles` query tiles (every
// row's) against rows of `groups` groups.
int keep_split(long long query_tiles, int groups) {
  int split = 1;
  for (int s = 2; s <= kMaxSplit; s <<= 1)
    if (s <= groups && query_tiles * s <= kFillWarps) split = s;
  return split;
}

template <int S>
__global__ void __launch_bounds__(kKeepThreads, 2)
keep_lists_kernel(const double* __restrict__ boxes, int n_sub, int n_tiles, int m_sub, int m_tiles,
                  int groups, int* __restrict__ order, int* __restrict__ nkept) {
  constexpr int QT = kKeepWarps / S;  // query tiles a block
  __shared__ double s_q[kKeepWarps][6][kQuerySegs];
  __shared__ double s_lbg[kKeepWarps][kQuerySegs][32];  // a lane's group bounds
  __shared__ double s_lbt[kKeepWarps][kQuerySegs][32];  // a lane's tile bounds in group `cached`
  __shared__ unsigned long long s_thr[QT][kQuerySegs];  // S > 1: the query tile's thr, as bits
  __shared__ unsigned s_words[QT][32];                  // S > 1: 32 groups' words of kept tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / S, part = warp % S;
  const int qtile = (int)blockIdx.x * QT + slot;
  const bool writes = qtile < n_tiles;
  if (S == 1 && !writes) return;  // no barrier at S = 1
  // Past the last query tile (S > 1 only) a warp repeats the last one, so
  // that it meets every barrier, and writes nothing.
  const int qi = writes ? qtile : n_tiles - 1;
  const size_t stride = box_stride(n_sub, m_sub, m_tiles, groups);
  const double* __restrict__ tbox = boxes + blockIdx.y * stride;
  const double* __restrict__ cbox = tbox + 6 * (size_t)n_sub;
  const double* __restrict__ tilebox = cbox + 6 * (size_t)m_sub;
  const double* __restrict__ groupbox = tilebox + 6 * (size_t)m_tiles;
  int* __restrict__ out = order + (blockIdx.y * (size_t)n_tiles + qi) * m_tiles;
  const double inf = Limits<double>::inf();

  if (lane < 6 * kQuerySegs)
    s_q[warp][lane / kQuerySegs][lane % kQuerySegs] =
        tbox[(size_t)(lane / kQuerySegs) * n_sub + qi * kQuerySegs + lane % kQuerySegs];
  if (S > 1) {
    if ((int)threadIdx.x < QT * kQuerySegs)
      s_thr[threadIdx.x / kQuerySegs][threadIdx.x % kQuerySegs] = (unsigned long long)__double_as_longlong(inf);
    __syncthreads();
  } else {
    __syncwarp();
  }
  const QueryTile qt{s_q[warp]};
  const LaneBounds lbg = s_lbg[warp], lbt = s_lbt[warp];

  // Pass A. The seed: min over groups of ub(q, group), every group (each
  // warp of a query tile takes the same seed).
  double thr[kQuerySegs];
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) thr[s] = inf;
  if (groups > 1) {
    for (int g = lane; g < groups; g += 32) {
      double clo[3], chi[3];
      load_box(groupbox, groups, g, clo, chi);
#pragma unroll
      for (int s = 0; s < kQuerySegs; ++s) {
        double lo[3], hi[3];
        qt.get(s, lo, hi);
        thr[s] = dmin(thr[s], upper_bound(lo, hi, clo, chi));
      }
    }
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) thr[s] = warp_min(thr[s]);
  }
  int cached = -1;  // the group whose tile bounds lbt holds
  for (int g0 = 0; g0 < groups; g0 += 32) {
    group_lb<S>(qt, groupbox, groups, g0 + lane, part, lbg);
    unsigned done = 0;
    for (;;) {  // this warp's groups that may lower thr, nearest first
      bool want = false;
      double key = inf;
#pragma unroll
      for (int s = 0; s < kQuerySegs; ++s) {
        want |= lbg[s][lane] < thr[s];
        key = dmin(key, lbg[s][lane]);
      }
      const unsigned cand = __ballot_sync(kFull, want) & ~done;
      if (!cand) break;
      const double mine = (cand >> lane) & 1u ? key : inf;
      const double nearest = warp_min(mine);
      const int pick = __ffs(__ballot_sync(kFull, ((cand >> lane) & 1u) && mine == nearest)) - 1;
      done |= 1u << pick;
      cached = g0 + pick;
      fold_group(qt, tilebox, m_tiles, cbox, m_sub, cached, thr, lbt);
      if (S > 1) share_thr(thr, s_thr[slot]);
    }
  }
  if (S > 1) {
    share_thr(thr, s_thr[slot]);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kQuerySegs; ++s) thr[s] = __longlong_as_double((long long)s_thr[slot][s]);
  }

  // Pass B.
  double bound[kQuerySegs];
  bool every = false;  // some thr[q] = +inf: every segment passes for that q
#pragma unroll
  for (int s = 0; s < kQuerySegs; ++s) {
    bound[s] = thr[s] + 1e-5 * (thr[s] + 1.0);
    every |= isinf(bound[s]);
  }
  int kept = 0;
  // At S > 1 every warp of the block meets each chunk's two barriers (the
  // query tiles of a block may differ in `every`).
  for (int g0 = 0; g0 < groups && (S > 1 || !every); g0 += 32) {
    unsigned lane_word = 0;  // S > 1: the word of group g0 + lane
    if (!every) {
      group_lb<S>(qt, groupbox, groups, g0 + lane, part, lbg);
      bool want = false;
#pragma unroll
      for (int s = 0; s < kQuerySegs; ++s) want |= lbg[s][lane] <= bound[s];
      for (unsigned near = __ballot_sync(kFull, want); near; near &= near - 1u) {
        const int g = g0 + __ffs(near) - 1;
        const unsigned word = kept_tiles(qt, tilebox, m_tiles, cbox, m_sub, g, bound, &cached, lbt);
        if (S == 1) emit(out, word, g, &kept);
        else if (lane == g - g0) lane_word = word;
      }
    }
    if (S > 1) {
      if (g0 + lane < groups && (g0 + lane) % S == part) s_words[slot][lane] = lane_word;
      __syncthreads();
      if (part == 0 && !every) {  // a lane a word: an exclusive prefix of their counts
        const unsigned word = g0 + lane < groups ? s_words[slot][lane] : 0u;
        const int count = __popc(word);
        int upto = count;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, upto, o);
          if (lane >= o) upto += v;
        }
        int at = kept + upto - count;
        if (writes)
          for (unsigned w = word; w; w &= w - 1u) out[at++] = (g0 + lane) * kGroupTiles + __ffs(w) - 1;
        kept += __shfl_sync(kFull, upto, 31);
      }
      __syncthreads();
    }
  }
  if (part != 0 || !writes) return;
  if (every) {
    for (int t = lane; t < m_tiles; t += 32) out[t] = t;
    kept = m_tiles;
  }
  if (lane == 0) nkept[blockIdx.y * (size_t)n_tiles + qi] = kept;
}

template <int S>
cudaError_t launch_keep(int batch, const double* boxes, int n_sub, int n_tiles, int m_sub, int m_tiles,
                        int groups, int* order, int* nkept, cudaStream_t s) {
  const dim3 grid((unsigned)((n_tiles + kKeepWarps / S - 1) / (kKeepWarps / S)), (unsigned)batch);
  keep_lists_kernel<S><<<grid, kKeepThreads, 0, s>>>(boxes, n_sub, n_tiles, m_sub, m_tiles, groups, order,
                                                      nkept);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int batch, const void* traj, int n, const void* cand, const unsigned char* mask,
                   int m, double* boxes, int n_tiles, int m_tiles, int* order, int* nkept, void* cand3,
                   cudaStream_t s) {
  if (n < 1 || m < 0 || (long long)n_tiles * 128 < n || (long long)m_tiles * kTileM < m ||
      batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  const int n_sub = n_tiles * kQuerySegs, m_sub = m_tiles * kSegsPerTile;
  const int groups = (m_tiles + kGroupTiles - 1) / kGroupTiles;
  double* tbox = boxes;
  double* cbox = tbox + 6 * (size_t)n_sub;
  double* tilebox = cbox + 6 * (size_t)m_sub;
  const int q_blocks = (n_sub + kSegsPerTile - 1) / kSegsPerTile;
  segment_boxes_kernel<T><<<dim3((unsigned)(q_blocks + m_tiles), (unsigned)batch), kBoxThreads, 0, s>>>(
      static_cast<const T*>(traj), n, n_sub, q_blocks, static_cast<const T*>(cand), mask, m, m_sub,
      m_tiles, groups, tbox, cbox, tilebox, static_cast<T*>(cand3));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (groups > 1) {
    group_boxes_kernel<<<dim3((unsigned)((groups + kKeepWarps - 1) / kKeepWarps), (unsigned)batch),
                         kKeepThreads, 0, s>>>(n_sub, m_sub, m_tiles, groups, boxes);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  switch (keep_split((long long)batch * n_tiles, groups)) {
    case 1: return launch_keep<1>(batch, boxes, n_sub, n_tiles, m_sub, m_tiles, groups, order, nkept, s);
    case 2: return launch_keep<2>(batch, boxes, n_sub, n_tiles, m_sub, m_tiles, groups, order, nkept, s);
    case 4: return launch_keep<4>(batch, boxes, n_sub, n_tiles, m_sub, m_tiles, groups, order, nkept, s);
    default: return launch_keep<8>(batch, boxes, n_sub, n_tiles, m_sub, m_tiles, groups, order, nkept, s);
  }
}

}  // namespace

// Per row of a batch of `batch` rows, rows contiguous one after another:
// traj (n, 3), cand (m, 3) in the working dtype, mask (m,) bytes; boxes
// 6 * (4 * n_tiles + 33 * m_tiles + ceil(m_tiles / 32)) float64 of scratch
// (the query segments', the candidate segments', the candidate tiles' and
// the groups' boxes); out: order (n_tiles, m_tiles) and nkept (n_tiles,)
// int32, cand3 (m_tiles, 3, 1024) in the working dtype, +inf coordinates
// for a masked or padded candidate. Returns a cudaError_t.
GPS_EXPORT int gps_nn_keep(int dtype, int batch, const void* traj, int n, const void* cand,
                           const unsigned char* mask, int m, double* boxes, int n_tiles,
                           int m_tiles, int* order, int* nkept, void* cand3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)launch<float>(batch, traj, n, cand, mask, m, boxes, n_tiles, m_tiles, order, nkept, cand3, s);
  if (dtype == GPS_F64)
    return (int)launch<double>(batch, traj, n, cand, mask, m, boxes, n_tiles, m_tiles, order, nkept, cand3, s);
  return (int)cudaErrorInvalidValue;
}

// The warps a query tile that gps_nn_keep's list kernel takes for a batch
// of `batch` rows of n_tiles query tiles and m_tiles candidate tiles.
GPS_EXPORT int gps_nn_keep_split(int batch, int n_tiles, int m_tiles) {
  return keep_split((long long)batch * n_tiles, (m_tiles + kGroupTiles - 1) / kGroupTiles);
}
