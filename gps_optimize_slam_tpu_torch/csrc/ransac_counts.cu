// K5: Sim(3) RANSAC consensus counts. For every trial t,
//   count[t] = #{ i : valid_i and |s_t R_t p_i + t_t - d_i|^2 < thr2 },
// where the residual is rounded as the plain version rounds it (ops/ransac.py,
// kernels.ransac_counts_plain): q_j = (p0 R_j0 + p1 R_j1) + p2 R_j2,
// e_j = (s q_j + t_j) - d_j, res2 = (e0^2 + e1^2) + e2^2, each operation
// rounded on its own (--fmad=false). The counts equal the plain version's.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_kernels.py:
// ransac_counts (_ransac_count_kernel), and its vmap for a batch. The TPU
// kernel puts the residual on the MXU as a centred 18-term quadratic form,
// whose rounding flips counts near the threshold; the caller re-ranks its
// top 16 for that reason, and still does.
//
// What bounds it on this card: instruction issue, one (trial, point) pair at
// a time; the bytes are the points and trials read once. The work the output
// needs is the pairs of VALID points only, and the caller's mask (the Sim(3)
// window: the first gap-free run of GNSS-valid poses, at most 180 s) keeps a
// few thousand points of a row that may hold half a million.
//
// Design.
// 1. Work in proportion to the valid points. A row is cut into chunks of
//    a block's points (P a thread). A long launch (the wrapper's P = 4,
//    blocks of 256 threads) takes the LISTED walk: a prologue kernel (chunk_list_kernel, one warp
//    a chunk) lists every (row, chunk) that holds a valid point, appending
//    with an atomic counter; the list's length stays on the device. The
//    count kernel's blocks, as many as the card holds at once, draw items
//    (list entry, group of trials) from a ticket counter until a ticket
//    passes the length, as K4 does (nn_grid.cu). A short launch (P = 2, at
//    most 65,536 points: one row of the main path) would pay more for the
//    prologue launch and the scratch's memset than the list saves, so it
//    takes the GRID of every chunk: block b takes item b, and a block
//    whose chunk holds no valid point stops after its loads
//    (__syncthreads_or over the mask). Such a launch is latency-bound (its
//    blocks all start at once), so its blocks are 128 threads: twice the
//    blocks of 256 and fewer warps on the busiest SM, 0.0107 ms against
//    0.0120 for one 4,661-point row (PERF.md). Within a chunk each warp owns 32 P
//    consecutive points and skips the trial walk when none is valid. A
//    masked point (which the kernel never reads) is held as p = 0,
//    d = -inf: its residual is +inf on both paths below, never a hit.
//    Integer sums are exact in any order, so the list's order (set by the
//    atomics) never changes a count, and the counts repeat run to run.
// 2. Fewer instructions a pair, the counts still exact. A thread holds P
//    points in registers; a block stages its trials in shared memory as
//    records of 16 values: a = s R (9, rounded once), t (3), lo, hi, an
//    unsafe flag and one spare. Each pair's FAST residual contracts by hand
//    (the library keeps --fmad=false; fmaf/fma as in nn_tile.cuh):
//        e'_j  = fma(a_j0, p0, fma(a_j1, p1, fma(a_j2, p2, t_j - d_j)))
//        res2' = fma(e'0, e'0, fma(e'1, e'1, e'2 * e'2))
//    15 floating-point instructions against the plain order's 29. A pair with
//    res2' < lo is a hit and one with res2' >= hi a miss, CERTIFIED (below);
//    a pair in between is recounted in the plain order. A thread counts its
//    pairs below lo and below hi (two compares and two adds a pair) and,
//    where the two differ, sets the trial's bit in a mask; the walk of a
//    group of 32 trials holds no branch, so the compiler overlaps the
//    chains of the trials it unrolls. After the walk the warp ORs its masks
//    (__reduce_or_sync) and recounts the open pairs of the marked trials
//    only, trial by trial (warp-uniform), so the rare slow path costs only
//    the warps that meet one. The trial walk issues about 25 instructions a
//    pair at P = 4 (its SASS: the 15 above, 2 compares, 2 adds, the mask's
//    bit, a quarter of the record's loads, warp sum and the loop); the
//    one-point-a-thread design before it issued about 38 (29 uncontracted
//    operations, four record loads, a warp sum, a compare and the loop).
// 3. Amortised costs. One record load and one warp sum (__reduce_add_sync)
//    serve P pairs a thread. A block takes up to 4 groups of 32 trials (lane
//    u of a warp keeps the sum of trial u of each group): the most groups
//    that still leave an item for every resident block, from the list's
//    length read on the device (listed) or from every chunk (grid, on the
//    host), so one block's point loads, band and barriers serve up to 128
//    trials. The trials' loads go out with the points'. On the listed walk
//    thread 0 draws the next item's ticket and reads its list entry while
//    the present item runs. P = 4 on the listed walk and P = 2 on the grid
//    are the wrapper's choice from the card's times at the fleet, its
//    window masks, one 4,661-point row and phase 10's rows (PERF.md); both
//    give the same counts.
//
// The certified band (derivation). u = 2^-24 (float) or 2^-53 (double),
// gamma_k = k u / (1 - k u), eta the smallest positive subnormal of T (an
// absolute bound on one operation's underflow error). For a pair let
//     M_j = |s| (|R_j0| P_0 + |R_j1| P_1 + |R_j2| P_2) + |t_j| + D_j,
// with P_k, D_j the largest |p_k|, |d_j| over the block's valid points, and
// E_j = s (R_j . p) + t_j - d_j exactly. The plain e_j rounds each of the
// terms s R_jk p_k, t_j, d_j at most 6 times (product, two sums, times s,
// plus t, minus d), so |e_j - E_j| <= gamma_6 M_j + 6 eta (1 + gamma_6); the
// fast e'_j rounds each at most 4 times (a = s R, and three fmas; t - d once
// and three fmas), so |e'_j - E_j| <= gamma_4 M_j + 4 eta (1 + gamma_4).
// Hence |e' - e|_2 <= |e' - e|_1 <= delta = sum_j (gamma_10 M_j + 16 eta)
// (the 1-norm: no square root a trial). Each sum of
// three squares, plain or contracted, rounds every square at most 3 times:
// with S = sum e_j^2 and S' = sum e'_j^2,
//     (1 - gamma_3) S - 4 eta <= res2 <= (1 + gamma_3) S + 4 eta,
// and the same for res2' and S'. Since |sqrt(S) - sqrt(S')| <= delta:
//   res2' < lo = (1 - gamma_3) r_lo^2 - 4 eta,
//       r_lo = sqrt((thr2 - 4 eta) / (1 + gamma_3)) - delta  (r_lo > 0)
//     gives sqrt(S') < r_lo, sqrt(S) < r_lo + delta, res2 < thr2: a hit;
//   res2' >= hi = (1 + gamma_3) r_hi^2 + 4 eta,
//       r_hi = sqrt((thr2 + 4 eta) / (1 - gamma_3)) + delta
//     gives sqrt(S') >= r_hi, sqrt(S) >= r_hi - delta, res2 >= thr2: a miss.
// lo and hi are computed in double with every operation rounded toward the
// safe side (__dadd_rd, __dmul_ru, ...) and rounded to T the same way
// (__double2float_rd/_ru); gamma_k is taken as k u (1 + 2^-19) >= gamma_k.
// The two square roots depend on thr2 alone, so the host takes them once a
// launch (band_roots: each operation rounded to nearest and stepped one ulp
// outward, at least as wide as rounding it toward the safe side) and passes
// them with the operands; a (trial, block) costs about 40 rounded operations.
// This holds when no operation overflows and every input is finite; a
// (trial, block) is SAFE when thr2 is finite and positive and M_j,
// sum_k |R_jk| P_k and |s| max |R_jk| are finite and below 2^60 (float) or
// 2^500 (double), which keeps every intermediate of both orders finite. An
// unsafe one (NaN or infinite inputs, huge magnitudes) is flagged in its
// record, with lo = -inf, and every pair of it is recounted in the plain
// order. In a safe one a valid pair's res2' is finite and a masked one's
// +inf, which no compare counts. The band is
// wide where the magnitudes are large beside sqrt(thr2) (float32 at
// kilometres: a few millimetres of delta); that costs recounts, never a
// count.
//
// Batch grid: a batch of B sequences (each its own points and trials, the
// JAX package's vmap of the kernel) shares one list and one launch; an item
// offsets its pointers by its row and does the single-row work, so each
// row's counts equal those of a call on that row alone.
#include <algorithm>
#include <atomic>
#include <cmath>
#include "common.cuh"

namespace {

constexpr int kCountThreads = 256;  // the listed walk's block
constexpr int kGridThreads = 128;   // the grid's block
constexpr int kCountWarps = kCountThreads / 32;
constexpr int kMaxGroups = 4;  // groups of 32 trials a block at most
constexpr int kRecord = 16;    // a trial's record: a[9], t[3], lo, hi, unsafe, spare

// A chunk: P points a thread of a block of `threads`.
__host__ __device__ constexpr int chunk_points(int P, int threads) { return threads * P; }
__host__ __device__ constexpr int block_threads(bool listed) { return listed ? kCountThreads : kGridThreads; }

template <typename T>
struct Band;

template <>
struct Band<float> {
  static constexpr double kUnit = 0x1p-24;
  static constexpr double kEta = 0x1p-149;
  static constexpr double kSafe = 0x1p60;
  __device__ static float down(double x) { return __double2float_rd(x); }
  __device__ static float up(double x) { return __double2float_ru(x); }
  __device__ static float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
};

template <>
struct Band<double> {
  static constexpr double kUnit = 0x1p-53;
  static constexpr double kEta = 0x0.0000000000001p-1022;  // 2^-1074
  static constexpr double kSafe = 0x1p500;
  __device__ static double down(double x) { return x; }
  __device__ static double up(double x) { return x; }
  __device__ static double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
};

// NaN-propagating maximum of non-negative values.
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a != a || a > b) ? a : b; }

// What the band takes from thr2 alone, on the host, into r: 1 + gamma_3
// rounded up, 1 - gamma_3 rounded down, sqrt((thr2 - 4 eta) / (1 +
// gamma_3)) rounded down and sqrt((thr2 + 4 eta) / (1 - gamma_3)) rounded
// up, each operation rounded to nearest and then stepped one ulp outward,
// which is at least as wide as rounding it toward the safe side.
template <typename T>
void band_roots(double thr2, double* r) {
  using B = Band<T>;
  const auto up = [](double x) { return std::nextafter(x, HUGE_VAL); };
  const auto dn = [](double x) { return std::nextafter(x, -HUGE_VAL); };
  const double g3 = 3.0 * B::kUnit * (1.0 + 0x1p-19), eta4 = 4.0 * B::kEta;
  r[0] = up(1.0 + g3);
  r[1] = dn(1.0 - g3);
  r[2] = dn(std::sqrt(dn(dn(thr2 - eta4) / r[0])));
  r[3] = up(std::sqrt(up(up(thr2 + eta4) / r[1])));
}

// The listed walk's scratch (4-byte aligned): the ticket, then the list:
// its length and its entries. The grid of every chunk takes none.
constexpr int kScratchHead = 2 * (int)sizeof(int);

// Lists every (row, chunk) of `chunk` points holding a valid point: one warp
// a chunk; list[0] counts the entries that follow it (zeroed beforehand).
__global__ void chunk_list_kernel(const uint8_t* __restrict__ valid, int n, int chunk, int chunks,
                                  long long entries, int* __restrict__ list) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= entries) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long row = w / chunks;
  const int c = (int)(w % chunks);
  const uint8_t* v = valid + row * n + (long long)c * chunk;
  const int len = min(chunk, n - c * chunk);
  bool any = false;
  for (int i0 = 0; i0 < len && !any; i0 += 32) {
    const int i = i0 + lane;
    any = __any_sync(0xffffffffu, i < len && v[i] != 0);
  }
  if (any && lane == 0) list[1 + atomicAdd(list, 1)] = (int)w;
}

// The record of one trial (R, t, s) for a block whose valid points have the
// largest magnitudes pmax[k] = P_k and dmax[j] = D_j (see the header);
// roots from band_roots.
template <typename T>
__device__ __forceinline__ void stage_trial(const T* Rg, const T* tg, T sg, const T* pmax, const T* dmax,
                                            const double* roots, double thr2, T* rec) {
  using B = Band<T>;
  const double g10 = 10.0 * B::kUnit * (1.0 + 0x1p-19);
  const double eta4 = 4.0 * B::kEta, eta16 = 16.0 * B::kEta;
  const double s_abs = fabs((double)sg);
  bool safe = thr2 > 0.0 && thr2 < B::kSafe;
  double delta = 0.0;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    double q = 0.0, r_max = 0.0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T r = Rg[3 * j + k];
      rec[3 * j + k] = sg * r;
      q = __dadd_ru(q, __dmul_ru(fabs((double)r), (double)pmax[k]));
      r_max = nan_max(r_max, fabs((double)r));
    }
    const T tj = tg[j];
    rec[9 + j] = tj;
    const double m = __dadd_ru(__dadd_ru(__dmul_ru(s_abs, q), fabs((double)tj)), (double)dmax[j]);
    safe = safe && m < B::kSafe && q < B::kSafe && __dmul_ru(s_abs, r_max) < B::kSafe;
    delta = __dadd_ru(delta, __dadd_ru(__dmul_ru(g10, m), eta16));
  }
  const double one_up = roots[0], one_dn = roots[1];
  const double r_lo = __dadd_rd(roots[2], -delta);
  const double r_hi = __dadd_ru(roots[3], delta);
  const double lo = r_lo > 0.0 ? __dadd_rd(__dmul_rd(one_dn, __dmul_rd(r_lo, r_lo)), -eta4) : -INFINITY;
  const double hi = __dadd_ru(__dmul_ru(one_up, __dmul_ru(r_hi, r_hi)), eta4);
  rec[12] = safe ? B::down(lo) : -Limits<T>::inf();
  rec[13] = safe ? B::up(hi) : Limits<T>::inf();
  rec[14] = safe ? T(0) : T(1);
  rec[15] = 0;
}

// The plain order of kernels.sim3_residual2 (uncontracted: --fmad=false).
template <typename T>
__device__ __forceinline__ T plain_res2(const T* R, T s, const T* t, const T* p, const T* d) {
  T e[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) e[j] = s * (p[0] * R[3 * j] + p[1] * R[3 * j + 1] + p[2] * R[3 * j + 2]) + t[j] - d[j];
  return e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
}

// The contracted residual of one pair from a trial's record (a = s R, t).
template <typename T>
__device__ __forceinline__ T fast_res2(const T* r, const T* p, const T* d) {
  using B = Band<T>;
  T e[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    e[j] = B::fma_(r[3 * j], p[0], B::fma_(r[3 * j + 1], p[1], B::fma_(r[3 * j + 2], p[2], r[9 + j] - d[j])));
  return B::fma_(e[0], e[0], B::fma_(e[1], e[1], e[2] * e[2]));
}

// A thread's P pairs with the trial whose record is `rec` (shared): h
// counts the contracted residuals below lo (certified hits), below_hi those
// below hi; returns the record's unsafe flag.
template <typename T, int P>
__device__ __forceinline__ bool fast_hits(const T* rec, const T (*p)[3], const T (*d)[3], int& h, int& below_hi) {
  using V = typename Vec16<T>::type;
  constexpr int kVecs = kRecord * (int)sizeof(T) / 16;
  __align__(16) T r[kRecord];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) reinterpret_cast<V*>(r)[k] = reinterpret_cast<const V*>(rec)[k];
  const T lo = r[12], hi = r[13];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const T q = fast_res2<T>(r, p[k], d[k]);
    h += q < lo;
    below_hi += q < hi;
  }
  return r[14] != T(0);
}

// A launch's operands (see gps_ransac_counts), rows contiguous; thr2 in T,
// as the plain version compares.
template <typename T>
struct CountArgs {
  const T* __restrict__ src;
  const T* __restrict__ dst;
  const uint8_t* __restrict__ valid;
  const T* __restrict__ R;
  const T* __restrict__ t;
  const T* __restrict__ s;
  int* __restrict__ out;
  unsigned long long* __restrict__ recounted;
  int n, n_trials;
  T thr2;
  double roots[4];  // band_roots of thr2
};

// A block's shared memory: the staged trials, each warp's largest
// magnitudes and the block's partial counts.
template <typename T>
struct CountSmem {
  __align__(16) T rec[kMaxGroups * 32][kRecord];
  T mag[kCountWarps][6];
  int cnt[kMaxGroups * 32];
};

// One item: the points of chunk c of `row` against trials [trial0,
// trial0 + tc), tc <= per_item. A block whose chunk holds no valid point
// stops after its loads. Barriers inside (block-uniform); every thread
// calls mid() once, after the trials are staged (the listed walk reads its
// next entry there) or, in an empty chunk, after the loads.
template <typename T, int P, int THREADS, class Mid>
__device__ __forceinline__ void count_item(const CountArgs<T>& a, CountSmem<T>& sh, long long row, int c,
                                           int trial0, int tc, int per_item, Mid mid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inf = Limits<T>::inf();
  const int n = a.n;
  const long long gt0 = row * a.n_trials + trial0;
  // Thread u < tc stages trial u: its loads go out with the points'.
  T Rv[9], tv[3], sv = 0;
  if (threadIdx.x < tc) {
    const long long gt = gt0 + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 9; ++k) Rv[k] = a.R[9 * gt + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) tv[k] = a.t[3 * gt + k];
    sv = a.s[gt];
  }
  const int i0 = c * chunk_points(P, THREADS) + warp * 32 * P + lane;
  const T* rs = a.src + row * 3 * n;
  const T* rd = a.dst + row * 3 * n;
  const uint8_t* rv = a.valid + row * n;

  T p[P][3], d[P][3];
  T mx[6] = {0, 0, 0, 0, 0, 0};
  bool mine_valid = false;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    // The coordinates load beside the mask (one round trip, not two) and
    // a masked point's are replaced after.
    const int i = i0 + 32 * k;
    const bool in = i < n;
    const bool ok = in && rv[i] != 0;
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3) {
      const T pv = in ? rs[3 * (long long)i + c3] : T(0);
      const T dv = in ? rd[3 * (long long)i + c3] : T(0);
      p[k][c3] = ok ? pv : T(0);
      d[k][c3] = ok ? dv : -inf;
      if (ok) {
        mx[c3] = nan_max(mx[c3], fabs(p[k][c3]));
        mx[3 + c3] = nan_max(mx[3 + c3], fabs(d[k][c3]));
      }
    }
    mine_valid |= ok;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c6 = 0; c6 < 6; ++c6) mx[c6] = nan_max(mx[c6], __shfl_xor_sync(0xffffffffu, mx[c6], off));
  const bool warp_active = __any_sync(0xffffffffu, mine_valid);
  if (lane == 0)
#pragma unroll
    for (int c6 = 0; c6 < 6; ++c6) sh.mag[warp][c6] = mx[c6];
  if (threadIdx.x < per_item) sh.cnt[threadIdx.x] = 0;
  if (!__syncthreads_or(mine_valid)) {
    mid();
    return;
  }
  if (threadIdx.x < tc) {
    T bm[6] = {0, 0, 0, 0, 0, 0};
    for (int w = 0; w < THREADS / 32; ++w)
#pragma unroll
      for (int c6 = 0; c6 < 6; ++c6) bm[c6] = nan_max(bm[c6], sh.mag[w][c6]);
    stage_trial<T>(Rv, tv, sv, bm, bm + 3, a.roots, (double)a.thr2, sh.rec[threadIdx.x]);
  }
  __syncthreads();
  mid();

  if (warp_active) {
    for (int grp = 0; grp * 32 < tc; ++grp) {
      const int u_end = min(32, tc - grp * 32);
      int mine = 0;             // the warp's hits of trial grp * 32 + lane
      unsigned open_bits = 0;   // bit uu: a pair of this lane open at trial grp * 32 + uu
#pragma unroll 2
      for (int uu = 0; uu < u_end; ++uu) {
        int h = 0, below_hi = 0;
        const bool unsafe = fast_hits<T, P>(sh.rec[grp * 32 + uu], p, d, h, below_hi);
        open_bits |= (unsigned)(below_hi != h || unsafe) << uu;
        const int total = __reduce_add_sync(0xffffffffu, h);
        if (lane == uu) mine = total;
      }
      // The plain order for every pair the band left open, trial by trial
      // (warp-uniform); an open pair added nothing above.
      for (unsigned todo = __reduce_or_sync(0xffffffffu, open_bits); todo != 0; todo &= todo - 1) {
        const int uu = __ffs(todo) - 1;
        const T* r = sh.rec[grp * 32 + uu];
        const long long gt = gt0 + grp * 32 + uu;
        T Rp[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) Rp[k] = a.R[9 * gt + k];
        const T sp = a.s[gt];
        const T lo = r[12], hi = r[13];
        const bool unsafe = r[14] != T(0);
        int add = 0, redone = 0;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const T q = fast_res2<T>(r, p[k], d[k]);
          if (unsafe || (!(q < lo) && q < hi)) {
            add += plain_res2<T>(Rp, sp, r + 9, p[k], d[k]) < a.thr2;
            ++redone;
          }
        }
        const int fix = __reduce_add_sync(0xffffffffu, add);
        if (lane == uu) mine += fix;
        if (a.recounted != nullptr) {
          redone = __reduce_add_sync(0xffffffffu, redone);
          if (lane == 0) atomicAdd(a.recounted, (unsigned long long)redone);
        }
      }
      if (mine != 0) atomicAdd(&sh.cnt[grp * 32 + lane], mine);
    }
  }
  __syncthreads();
  if (threadIdx.x < tc && sh.cnt[threadIdx.x] != 0) atomicAdd(a.out + gt0 + threadIdx.x, sh.cnt[threadIdx.x]);
}

// LISTED = false, the grid of every chunk (a short launch): block b takes
// item b, (chunk b / tchunks, trial group b % tchunks) of `groups` groups
// of 32 trials, the host's choice. LISTED = true, the listed walk (a long
// launch): resident blocks draw items (list entry, trial groups) from the
// ticket, the groups a block chosen from the list's length on the device.
template <typename T, int P, bool LISTED>
__global__ void __launch_bounds__(block_threads(LISTED))
count_kernel(CountArgs<T> a, int groups, const int* __restrict__ list, int* __restrict__ ticket) {
  constexpr int kThreads = block_threads(LISTED);
  static_assert(kMaxGroups * 32 <= kThreads && kThreads <= kCountThreads, "a thread stages each trial of an item");
  __shared__ CountSmem<T> sh;
  const int chunks = (a.n + chunk_points(P, kThreads) - 1) / chunk_points(P, kThreads);
  if constexpr (!LISTED) {
    const int per_item = 32 * groups;
    const int tchunks = (a.n_trials + per_item - 1) / per_item;
    const long long entry = blockIdx.x / tchunks;
    const int trial0 = (int)(blockIdx.x % tchunks) * per_item;
    count_item<T, P, kThreads>(a, sh, entry / chunks, (int)(entry % chunks), trial0,
                               min(per_item, a.n_trials - trial0), per_item, [] {});
  } else {
    __shared__ int s_item, s_entry;
    const int n_list = list[0];  // the list's length, read on the device
    const int groups_all = (a.n_trials + 31) / 32;
    // The most trial groups a block that still leave an item for every block.
    const long long fill = (long long)n_list * groups_all / gridDim.x;
    const int g = (int)max(1LL, min((long long)kMaxGroups, fill));
    const int per_item = 32 * g;
    const int tchunks = (a.n_trials + per_item - 1) / per_item;
    const long long n_items = (long long)n_list * tchunks;
    // Thread 0 draws the next ticket as an item starts and reads its list
    // entry once the trials are staged, so neither round trip stands
    // between two items.
    if (threadIdx.x == 0) {
      const int first = atomicAdd(ticket, 1);
      s_item = first;
      s_entry = first < n_items ? list[1 + first / tchunks] : 0;
    }
    __syncthreads();
    for (;;) {
      const int item = s_item;
      const int entry = s_entry;
      if (item >= n_items) break;
      int next = 0, next_entry = 0;
      if (threadIdx.x == 0) next = atomicAdd(ticket, 1);
      const int trial0 = (int)(item % tchunks) * per_item;
      count_item<T, P, kThreads>(a, sh, entry / chunks, entry % chunks, trial0, min(per_item, a.n_trials - trial0),
                                 per_item, [&] {
                         if (threadIdx.x == 0 && next < n_items) next_entry = list[1 + next / tchunks];
                       });
      if (threadIdx.x == 0) s_item = next, s_entry = next_entry;
      __syncthreads();
    }
  }
}

constexpr int kMaxDevices = 64;

// Blocks of count_kernel<T, P, LISTED> a card runs at once, by device
// ordinal, found once a device (as nn_grid.cu's resident_blocks).
template <typename T, int P, bool LISTED>
cudaError_t resident_blocks(int* blocks) {
  static std::atomic<int> blocks_of[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int count = blocks_of[device].load(std::memory_order_relaxed);
  if (count == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel<T, P, LISTED>,
                                                        block_threads(LISTED), 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    count = sms * per_sm;
    blocks_of[device].store(count, std::memory_order_relaxed);
  }
  *blocks = count;
  return cudaSuccess;
}

template <typename T, int P, bool LISTED>
cudaError_t launch(int batch, const CountArgs<T>& a, char* scratch, cudaStream_t st) {
  constexpr int kThreads = block_threads(LISTED);
  const int chunks = (a.n + chunk_points(P, kThreads) - 1) / chunk_points(P, kThreads);
  const long long entries = (long long)batch * chunks;
  const long long groups = (long long)(a.n_trials + 31) / 32;
  // Tickets and block indices are ints: every item, and one draw past the
  // end a block.
  if (entries * groups > 0x7fffffffLL - (1LL << 20)) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = resident_blocks<T, P, LISTED>(&blocks);
  if (e != cudaSuccess) return e;
  if constexpr (!LISTED) {
    // The most trial groups a block that still leave an item for every
    // resident block, counting every chunk (the mask is not read here).
    const int g = (int)std::max(1LL, std::min((long long)kMaxGroups, entries * groups / blocks));
    const long long tchunks = (groups + g - 1) / g;
    count_kernel<T, P, false><<<(unsigned)(entries * tchunks), kThreads, 0, st>>>(a, g, nullptr, nullptr);
    return cudaGetLastError();
  } else {
    int* ticket = reinterpret_cast<int*>(scratch);
    int* list = ticket + 1;
    e = cudaMemsetAsync(ticket, 0, 2 * sizeof(int), st);
    if (e != cudaSuccess) return e;
    const long long list_threads = entries * 32;
    chunk_list_kernel<<<(unsigned)((list_threads + kCountThreads - 1) / kCountThreads), kCountThreads, 0, st>>>(
        a.valid, a.n, chunk_points(P, kThreads), chunks, entries, list);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long most = entries * groups;  // items at one group a block
    count_kernel<T, P, true><<<(unsigned)std::min((long long)blocks, most), kThreads, 0, st>>>(a, 0, list, ticket);
    return cudaGetLastError();
  }
}

// The two shapes: 2 points a thread on the grid of every chunk, 4 on the
// listed walk.
template <typename T>
cudaError_t launch_p(int per_thread, int batch, const CountArgs<T>& a, char* scratch, cudaStream_t st) {
  switch (per_thread) {
    case 2: return launch<T, 2, false>(batch, a, scratch, st);
    case 4: return launch<T, 4, true>(batch, a, scratch, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(int batch, const void* src, const void* dst, const void* valid, int n, const void* R, const void* t,
        const void* s, int n_trials, double thr2, void* out, void* scratch, int per_thread, void* recounted,
        cudaStream_t st) {
  CountArgs<T> a;
  a.src = static_cast<const T*>(src), a.dst = static_cast<const T*>(dst);
  a.valid = static_cast<const uint8_t*>(valid);
  a.R = static_cast<const T*>(R), a.t = static_cast<const T*>(t), a.s = static_cast<const T*>(s);
  a.out = static_cast<int*>(out), a.recounted = static_cast<unsigned long long*>(recounted);
  a.n = n, a.n_trials = n_trials;
  a.thr2 = static_cast<T>(thr2);  // the threshold as the plain version compares in T
  band_roots<T>((double)a.thr2, a.roots);
  return (int)launch_p<T>(per_thread, batch, a, static_cast<char*>(scratch), st);
}

}  // namespace

// Bytes of scratch gps_ransac_counts needs for `batch` rows of n points at
// `per_thread` points a thread: none on the grid of every chunk (2); the
// ticket, the list's length and one entry a chunk of 1,024 points on the
// listed walk (4); -1 for a per_thread it does not take.
GPS_EXPORT long long gps_ransac_counts_scratch(int n, int batch, int per_thread) {
  if (per_thread == 2) return 0;
  constexpr int chunk = chunk_points(4, block_threads(true));
  if (per_thread == 4) return kScratchHead + 4LL * batch * ((n + chunk - 1) / chunk);
  return -1;
}

// Per row of a batch of `batch` rows: src, dst (n, 3); valid (n,) bool;
// R (T, 3, 3); t (T, 3); s (T,); out (T,) int32, zeroed by the caller; rows
// contiguous one after another. per_thread: 2 (the grid of every chunk) or
// 4 (the listed walk). scratch: gps_ransac_counts_scratch bytes, 4-byte
// aligned (may be null where that is 0). recounted: null, or an integer to
// which the launch adds the pairs it recounted in the plain order. Returns
// a cudaError_t.
GPS_EXPORT int gps_ransac_counts(int dtype, int batch, const void* src, const void* dst, const void* valid, int n,
                                 const void* R, const void* t, const void* s, int n_trials, double thr2, void* out,
                                 void* scratch, int per_thread, void* recounted, void* stream) {
  if (batch < 1 || n < 1 || n_trials < 1 || gps_ransac_counts_scratch(n, batch, per_thread) < 0 ||
      (per_thread == 4 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return run<float>(batch, src, dst, valid, n, R, t, s, n_trials, thr2, out, scratch, per_thread, recounted, st);
  if (dtype == GPS_F64)
    return run<double>(batch, src, dst, valid, n, R, t, s, n_trials, thr2, out, scratch, per_thread, recounted, st);
  return (int)cudaErrorInvalidValue;
}
