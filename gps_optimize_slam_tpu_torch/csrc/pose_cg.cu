// The pose graph's Gauss-Newton solve: conjugate gradients on
// (JᵀJ + λI)δ = −Jᵀr0 over per-factor Jacobian blocks, every iteration in
// one launch (ops/kernels.py: pose_cg; the plain version pose_cg_plain).
//
// No TPU kernel stands behind this one: the JAX package runs
// jax.scipy.sparse.linalg.cg on Hessian-vector products that XLA fuses. The
// port took each product as two pullbacks through the residual, ~1,450
// small kernels an iteration; here the Jacobian is taken once a step as
// M = (N − 1) + L blocks of 6 × 12 (odometry factor k against poses k and
// k + 1, then closure l against loop_ij[l]), and the whole recurrence runs
// in one cluster of thread blocks.
//
// Layout. One cluster of C blocks (C from N: at least kMinPoses poses a
// block, at most kClusterMax blocks, the largest the card can hold). Block
// c owns the poses [⌊cN/C⌋, ⌊(c+1)N/C⌋) and keeps their x, r, p and Ap in
// its shared memory (in a global scratch where they do not fit); p is also
// written to global memory, where the other blocks read it. (On an H100 at
// the refine's 4,541 poses a float64 solve of 50 iterations takes 0.80 ms
// so, and 0.96 ms with the four vectors in the global scratch.) An
// iteration:
//   1. Ap = JᵀJp for the owned poses (odometry_jt): rounds of 64 odometry
//      factors, their blocks and p staged in shared memory by contiguous
//      16-byte reads issued a round ahead (the blocks come from global
//      memory, L2-resident at these sizes); 8 lanes a factor: lane r forms
//      row r of u = J·[p_k; p_{k+1}], then pose k's lane c sums
//      (A_kᵀu_k)[c] and (B_{k−1}ᵀu_{k−1})[c] over the rows, in order, and
//      adds its GNSS row, w·(w·p) on the positions of a valid pose: no
//      shuffle, and every block read once a pass;
//   2. the closures that touch an owned pose, 32 a round, 16 lanes each:
//      their u (a 16-lane butterfly) and both ends' Jᵀu, then one warp adds
//      them to the owned ends in the order (closure, end i before j): a
//      fixed order, no atomics;
//   3. Ap += λp and the block's partial p·Ap; cluster barrier; every warp
//      of every block folds the C partials, read from the blocks' shared
//      memory (distributed shared memory), in one fixed tree, so α is the
//      same bits everywhere without a further barrier;
//   4. x += αp, r −= αAp and the partial r·r; cluster barrier; γ folded the
//      same way; p = r + (γ_new/γ)p, written to shared and global memory;
//      cluster barrier, after which every block reads the new p.
// The recurrence is pose_cg_plain's (JAX's _cg_solve): x₀ = 0, r₀ = b,
// atol² = max(tol²·b·b, 0), and an iteration runs while γ > atol²; γ is the
// same in every block, so all stop together, and a finished solve keeps its
// values (the selection of the plain version, which never multiplies by a
// mask). The count of iterations that ran is written to `count`.
//
// Determinism: every sum (a block's partials, the cluster's fold, the
// butterflies, a closure's adds) has a fixed order and no floating-point
// atomic exists, so two launches on the same inputs give the same bits.
// The library is built with --fmad=false: no product is contracted.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupLanes = 16;
constexpr int kGroups = kThreads / kGroupLanes;  // closures a round
constexpr int kFactorLanes = 8;
constexpr int kFactorGroups = kThreads / kFactorLanes;  // odometry factors a round
constexpr int kClusterMax = 16;
constexpr int kClusterPortable = 8;
// A block owns at least this many poses.
constexpr int kMinPoses = 32;
// Dynamic shared memory of every launch: the owned x, r, p and Ap where they
// fit, and more than half an SM's, so that no two blocks of the cluster
// share an SM.
constexpr int kSmemBytes = 120 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

template <typename T>
struct Problem {
  const T* J;                   // (M, 6, 12)
  const T* r0;                  // (M, 6)
  const T* rg;                  // (N, 3) masked GNSS residual
  const unsigned char* valid;   // (N,) GNSS validity
  const long long* ij;          // (L, 2) closure pose pairs
  T w;                          // GNSS weight
  int n, L;
};

// Sum over the 16 lanes of a group (xor butterfly: every lane ends with the
// same bits, since a + b == b + a).
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// A round's tile: the blocks of kFactorGroups odometry factors and the p of
// their poses, staged in shared memory; loaded into registers a round ahead
// (16-byte vectors over the tile, contiguous in memory, and one p element a
// thread), so that the next tile's reads are in flight while this one is
// used.
template <typename T>
struct Tile {
  using V = typename Vec16<T>::type;
  static constexpr int kPerVec = 16 / (int)sizeof(T);
  static constexpr int kVecsPerThread = (kFactorGroups * 72 / kPerVec + kThreads - 1) / kThreads;
  static constexpr int kPoseElems = (kFactorGroups + 1) * 6;  // poses k0 .. k0 + kFactorGroups
  static_assert(kPoseElems <= kThreads, "one p element a thread");
  V j[kVecsPerThread];
  T p;

  // The factors [k0, kend) and the p of poses k0 .. kend.
  template <bool FROM_P>
  __device__ __forceinline__ void load(const Problem<T>& P, const T* __restrict__ pg, int k0, int kend) {
    const int nvec = (kend - k0) * 72 / kPerVec;
    const V* src = reinterpret_cast<const V*>(P.J + (size_t)k0 * 72);
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) j[i] = __ldg(src + v);
    }
    if (FROM_P && threadIdx.x < (kend - k0 + 1) * 6) p = __ldcg(pg + (size_t)k0 * 6 + threadIdx.x);
  }

  template <bool FROM_P>
  __device__ __forceinline__ void store(int k0, int kend, T* s_j, T* s_p) const {
    const int nvec = (kend - k0) * 72 / kPerVec;
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) reinterpret_cast<V*>(s_j)[v] = j[i];
    }
    if (FROM_P && threadIdx.x < (kend - k0 + 1) * 6) s_p[threadIdx.x] = p;
  }
};

// Jᵀu of the odometry factors and the GNSS rows for the owned poses [s, e),
// written to ap (ap[0] is pose s); u = J·[p_k; p_{k+1}] (FROM_P) or r0.
// A round takes kFactorGroups factors from its staged tile, a group of 8
// lanes each: lane r < 6 forms row r of factor k's u; then lane c < 6 of
// pose k's group sums the products J[r][c]·u[r] over the rows, in order:
// (A_kᵀu_k)[c] from its factor and (B_{k−1}ᵀu_{k−1})[c] from factor k − 1
// (the group before, or the round before: `carry`). Every block is read
// once a pass. The first round starts at factor s − 1, whose second end is
// s.
template <typename T, bool FROM_P>
__device__ void odometry_jt(const Problem<T>& P, const T* __restrict__ p, T* ap, int s, int e, T* s_j, T* s_p,
                            T (*s_u)[6], T (*carry)[6]) {
  const int g = threadIdx.x / kFactorLanes, lane = threadIdx.x % kFactorLanes;
  const int n = P.n;
  const int first = s > 0 ? s - 1 : 0;
  const int kmax = e < n - 1 ? e : n - 1;  // one past the last factor formed here
  auto kend = [&](int k0) { return k0 + kFactorGroups < kmax ? k0 + kFactorGroups : (k0 < kmax ? kmax : k0); };
  Tile<T> tile;
  tile.template load<FROM_P>(P, p, first, kend(first));
  tile.template store<FROM_P>(first, kend(first), s_j, s_p);
  __syncthreads();
  int round = 0;
  for (int k0 = first; k0 < e; k0 += kFactorGroups, ++round) {
    const int next = k0 + kFactorGroups;
    if (next < e) tile.template load<FROM_P>(P, p, next, kend(next));
    const int k = k0 + g;
    const T* Jg = s_j + g * 72;
    if (k < kmax && lane < 6) {
      T u;
      if constexpr (FROM_P) {
        const T* pp = s_p + g * 6;
        u = Jg[lane * 12] * pp[0];
#pragma unroll
        for (int c = 1; c < 12; ++c) u = u + Jg[lane * 12 + c] * pp[c];
      } else {
        u = __ldg(P.r0 + (size_t)k * 6 + lane);
      }
      s_u[g][lane] = u;
    }
    __syncthreads();
    if (lane < 6 && k < e) {
      const int c = lane;
      // The second end of this round's last factor, for the next round's first pose.
      if (g == kFactorGroups - 1 && k < kmax) {
        T t = Jg[6 + c] * s_u[g][0];
#pragma unroll
        for (int r = 1; r < 6; ++r) t = t + Jg[r * 12 + 6 + c] * s_u[g][r];
        carry[round & 1][c] = t;
      }
      if (k >= s) {
        T ta = T(0), tb = T(0);
        if (k <= n - 2) {
          ta = Jg[c] * s_u[g][0];
#pragma unroll
          for (int r = 1; r < 6; ++r) ta = ta + Jg[r * 12 + c] * s_u[g][r];
        }
        if (k >= 1) {
          if (g > 0) {
            const T* Jb = Jg - 72;
            tb = Jb[6 + c] * s_u[g - 1][0];
#pragma unroll
            for (int r = 1; r < 6; ++r) tb = tb + Jb[r * 12 + 6 + c] * s_u[g - 1][r];
          } else {
            tb = carry[(round + 1) & 1][c];
          }
        }
        T v = ta + tb;
        if (c < 3 && P.valid[k]) {
          const T gv = FROM_P ? P.w * s_p[g * 6 + c] : __ldg(P.rg + (size_t)k * 3 + c);
          v = v + P.w * gv;
        }
        ap[(size_t)(k - s) * 6 + c] = v;
      }
    }
    __syncthreads();
    if (next < e) {
      tile.template store<FROM_P>(next, kend(next), s_j, s_p);
      __syncthreads();
    }
  }
}

// Adds Jᵀu of the closures to the owned poses' ap (ap[0] is pose s), in
// the order (closure, end i before j): u = J·[p_i; p_j] (FROM_P) or r0.
template <typename T, bool FROM_P>
__device__ void closures_jt(const Problem<T>& P, const T* __restrict__ p, T* ap, int s, int e,
                            T (*s_clo)[12]) {
  const int g = threadIdx.x / kGroupLanes, c = threadIdx.x % kGroupLanes;
  const T* Jl = P.J + (size_t)(P.n - 1) * 72;
  const T* rl = P.r0 + (size_t)(P.n - 1) * 6;
  for (int l0 = 0; l0 < P.L; l0 += kGroups) {
    const int l = l0 + g;
    long long i = -1, j = -1;
    if (l < P.L) i = P.ij[2 * (size_t)l], j = P.ij[2 * (size_t)l + 1];
    const bool ok = l < P.L && i >= 0 && i < P.n && j >= 0 && j < P.n;
    const bool hit = ok && ((i >= s && i < e) || (j >= s && j < e));
    const bool lane = hit && c < 12;
    T col[6], u[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) col[r] = lane ? __ldg(Jl + (size_t)l * 72 + 12 * r + c) : T(0);
    if constexpr (FROM_P) {
      const T v = lane ? __ldcg(p + (size_t)(c < 6 ? i : j) * 6 + (c < 6 ? c : c - 6)) : T(0);
#pragma unroll
      for (int r = 0; r < 6; ++r) u[r] = group_sum(col[r] * v);
    } else {
#pragma unroll
      for (int r = 0; r < 6; ++r) u[r] = hit ? __ldg(rl + (size_t)l * 6 + r) : T(0);
    }
    T t = col[0] * u[0];
#pragma unroll
    for (int r = 1; r < 6; ++r) t = t + col[r] * u[r];
    if (lane) s_clo[g][c] = t;
    __syncthreads();
    if (threadIdx.x < 32) {
      const int ln = threadIdx.x;
      for (int h = 0; h < 2; ++h) {
        const int entry = h * 32 + ln, le = l0 + entry / 2, side = entry % 2;
        long long tgt = -1;
        if (le < P.L) {
          const long long a = P.ij[2 * (size_t)le], b = P.ij[2 * (size_t)le + 1];
          if (a >= 0 && a < P.n && b >= 0 && b < P.n) tgt = side ? b : a;
          if (tgt < s || tgt >= e) tgt = -1;
        }
        unsigned mask = __ballot_sync(kFull, tgt >= 0);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const long long t_src = __shfl_sync(kFull, tgt, src);
          const int es = h * 32 + src;
          if (ln < 6) {
            T* a = ap + (size_t)(t_src - s) * 6 + ln;
            *a = *a + s_clo[es / 2][(es % 2) * 6 + ln];
          }
        }
      }
    }
    __syncthreads();
  }
}

// The block's sum of one value a thread, in warp 0 (fixed tree).
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_warp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = lane < kWarps ? s_warp[lane] : T(0);
#pragma unroll
  for (int m = kWarps / 2; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// The cluster's sum of the blocks' partials in `slot`, in every thread: the
// same fixed tree in every warp of every block.
template <typename T>
__device__ __forceinline__ T cluster_sum(T* slot, int C) {
  namespace cg = cooperative_groups;
  const int lane = threadIdx.x % 32;
  T v = T(0);
  if (lane < C) v = *cg::this_cluster().map_shared_rank(slot, (unsigned)lane);
#pragma unroll
  for (int m = kClusterMax / 2; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return __shfl_sync(kFull, v, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pose_cg_kernel(Problem<T> P, T lambda, int maxiter, T tol2, int in_smem, T* __restrict__ delta,
               T* __restrict__ scratch, int* __restrict__ count_out) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_warp[kWarps];
  __shared__ T s_part[2];
  __shared__ T s_clo[kGroups][12];
  __shared__ __align__(16) T s_j[kFactorGroups * 72];
  __shared__ T s_p[(kFactorGroups + 1) * 6];
  __shared__ T s_u[kFactorGroups][6];
  __shared__ T s_carry[2][6];
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = P.n;
  const int s = (int)((long long)rank * n / C), e = (int)((long long)(rank + 1) * n / C);
  const int own = 6 * (e - s);
  T* p = scratch;                        // (N, 6): every block reads it
  T *xs, *rs, *ps, *aps;                 // the owned poses' x, r, p, Ap
  if (in_smem) {
    const int stride = 6 * ((n + C - 1) / C);
    T* base = reinterpret_cast<T*>(smem_raw);
    xs = base, rs = base + stride, ps = base + 2 * stride, aps = base + 3 * stride;
  } else {
    xs = delta + 6 * (size_t)s, rs = scratch + 6 * (size_t)n + 6 * (size_t)s;
    ps = p + 6 * (size_t)s, aps = scratch + 12 * (size_t)n + 6 * (size_t)s;
  }

  // b = −Jᵀr0; x = 0, r = p = b.
  odometry_jt<T, false>(P, p, aps, s, e, s_j, s_p, s_u, s_carry);
  closures_jt<T, false>(P, p, aps, s, e, s_clo);
  T part = T(0);
  for (int f = threadIdx.x; f < own; f += kThreads) {
    const T b = -aps[f];
    xs[f] = T(0), rs[f] = b, ps[f] = b;
    if (in_smem) p[6 * (size_t)s + f] = b;
    part = part + b * b;
  }
  part = block_sum(part, s_warp);
  if (threadIdx.x == 0) s_part[0] = part;
  cluster_sync();
  T gamma = cluster_sum(&s_part[0], C);
  T atol2 = tol2 * gamma;
  atol2 = atol2 < T(0) ? T(0) : atol2;
  int count = 0;

  for (int it = 0; it < maxiter; ++it) {
    if (!(gamma > atol2)) break;  // finished: every later iteration keeps its values
    odometry_jt<T, true>(P, p, aps, s, e, s_j, s_p, s_u, s_carry);
    closures_jt<T, true>(P, p, aps, s, e, s_clo);
    part = T(0);
    for (int f = threadIdx.x; f < own; f += kThreads) {
      const T a = aps[f] + lambda * ps[f];
      aps[f] = a;
      part = part + ps[f] * a;
    }
    part = block_sum(part, s_warp);
    if (threadIdx.x == 0) s_part[1] = part;
    cluster_sync();
    const T alpha = gamma / cluster_sum(&s_part[1], C);
    part = T(0);
    for (int f = threadIdx.x; f < own; f += kThreads) {
      xs[f] = xs[f] + alpha * ps[f];
      const T r = rs[f] - alpha * aps[f];
      rs[f] = r;
      part = part + r * r;
    }
    part = block_sum(part, s_warp);
    if (threadIdx.x == 0) s_part[0] = part;
    cluster_sync();
    const T gamma_new = cluster_sum(&s_part[0], C);
    const T beta = gamma_new / gamma;
    for (int f = threadIdx.x; f < own; f += kThreads) {
      const T pn = rs[f] + beta * ps[f];
      ps[f] = pn;
      if (in_smem) p[6 * (size_t)s + f] = pn;
    }
    gamma = gamma_new;
    ++count;
    cluster_sync();  // the new p, everywhere
  }
  if (in_smem)
    for (int f = threadIdx.x; f < own; f += kThreads) delta[6 * (size_t)s + f] = xs[f];
  if (rank == 0 && threadIdx.x == 0) *count_out = count;
  cluster_sync();  // no block leaves while another may read its partials
}

// The kernel's attributes for a cluster of C blocks, on the current device
// (set before every launch: an attribute holds for one device).
template <typename T>
cudaError_t allow(int C) {
  cudaError_t e = cudaFuncSetAttribute(pose_cg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e == cudaSuccess && C > kClusterPortable)
    e = cudaFuncSetAttribute(pose_cg_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The launch of one cluster of C blocks on `stream` (built in place: cfg
// points at attr).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(int C, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The largest cluster the card holds, at most `want` blocks (asked once a
// size and dtype); 0 where none does.
template <typename T>
int cluster_fits(int want) {
  static int fits[kClusterMax + 1] = {};
  for (int C = want; C >= 1; --C) {
    if (fits[C] == 0) {
      cudaError_t e = allow<T>(C);
      int clusters = 0;
      if (e == cudaSuccess) {
        const ClusterLaunch launch(C, nullptr);
        e = cudaOccupancyMaxActiveClusters(&clusters, pose_cg_kernel<T>, &launch.cfg);
      }
      if (e != cudaSuccess) {
        cudaGetLastError();  // a size the card refuses is not an error of the launch
        clusters = 0;
      }
      fits[C] = clusters > 0 ? 1 : -1;
    }
    if (fits[C] > 0) return C;
  }
  return 0;
}

template <typename T>
int cluster_of(int n) {
  const int want = n < 1 ? 1 : (n + kMinPoses - 1) / kMinPoses;
  return cluster_fits<T>(want < kClusterMax ? want : kClusterMax);
}

template <typename T>
cudaError_t pose_cg_launch(int n, int L, const void* J, const void* r0, const void* rg, const void* valid,
                           double w, const void* ij, double lambda, int maxiter, double tol, void* delta,
                           void* scratch, void* count, cudaStream_t stream) {
  if (n < 1 || L < 0 || maxiter < 0) return cudaErrorInvalidValue;
  const int C = cluster_of<T>(n);
  if (C < 1) return cudaErrorInvalidConfiguration;
  const long long per = 6LL * ((n + C - 1) / C);
  const int in_smem = 4 * per * (long long)sizeof(T) <= kSmemBytes ? 1 : 0;
  Problem<T> P;
  P.J = static_cast<const T*>(J), P.r0 = static_cast<const T*>(r0), P.rg = static_cast<const T*>(rg);
  P.valid = static_cast<const unsigned char*>(valid), P.ij = static_cast<const long long*>(ij);
  P.w = static_cast<T>(w), P.n = n, P.L = L;
  const T tol2 = static_cast<T>(tol * tol);
  cudaError_t e = allow<T>(C);
  if (e != cudaSuccess) return e;
  const ClusterLaunch launch(C, stream);
  e = cudaLaunchKernelEx(&launch.cfg, pose_cg_kernel<T>, P, static_cast<T>(lambda), maxiter, tol2, in_smem,
                         static_cast<T*>(delta), static_cast<T*>(scratch), static_cast<int*>(count));
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// δ (n, 6) and the active iterations (one int32) of the CG solve of
// (JᵀJ + λI)δ = −Jᵀr0. J (n − 1 + L, 6, 12), r0 (n − 1 + L, 6), rg (n, 3),
// valid (n,) bytes, ij (L, 2) int64, scratch 3·n·6 elements; all on the
// stream's device. A closure whose pair lies outside [0, n) is left out.
GPS_EXPORT int gps_pose_cg(int dtype, int n, int L, const void* J, const void* r0, const void* rg,
                           const void* valid, double w, const void* ij, double lambda, int maxiter, double tol,
                           void* delta, void* scratch, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)pose_cg_launch<float>(n, L, J, r0, rg, valid, w, ij, lambda, maxiter, tol, delta, scratch, count, s);
  if (dtype == GPS_F64)
    return (int)pose_cg_launch<double>(n, L, J, r0, rg, valid, w, ij, lambda, maxiter, tol, delta, scratch, count,
                                       s);
  return (int)cudaErrorInvalidValue;
}
