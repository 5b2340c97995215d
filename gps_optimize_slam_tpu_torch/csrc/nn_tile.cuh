// The steps K3 (nn.cu) and K4 (nn_grid.cu) share on one candidate tile: the
// asynchronous copy of the tile into shared memory and the scan of a staged
// tile for the minimum squared distance of the queries a thread holds.
//
// A tile is 1024 candidates as nn_keep.cu packs them, (4, 1024): rows x, y, z
// and a validity row v that holds +0 for a valid candidate and +inf for a
// masked or padded one. It is staged as it lies in device memory (16-byte
// cp.async copies, no transpose) and read back 16 bytes at a time: one vector
// load a row gives 4 float32 or 2 float64 candidates, so a warp whose lanes
// hold different queries spends one broadcast load a candidate (two in
// float64), not four, for 10 arithmetic operations a (query, candidate)
// pair and query held.
//
// The distance of a pair is (ax-bx)^2 + (ay-by)^2 + (az-bz)^2 + v, summed
// left to right with no contraction (--fmad=false). With v in {+0, +inf}
// the last term equals the validity term (0 - v)^2 of the plain version
// exactly: (0 - 0)^2 = +0 and x + 0 = x for every x >= 0, (0 - inf)^2 =
// +inf. Both kernels call tile_min, so K4 equals K3 bit for bit whatever the
// order of tiles, slices and blocks: a minimum does not depend on it.
#pragma once

#include "common.cuh"

constexpr int kNnTileN = 128;   // queries per query tile (one keep list each)
constexpr int kNnTileM = 1024;  // candidates per tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One tile (4 x 1024 values, contiguous) from device to shared memory by the
// kThreads threads of the block, as one committed group of 16-byte copies.
template <typename T, int kThreads>
__device__ __forceinline__ void stage_tile(T* smem_tile, const T* gmem_tile) {
  constexpr int kCopies = 4 * kNnTileM * (int)sizeof(T) / 16;
  const char* src = reinterpret_cast<const char*>(gmem_tile);
  char* dst = reinterpret_cast<char*>(smem_tile);
  for (int c = threadIdx.x; c < kCopies; c += kThreads) cp_async16(dst + 16 * c, src + 16 * c);
  cp_async_commit();
}

// A NaN distance never replaces the running minimum, which starts at +inf
// and so is never NaN: fminf returns its other operand for a NaN, and
// d < best is false for one. Float64 has no single-step minimum on
// this card, and the compare-and-select form measured faster than fmin.
__device__ __forceinline__ float min_keep(float best, float d) { return fminf(best, d); }
__device__ __forceinline__ double min_keep(double best, double d) { return d < best ? d : best; }

// Fold into best[j] the distances from the thread's Q queries (ax, ay, az)
// to the candidates of the 16-byte vectors first, first + step, ... of the
// staged tile sb. Threads that pass the same `first` read the same address
// (a broadcast); neighbouring `first` are neighbouring vectors, other banks.
template <typename T, int Q>
__device__ __forceinline__ void tile_min(const T* __restrict__ sb, int first, int step,
                                         const T (&ax)[Q], const T (&ay)[Q], const T (&az)[Q],
                                         T (&best)[Q]) {
  using V = typename Vec16<T>::type;
  constexpr int kPer = 16 / (int)sizeof(T);   // candidates a vector
  constexpr int kVecs = kNnTileM / kPer;      // vectors a row
  const V* rows = reinterpret_cast<const V*>(sb);
#pragma unroll 4
  for (int v = first; v < kVecs; v += step) {
    __align__(16) T bx[kPer];
    __align__(16) T by[kPer];
    __align__(16) T bz[kPer];
    __align__(16) T bv[kPer];
    *reinterpret_cast<V*>(bx) = rows[v];
    *reinterpret_cast<V*>(by) = rows[kVecs + v];
    *reinterpret_cast<V*>(bz) = rows[2 * kVecs + v];
    *reinterpret_cast<V*>(bv) = rows[3 * kVecs + v];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const T d0 = ax[j] - bx[c];
        const T d1 = ay[j] - by[c];
        const T d2 = az[j] - bz[c];
        best[j] = min_keep(best[j], d0 * d0 + d1 * d1 + d2 * d2 + bv[c]);
      }
    }
  }
}
