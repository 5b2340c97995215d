// K2: the inclusive associative scan (suffix scan when `reverse`) of K1 for
// long leaves, in one pass and one launch: persistent blocks that walk the
// tiles and stage the next tile while they scan the present one.
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_tiled (_tiled_scan_kernel). That kernel walks a
// sequential grid of (Rb, 128) tiles and carries the running composite from
// one grid step to the next in VMEM scratch. Blocks on this card run in no
// order, so the carry travels through the decoupled look-back protocol of
// scan_lookback.cuh (ticket, flags 0 -> A -> P, release/acquire), which K2
// shares with K1 together with the tile's steps (tile_reduce, look_back,
// tile_finish, tile_store). Where K1 is a latency design (one block a tile,
// small tiles, plain loads), K2 is a throughput one:
//   - the grid is one block per slot the card has for this kernel (SMs x
//     blocks an SM holds), not one per tile; each block draws tickets in a
//     loop until the tiles are spent;
//   - the tile's leaves reach shared memory by cp.async, one element a copy
//     (the chunked path's rows hold a chunk plus one carry, so they are odd
//     and only element-aligned), consecutive threads on consecutive
//     elements. Under `reverse` the copy itself flips the index: scan order
//     k reads position n - 1 - k;
//   - the cheap combines (2-4 leaves) stage ahead: two tile buffers of up to
//     72 KB (8-16 elements a thread); at the top of every round the block
//     draws the ticket after its present one and starts that tile's copy
//     into the other buffer, then waits for the present tile only
//     (cp.async.wait_group 1), so the copy lands while the present tile is
//     folded, looked back and written;
//   - the costly combines (12 and 27 leaves) take one buffer and larger
//     tiles instead (4-8 elements a thread; K1 has 2 and 1): their time is
//     the chain of serial combines of a round (thread fold, 5-step warp
//     scan, warp totals, look-back window, carry), paid once a tile, so
//     more elements a tile and, where the registers allow it, two blocks an
//     SM (a buffer of half an SM's shared memory) cut it more than an
//     overlapped copy does: the float64 filter's 1024-element tile (221 KB)
//     leaves no room for a second buffer;
//   - each input element is read from device memory once and each output
//     written once.
//
// Forward progress with fewer blocks than tiles. A block publishes its
// tile's aggregate before it waits on a predecessor (look_back), and a tile
// it has only drawn and staged is not waited on by its own block. Take the
// lowest tile whose flag is still empty: every tile before it has published,
// so the block that scans it spins on nothing; if it is some block's drawn
// next tile, that block's present tile is lower, has published, and its
// look-back meets no empty flag, so the block reaches the drawn tile. A
// block that is not yet resident holds no ticket.
//
// What bounds it on this card: the bytes for the 2-4-leaf combines (each
// leaf read once, written once; at the chunked path's lengths they have one
// or two tiles a block, so their time is a tile's latency). For the 27-leaf
// float64 filter the float64 operations of the scan's own structure: 4
// combines an element (3 in the thread fold and warp scan, 1 for the
// carry) of 489 operations each with no multiply-add contraction
// (--fmad=false), which run at about half the float64 pipe's rate on the 8
// warps that 246 registers a thread leave an SM; warp 0's look-back and the
// copy, which nothing overlaps, add about a third.
#include "scan_lookback.cuh"

namespace {

constexpr size_t kAheadBufferBytes = 72 * 1024;  // each of two buffers
constexpr size_t kHalfSmBytes = 112 * 1024;      // one buffer, two blocks an SM
constexpr size_t kWholeSmBytes = 224 * 1024;     // one buffer, one block an SM
constexpr size_t kWideCompositeBytes = 128;      // above it one block fills an SM

// The largest power of two up to 16 of elements per thread whose tile of L
// leaves of T fits `bytes`.
template <typename T>
__host__ __device__ constexpr int items_within(int L, size_t bytes) {
  int items = 16;
  while (items > 1 && (size_t)L * padded(kScanThreads * items) * sizeof(T) > bytes) items >>= 1;
  return items;
}

// K2's tile policy. A cheap combine (2-4 leaves) is bound by its bytes: two
// buffers of at most 72 KB, so the next tile's copy overlaps this tile's
// work. A costly one (12 or 27 leaves) is bound by the latency of its
// serial combines (thread fold, warp scan, warp totals, look-back, carry),
// which more elements a thread and more warps an SM both spread: one
// buffer, of half an SM's shared memory where the registers let two blocks
// share an SM, of all of it where a composite is so wide (above 128 bytes:
// the float64 filter, 242 registers) that one block fills the SM anyway.
template <typename T>
__host__ __device__ constexpr bool tiled_single(int L) { return L >= 12; }

template <typename T>
__host__ __device__ constexpr int tiled_items(int L) {
  if (!tiled_single<T>(L)) return items_within<T>(L, kAheadBufferBytes);
  return items_within<T>(L, L * sizeof(T) > kWideCompositeBytes ? kWholeSmBytes : kHalfSmBytes);
}

template <class Op, typename T>
using TiledLayout = LookbackLayout<Op, T, tiled_items<T>(Op::L)>;

// One element from device memory to shared memory, asynchronously.
template <int BYTES>
__device__ __forceinline__ void cp_async_element(void* smem, const void* gmem) {
  static_assert(BYTES == 4 || BYTES == 8, "float32 or float64");
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if (BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(gmem) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// Step 2 as K2 takes it: starts the copies of the tile's leaves into `s`
// ([L][padded(TILE)]), consecutive threads on consecutive elements; past n
// the combine's identity, stored at once.
template <class Op, typename T, int ITEMS>
__device__ __forceinline__ void tile_stage(const T* __restrict__ in, int n, int reverse, int k0, T* s) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(kScanThreads * ITEMS);
  T ident[L];
  Op::identity(ident);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const T* row = in + (size_t)l * n;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = i * kScanThreads + (int)threadIdx.x;
      const int k = k0 + e;
      T* dst = s + l * STRIDE + padded(e);
      if (k < n) cp_async_element<sizeof(T)>(dst, row + (reverse ? n - 1 - k : k));
      else *dst = ident[l];
    }
  }
}

// Built with -DGPS_TILED_CLOCKS (tools/torch_scan_tiled_clocks.py), thread 0
// of every block adds the cycles of each of a round's five parts (wait for
// the tile, tile_reduce, look_back, tile_finish, tile_store) to g_clocks.
#ifdef GPS_TILED_CLOCKS
__device__ unsigned long long g_clocks[8];
#define GPS_CLOCK(i)                                                       \
  do {                                                                     \
    if (threadIdx.x == 0) {                                                \
      const long long now = clock64();                                     \
      atomicAdd(&g_clocks[i], (unsigned long long)(now - t0));             \
      t0 = now;                                                            \
    }                                                                      \
  } while (0)
#else
#define GPS_CLOCK(i)
#endif

template <class Op, typename T>
__global__ void __launch_bounds__(kScanThreads)
tiled_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int reverse, int n_tiles,
                  int* ticket, T* agg, T* incl) {
  constexpr int L = Op::L;
  using Layout = TiledLayout<Op, T>;
  constexpr int ITEMS = Layout::kItems;
  constexpr int TILE = Layout::kTile;
  constexpr int BUFFER = L * Layout::kStride;
  constexpr bool AHEAD = !tiled_single<T>(L);  // two buffers, the next tile staged ahead
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [AHEAD ? 2 : 1][L][padded(TILE)]
  __shared__ T s_warp[kScanWarps][L];    // warp totals, then inclusive warp prefixes
  __shared__ T s_carry[L];               // the tile's exclusive composite
  __shared__ int s_tile;
  int* flags = ticket + 1;

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  int tile = s_tile;
  if (AHEAD) {  // every round commits one group, and so does this
    if (tile < n_tiles) tile_stage<Op, T, ITEMS>(in, n, reverse, tile * TILE, s);
    cp_async_commit();
  }
  int b = 0;
#ifdef GPS_TILED_CLOCKS
  long long t0 = clock64();
#endif
  while (tile < n_tiles) {
    // The barrier below also ends the last round's reads of the buffer
    // that is staged next.
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    const int next = s_tile;
    T* cur = s + b * BUFFER;
    if (AHEAD) {
      if (next < n_tiles) tile_stage<Op, T, ITEMS>(in, n, reverse, next * TILE, s + (b ^ 1) * BUFFER);
      cp_async_commit();
      cp_async_wait<1>();  // the present tile has landed; the next may be in flight
      b ^= 1;
    } else {
      tile_stage<Op, T, ITEMS>(in, n, reverse, tile * TILE, cur);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    GPS_CLOCK(0);
    tile_reduce<Op, T, ITEMS>(cur, s_warp);
    GPS_CLOCK(1);
    if (threadIdx.x < 32) {
      look_back<Op, T>(tile, s_warp[kScanWarps - 1], flags, agg, incl, s_carry);
    }
    __syncthreads();
    GPS_CLOCK(2);
    tile_finish<Op, T, ITEMS>(tile, cur, s_warp, s_carry);
    GPS_CLOCK(3);
    tile_store<Op, T, ITEMS>(cur, out, n, (size_t)n, reverse, tile * TILE);
    GPS_CLOCK(4);
    tile = next;
  }
}

// K2's launch: zero the ticket and flags, then one grid of persistent
// blocks. `scratch` holds TiledLayout<Op, T>::scratch_bytes(n) bytes.
template <class Op, typename T>
struct TiledScan {
  static cudaError_t run(const void* in, void* out, void* scratch, long long scratch_bytes, int n,
                         int reverse, cudaStream_t stream) {
    using Layout = TiledLayout<Op, T>;
    if (n <= 0) return cudaSuccess;
    if (scratch_bytes < (long long)Layout::scratch_bytes(n)) return cudaErrorInvalidValue;
    const int tiles = Layout::tiles(n);
    const size_t smem = (tiled_single<T>(Op::L) ? 1 : 2) * Layout::smem_bytes();
    static int slots = 0;  // blocks of this kernel the card runs at once
    if (slots == 0) {
      int device = 0, sms = 0, per_sm = 0;
      cudaError_t e = allow_smem(tiled_scan_kernel<Op, T>, smem);
      if (e == cudaSuccess) e = cudaGetDevice(&device);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_scan_kernel<Op, T>,
                                                          kScanThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorLaunchOutOfResources;
      slots = sms * per_sm;
    }
    char* base = static_cast<char*>(scratch);
    T* agg = reinterpret_cast<T*>(base + Layout::values_offset(n));
    T* incl = agg + (size_t)tiles * Op::L;
    cudaError_t e = cudaMemsetAsync(scratch, 0, Layout::flag_bytes(n), stream);
    if (e != cudaSuccess) return e;
    tiled_scan_kernel<Op, T><<<tiles < slots ? tiles : slots, kScanThreads, smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, reverse, tiles,
        reinterpret_cast<int*>(base), agg, incl);
    return cudaGetLastError();
  }
};

template <class Op, typename T>
struct TiledScratch {
  static cudaError_t run(int n, long long* bytes) {
    *bytes = (long long)TiledLayout<Op, T>::scratch_bytes(n);
    return cudaSuccess;
  }
};

template <class Op, typename T>
struct TiledTile {
  static cudaError_t run(int* tile) {
    *tile = TiledLayout<Op, T>::kTile;
    return cudaSuccess;
  }
};

}  // namespace

// Op codes are the order of ops/scan.py:OPS. `scratch` holds
// gps_scan_tiled_scratch_bytes(op, dtype, n) bytes. Returns a cudaError_t.
GPS_EXPORT int gps_scan_tiled(int op, int dtype, const void* in, void* out, void* scratch,
                              long long scratch_bytes, int n, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)dispatch_op<TiledScan, float>(op, in, out, scratch, scratch_bytes, n, reverse, s);
  if (dtype == GPS_F64)
    return (int)dispatch_op<TiledScan, double>(op, in, out, scratch, scratch_bytes, n, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Scratch bytes of gps_scan_tiled for n elements; -1 for an unknown op or
// dtype.
GPS_EXPORT long long gps_scan_tiled_scratch_bytes(int op, int dtype, int n) {
  long long bytes = -1;
  if (dtype == GPS_F32) dispatch_op<TiledScratch, float>(op, n, &bytes);
  if (dtype == GPS_F64) dispatch_op<TiledScratch, double>(op, n, &bytes);
  return bytes;
}

// Elements per tile of gps_scan_tiled for this combine and dtype; -1 for an
// unknown op or dtype.
GPS_EXPORT int gps_scan_tiled_tile(int op, int dtype) {
  int tile = -1;
  if (dtype == GPS_F32) dispatch_op<TiledTile, float>(op, &tile);
  if (dtype == GPS_F64) dispatch_op<TiledTile, double>(op, &tile);
  return tile;
}

// The cycles summed since the last reset, by part of a round.
#ifdef GPS_TILED_CLOCKS
GPS_EXPORT int gps_scan_tiled_clocks(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[8] = {0};
    e = cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero));
  }
  return (int)e;
}
#endif
