// K2: the inclusive associative scan (suffix scan when `reverse`) of K1 for
// long leaves, in one pass and one launch of persistent blocks that walk
// the tiles: a single row on tiled_scan_kernel, a batch of rows on the
// batch grid (tiled_grid_kernel, below).
//
// Replaces the Pallas kernel gps_optimize_slam_tpu/ops/pallas_scan.py:
// associative_scan_tiled (_tiled_scan_kernel), and under the JAX package's
// vmap its batch grid. That kernel walks a sequential grid of (Rb, 128)
// tiles and carries the running composite from one grid step to the next
// in VMEM scratch. Blocks on this card run in no order, so the carry
// travels through the decoupled look-back protocol of scan_lookback.cuh
// (ticket, flags 0 -> A -> P, release/acquire), which K2 shares with K1
// together with the tile's steps. Where K1 is a latency design (one block a
// tile, small tiles, plain loads), K2 is a throughput one: one block per
// slot the card has for the kernel (SMs x blocks an SM holds), each drawing
// tickets in a loop until the tiles are spent, each input element read
// from device memory once and each output written once.
//
// The single row (tiled_scan_kernel: one launch of kScanThreads-thread
// blocks):
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
//     leaves no room for a second buffer.
// The kernel's code takes (L, B, n) leaves (its tickets run over every
// row's tiles, the next ticket's tile may be the next row's first), but
// only B = 1 launches it.
//
// Forward progress with fewer blocks than tiles (in ticket order; a row's
// first tile waits on nothing). A block publishes its tile's aggregate
// before it waits on a predecessor (look_back), and a tile it has only
// drawn and staged is not waited on by its own block. Take the lowest tile
// whose flag is still empty: every tile before it has published, so the
// block that scans it spins on nothing; if it is some block's drawn next
// tile, that block's present tile is lower, has published, and its
// look-back meets no empty flag, so the block reaches the drawn tile. A
// block that is not yet resident holds no ticket.
//
// What bounds the single row on this card: the bytes for the 2-4-leaf
// combines (each leaf read once, written once; at the chunked path's
// lengths they have one or two tiles a block, so their time is a tile's
// latency). For the 27-leaf float64 filter the float64 operations of the
// scan's own structure: 4 combines an element (3 in the thread fold and
// warp scan, 1 for the carry) of 489 operations each with no multiply-add
// contraction (--fmad=false), which run at about half the float64 pipe's
// rate on the 8 warps that 246 registers a thread leave an SM; warp 0's
// look-back and the copy, which nothing overlaps, add about a third.
#include "scan_lookback.cuh"

namespace {

// Device ordinals K2 keeps a persistent-block count for.
constexpr int kMaxDevices = 64;

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
// the combine's identity, stored at once. Leaf l of the row starts at
// in + l * ld.
template <class Op, typename T, int ITEMS>
__device__ __forceinline__ void tile_stage(const T* __restrict__ in, int n, size_t ld, int reverse, int k0,
                                           T* s) {
  constexpr int L = Op::L;
  constexpr int STRIDE = padded(kScanThreads * ITEMS);
  T ident[L];
  Op::identity(ident);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const T* row = in + l * ld;
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
tiled_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int batch, int reverse, int n_tiles,
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
  const size_t ld = (size_t)batch * n;  // leaf stride of the (L, batch, n) leaves
  const int tickets = batch * n_tiles;  // every row's tiles, row-major
  // The copies of ticket t's tile: its row's leaves, its tile's offset.
  auto stage = [&](int t, T* buf) {
    tile_stage<Op, T, ITEMS>(in + (size_t)(t / n_tiles) * n, n, ld, reverse, (t % n_tiles) * TILE, buf);
  };

  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  int t = s_tile;
  if (AHEAD) {  // every round commits one group, and so does this
    if (t < tickets) stage(t, s);
    cp_async_commit();
  }
  int b = 0;
#ifdef GPS_TILED_CLOCKS
  long long t0 = clock64();
#endif
  while (t < tickets) {
    // The barrier below also ends the last round's reads of the buffer
    // that is staged next.
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    const int next = s_tile;
    T* cur = s + b * BUFFER;
    if (AHEAD) {
      if (next < tickets) stage(next, s + (b ^ 1) * BUFFER);  // may be the next row's tile 0
      cp_async_commit();
      cp_async_wait<1>();  // the present tile has landed; the next may be in flight
      b ^= 1;
    } else {
      stage(t, cur);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    GPS_CLOCK(0);
    // The ticket names a (row, tile): the row's leaves and scratch slice.
    const int row = t / n_tiles, tile = t % n_tiles;
    const size_t slot = (size_t)row * n_tiles;
    tile_reduce<Op, T, ITEMS>(cur, s_warp);
    GPS_CLOCK(1);
    if (threadIdx.x < 32) {
      look_back<Op, T>(tile, s_warp[kScanWarps - 1], flags + slot, agg + slot * L, incl + slot * L, s_carry);
    }
    __syncthreads();
    GPS_CLOCK(2);
    tile_finish<Op, T, ITEMS>(tile, cur, s_warp, s_carry);
    GPS_CLOCK(3);
    tile_store<Op, T, ITEMS>(cur, out + (size_t)row * n, n, ld, reverse, tile * TILE);
    GPS_CLOCK(4);
    t = next;
  }
}

// ---- K2's batch grid -------------------------------------------------------
//
// A batch of B > 1 rows takes a grid of its own (a single row keeps
// tiled_scan_kernel above): persistent blocks of WARPS compute warps, a
// producer warp and a publisher warp over a ring of STAGES tiles in shared
// memory.
//   - The producer warp draws the tickets: one counter over every row's
//     tiles in row-major order, as K1's batch grid (scan_lookback.cuh):
//     ticket t is tile t % tiles(n) of row t / tiles(n), the flags and
//     values a slot per (row, tile), and the look-back walks its row's slice
//     of them, so it stops at its row's first tile. It stages each tile by
//     bulk copies (cp.async.bulk, one a leaf, completing on the stage's
//     mbarrier with its bytes expected) and walks the look-back of every
//     tile its block scans. The rows are element-aligned only (odd n, leaf
//     l of row r at l * B * n + r * n), so each leaf's span is copied as
//     its 16-byte aligned interior by one bulk copy plus at most
//     16 / sizeof(T) - 1 elements at each end by plain loads, which follow
//     the copies; past the row's end the identity is written in shared
//     memory. Nothing outside the row is read. The span lands in memory
//     order, each leaf at an offset that keeps its interior 16-byte aligned
//     (StagedTile), and `reverse` reads it backwards.
//   - The compute warps scan with the runs tile (tile_reduce_runs /
//     tile_finish_runs, every combine): they reduce tile i + 1 while the
//     producer looks tile i back, then finish and store tile i with its
//     carry and free its stage. With two stages the copy of tile i + 2 is
//     issued when tile i's stage is freed.
//   - The publisher warp publishes each tile's aggregate (a row's first
//     tile: its prefix) as soon as the tile is reduced, so no look-back
//     waits on a block's producer, and from a thread with no output stores
//     to drain before its release. The filter's ~250 registers a thread
//     leave no room for it: there compute thread 0 publishes.
//   - The hand-offs are mbarriers a stage: full (the producer's two
//     arrivals, the copies' bytes expected first, and the copies landed),
//     reduced (the aggregate is in s_warp), published, carried (the
//     look-back's carry is in s_carry) and empty (the tile is stored); the
//     compute warps' own barriers are a named barrier, so neither other
//     warp waits at them.
//
// Forward progress, with these roles. A block's producer draws a ticket only
// when a stage is free and stages it at once, and every tile's aggregate
// is published once its compute warps have reduced it, by a warp that
// waits on nothing else. The compute warps reduce tile i + 1 before they
// finish tile i, and need for that only its copy. A look-back waits only on
// lower tickets, and the producer looks its block's tiles back in ticket
// order, so the tiles a block has drawn ahead (higher tickets) are never
// waited on by its own look-backs. Take the lowest tile m whose flag is
// still empty, drawn by block Z. Every tile below m has published, so every
// look-back Z runs before m's ends. Z's compute warps reach m's reduce: the
// tiles before it need only carries from those look-backs, and m's copy was
// issued when m was drawn. m's aggregate then goes out. A block that is not
// resident holds no ticket, and the grid is no larger than the blocks the
// card holds at once.
//
// A row of a batch meets other tiles than the same row alone (the batch
// grid's tile, not the single row's), so it agrees with that call to the
// scan's tolerance, and bit for bit where the combine is exact (add2 on
// counts, max3, min3).
//
// What bounds it: bytes for every combine but the filter (each element read
// from device memory once and written once), the float64 operations of the
// runs tile's 2 + 6 / ITEMS combines an element for the 27-leaf filter.
// What holds it back on the H100 (tools/torch_scan_tiled_clocks.py --batch,
// PERF.md): latency, not bytes. A tile's look-back walks back past every
// tile still in flight (about two a block), 10,000-15,000 cycles a tile,
// longer than the compute warps' reduce of the next tile, and with two
// stages a tile's copy is issued only when the stage two tiles back is
// freed. Walking 2-8 predecessors a lane, splitting the producer's staging
// into a warp of its own, three stages or larger tiles were no faster.

// The batch grid's shape: compute warps, items a thread, stages of the
// ring, and whether a publisher warp publishes each tile's aggregate (else
// compute thread 0 does).
template <int WARPS, int ITEMS, int STAGES, bool PUBLISHER = true>
struct GridShape {
  static constexpr int kWarps = WARPS, kItems = ITEMS, kStages = STAGES;
  static constexpr bool kPublisher = PUBLISHER;
  static constexpr int kThreads = 32 * WARPS;                        // compute threads
  static constexpr int kBlock = kThreads + (PUBLISHER ? 64 : 32);  // and the producer (and publisher) warp
  static constexpr int kTile = kThreads * ITEMS;
};

// The shape each combine launches in a batch, the fastest of
// tools/scan_grid_sweep.py's at 4 x 524,289 / 393,217 / 300,001 / 20,001,
// 2 x 70,001 and 4 x 262,145 float64 on an H100 (PERF.md): 8 compute warps
// of 4 items and two stages for the 2-4-leaf combines; rts at 2 items; the
// filter at 7 warps of 2 items (its ~250 registers a thread allow 8 warps
// an SM: one block, 27 x 450 float64 values a stage, 97 KB).
template <class Op, typename T>
struct GridOf : GridShape<8, 4, 2> {};
template <typename T>
struct GridOf<RtsSuffix<T>, T> : GridShape<8, 2, 2> {};
template <typename T>
struct GridOf<Filter<T>, T> : GridShape<7, 2, 2, false> {};  // no room for a publisher warp

// A stage of the ring: leaf l's span at s + l * STRIDE, its first memory
// element at an offset that puts its 16-byte aligned interior on a 16-byte
// boundary. Scan-order element e of leaf l sits at mis_l + e, or under
// `reverse` at ((mis_l - pad) mod V) + TILE - 1 - e, where mis_l is the
// span's misalignment in elements (mis0 + l * ldv, mod V: the leaves are
// ld apart), V = 16 / sizeof(T) and pad = TILE - cnt the identity elements
// past the row's end. STRIDE = TILE + V holds both.
template <typename T, int TILE>
struct StagedTile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int STRIDE = TILE + V;
  T* s;
  int mis0, ldv, pad, reverse;
  __device__ __forceinline__ int offset(int l) const {
    const int mis = (mis0 + l * ldv) & (V - 1);
    return reverse ? ((mis - pad) & (V - 1)) + TILE - 1 : mis;
  }
  __device__ __forceinline__ T& operator()(int l, int e) const {
    return s[l * STRIDE + (reverse ? offset(l) - e : offset(l) + e)];
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory to 16-byte
// aligned shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Orders this thread's shared-memory accesses before later bulk copies
// into the same memory (the async proxy).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// Built with -DGPS_TILED_CLOCKS, the batch grid's consumer thread 0 adds
// the cycles of its parts to g_clocks[0..4] (wait for the tile, reduce,
// wait for the carry, finish, store and free the stage) and the producer's
// lane 0 its own to g_clocks[5..7] (wait for the reduce, look-back, wait
// for a free stage and stage the next tile): ops/scan.py names them.
#ifdef GPS_TILED_CLOCKS
#define GRID_CLOCK(i, lead)                                               \
  do {                                                                    \
    if (lead) {                                                           \
      const long long now = clock64();                                    \
      atomicAdd(&g_clocks[i], (unsigned long long)(now - t0));            \
      t0 = now;                                                           \
    }                                                                     \
  } while (0)
#else
#define GRID_CLOCK(i, lead)
#endif

enum : int { kFull = 0, kReduced = 1, kCarried = 2, kEmpty = 3, kPublished = 4 };

// The blocks an SM the launch bound promises: as many as the combine's ring
// lets share an SM in float64 (the filter 1, rts 2, the 2-4-leaf combines
// 3), so that ptxas neither spills to fit more (with no count it held the
// float64 mobius grid to 48 registers and spilled 4-8 bytes) nor grows past
// them (with 1, rts took 114 registers and one block an SM).
template <int L>
constexpr int grid_min_blocks() {
  return L >= 27 ? 1 : L >= 12 ? 2 : 3;
}

template <class Op, typename T, class G>
__global__ void __launch_bounds__(G::kBlock, grid_min_blocks<Op::L>())
tiled_grid_kernel(const T* __restrict__ in, T* __restrict__ out, int n, int batch, int reverse, int n_tiles,
                  int* ticket, T* agg, T* incl) {
  constexpr int L = Op::L;
  constexpr int WARPS = G::kWarps, ITEMS = G::kItems, S = G::kStages, THREADS = G::kThreads, TILE = G::kTile;
  using Tile = StagedTile<T, TILE>;
  constexpr int V = Tile::V;
  constexpr int STAGE = L * Tile::STRIDE;  // values a stage
  static_assert(L <= 32, "a producer lane a leaf");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [S][L][STRIDE]
  __shared__ T s_warp[S][WARPS][L];         // a stage's warp totals, then inclusive warp prefixes
  __shared__ T s_carry[S][L];               // a stage's exclusive composite
  __shared__ int s_ticket[S];               // the ticket a stage holds
  __shared__ T s_ident[L];                  // the combine's identity
  __shared__ unsigned long long s_bar[5][S];
  int* flags = ticket + 1;
  const size_t ld = (size_t)batch * n;  // leaf stride of the (L, batch, n) leaves
  const int tickets = batch * n_tiles;  // every row's tiles, row-major
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < S) {  // full: the producer's two arrivals (bytes expected, then its own loads)
#pragma unroll
    for (int k = 0; k < 5; ++k) mbar_init(&s_bar[k][threadIdx.x], k == kFull ? 2 : 1);
  }
  if (threadIdx.x == 0) Op::identity(s_ident);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
#ifdef GPS_TILED_CLOCKS
  long long t0 = clock64();
#endif

  // Ticket t's span: its row's first element, its scan-order start and
  // length, and the first element of its span in memory order.
  auto span = [&](int t, size_t& row0, int& k0, int& cnt, int& m0) {
    const int row = t / n_tiles;
    row0 = (size_t)row * n;
    k0 = (t % n_tiles) * TILE;
    cnt = min(TILE, n - k0);
    m0 = reverse ? n - k0 - cnt : k0;
  };
  auto staged = [&](int s, int t) {
    size_t row0;
    int k0, cnt, m0;
    span(t, row0, k0, cnt, m0);
    const T* first = in + row0 + m0;
    return Tile{ring + s * STAGE, (int)((reinterpret_cast<uintptr_t>(first) & 15) / sizeof(T)), (int)(ld & (V - 1)),
                TILE - cnt, reverse};
  };

  if (warp == WARPS) {
    // The producer warp: lane l stages leaf l. Draws the next ticket into
    // stage s and starts its copies; false once the tickets are spent (the
    // stage then holds the end ticket).
    auto stage = [&](int s) {
      int t = 0;
      if (lane == 0) t = atomicAdd(ticket, 1);
      t = __shfl_sync(0xffffffffu, t, 0);
      unsigned bytes = 0;
      const T* from = nullptr;
      T* row = nullptr;
      int head = 0, body = 0, cnt = 0, q0 = 0;
      if (t < tickets && lane < L) {
        size_t row0;
        int k0, m0;
        span(t, row0, k0, cnt, m0);
        const Tile tile = staged(s, t);
        from = in + lane * ld + row0 + m0;
        const int mis = (int)((reinterpret_cast<uintptr_t>(from) & 15) / sizeof(T));
        head = min((V - mis) & (V - 1), cnt);
        body = (cnt - head) / V * V;
        row = tile.s + lane * Tile::STRIDE;
        // Memory element m0 + j lands at q0 + j.
        q0 = reverse ? tile.offset(lane) - (cnt - 1) : tile.offset(lane);
        bytes = (unsigned)(body * sizeof(T));
      }
      // The first arrival expects the bulk copies' bytes; they go out before
      // the plain loads below, and the second arrival follows those.
      const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
      if (lane == 0) mbar_arrive_tx(&s_bar[kFull][s], total);
      __syncwarp();
      if (bytes) bulk_copy(row + q0 + head, from + head, bytes, &s_bar[kFull][s]);
      if (t < tickets) {
        if (lane < L) {
          for (int j = 0; j < head; ++j) row[q0 + j] = from[j];
          for (int j = head + body; j < cnt; ++j) row[q0 + j] = from[j];
        }
        const Tile tile = staged(s, t);
        const int pad = tile.pad;
        for (int k = lane; k < L * pad; k += 32) {  // the identity past the row's end
          const int l = k / pad;
          tile(l, TILE - pad + k % pad) = s_ident[l];
        }
      }
      if (lane == 0) s_ticket[s] = t;
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_bar[kFull][s]);
      return t < tickets;
    };
    // Round i < 0 stages tile i + S (the ring's first fill); round i >= 0
    // looks tile i back, then stages tile i + S into its stage once tile i
    // is stored (and its aggregate published). One call site of `stage`.
    bool more = true;
    for (int i = -S;; ++i) {
      const int s = (i + S) % S;
      const unsigned ph = ((i + S) / S + 1) & 1;  // tile i's use of stage s
      if (i >= 0) {
        const int t = s_ticket[s];
        if (t >= tickets) break;
        mbar_wait(&s_bar[kReduced][s], ph);
        GRID_CLOCK(5, lane == 0);
        const int row = t / n_tiles, tile = t % n_tiles;
        const size_t slot = (size_t)row * n_tiles;
        look_back<Op, T, true>(tile, s_warp[s][WARPS - 1], flags + slot, agg + slot * L, incl + slot * L,
                               s_carry[s]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&s_bar[kCarried][s]);
        GRID_CLOCK(6, lane == 0);
        if (more) {
          mbar_wait(&s_bar[kEmpty][s], ph);
          if (G::kPublisher) mbar_wait(&s_bar[kPublished][s], ph);
          fence_proxy_async();
        }
      }
      if (more) more = stage(s);
      GRID_CLOCK(7, lane == 0);
    }
    return;
  }
  if (G::kPublisher && warp == WARPS + 1) {
    // The publisher warp: each tile's aggregate (a row's first tile: its
    // prefix) goes out as soon as the compute warps have reduced it, from
    // a thread with no output stores of its own to drain first.
    for (int i = 0;; ++i) {
      const int s = i % S;
      const unsigned ph = (i / S) & 1;
      mbar_wait(&s_bar[kFull][s], ph);
      const int t = s_ticket[s];
      if (t >= tickets) return;
      mbar_wait(&s_bar[kReduced][s], ph);
      if (lane == 0) {
        const size_t slot = (size_t)(t / n_tiles) * n_tiles;
        publish_aggregate<Op, T>(t % n_tiles, s_warp[s][WARPS - 1], flags + slot, agg + slot * L, incl + slot * L);
        mbar_arrive(&s_bar[kPublished][s]);
      }
    }
  }

  // The compute warps: reduce tile i, then finish tile i - 1 with its carry.
  const int tid = threadIdx.x;
  auto finish = [&](int i) {
    const int s = i % S;
    const int t = s_ticket[s];
    mbar_wait(&s_bar[kCarried][s], (i / S) & 1);
    GRID_CLOCK(2, tid == 0);
    const Tile tile = staged(s, t);
    tile_finish_runs<Op, T, ITEMS, THREADS, 1>(t % n_tiles, tile, s_warp[s], s_carry[s]);
    GRID_CLOCK(3, tid == 0);
    size_t row0;
    int k0, cnt, m0;
    span(t, row0, k0, cnt, m0);
    T* row = out + row0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int i2 = 0; i2 < ITEMS; ++i2) {
        const int e = i2 * THREADS + tid;
        if (e < cnt) row[l * ld + (reverse ? n - 1 - k0 - e : k0 + e)] = tile(l, e);
      }
    }
    fence_proxy_async();
    tile_sync<1, THREADS>();
    if (tid == 0) mbar_arrive(&s_bar[kEmpty][s]);
    GRID_CLOCK(4, tid == 0);
  };
  for (int i = 0;; ++i) {  // the round that meets the end ticket finishes the last tile
    const int s = i % S;
    mbar_wait(&s_bar[kFull][s], (i / S) & 1);
    const int t = s_ticket[s];
    const bool end = t >= tickets;
    if (!end) {
      GRID_CLOCK(0, tid == 0);
      tile_reduce_runs<Op, T, ITEMS, THREADS, 1>(staged(s, t), s_warp[s]);
      if (tid == 0) {
        mbar_arrive(&s_bar[kReduced][s]);
        if (!G::kPublisher) {  // the aggregate goes out at once: no look-back waits on this block's producer
          const size_t slot = (size_t)(t / n_tiles) * n_tiles;
          publish_aggregate<Op, T>(t % n_tiles, s_warp[s][WARPS - 1], flags + slot, agg + slot * L,
                                   incl + slot * L);
        }
      }
      GRID_CLOCK(1, tid == 0);
    }
    if (i > 0) finish(i - 1);
    if (end) break;
  }
}

// Blocks of the batch grid's kernel each card runs at once, by device
// ordinal (the launch goes to the current device, which the wrapper makes
// the tensors' own; the shared-memory attribute is set per device too).
template <class Op, typename T, class G>
cudaError_t grid_slots(size_t smem, int* slots, int* per_sm_out = nullptr) {
  static int slots_of[kMaxDevices] = {0}, per_sm_of[kMaxDevices] = {0};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (slots_of[device] == 0) {
    int sms = 0, per_sm = 0;
    e = allow_smem(tiled_grid_kernel<Op, T, G>, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_grid_kernel<Op, T, G>, G::kBlock, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    per_sm_of[device] = per_sm;
    slots_of[device] = sms * per_sm;
  }
  *slots = slots_of[device];
  if (per_sm_out) *per_sm_out = per_sm_of[device];
  return cudaSuccess;
}

template <class Op, typename T, class G>
size_t grid_smem() {
  return (size_t)G::kStages * Op::L * StagedTile<T, G::kTile>::STRIDE * sizeof(T);
}

// The batch grid's launch: zero the ticket and flags, then one persistent
// block per slot the card has for this kernel (at most one per tile).
template <class Op, typename T, class G>
cudaError_t grid_launch(const void* in, void* out, void* scratch, long long scratch_bytes, int n, int batch,
                        int reverse, cudaStream_t stream) {
  using Layout = LookbackLayout<Op, T, G::kItems, G::kThreads>;
  if (n <= 0 || batch <= 0) return batch < 0 ? cudaErrorInvalidValue : cudaSuccess;
  if (scratch_bytes < (long long)Layout::scratch_bytes(n, batch)) return cudaErrorInvalidValue;
  const int tiles = Layout::tiles(n);
  const long long tickets = (long long)batch * tiles;
  const size_t smem = grid_smem<Op, T, G>();
  int slots = 0;
  cudaError_t e = grid_slots<Op, T, G>(smem, &slots);
  if (e != cudaSuccess) return e;
  // Every block draws at most one ticket past the last: the counter must not wrap.
  if (tickets + slots > 0x7fffffffLL) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  T* agg = reinterpret_cast<T*>(base + Layout::values_offset(n, batch));
  T* incl = agg + (size_t)tickets * Op::L;
  e = cudaMemsetAsync(scratch, 0, Layout::flag_bytes(n, batch), stream);
  if (e != cudaSuccess) return e;
  tiled_grid_kernel<Op, T, G><<<tickets < slots ? (int)tickets : slots, G::kBlock, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, batch, reverse, tiles, reinterpret_cast<int*>(base),
      agg, incl);
  return cudaGetLastError();
}

// K2's launch: a batch of B > 1 rows takes the batch grid (GridOf's
// shape); a single row zeroes the ticket and flags and launches
// tiled_scan_kernel's persistent blocks. `scratch` holds TiledScratch's
// bytes.
template <class Op, typename T>
struct TiledScan {
  static cudaError_t run(const void* in, void* out, void* scratch, long long scratch_bytes, int n, int batch,
                         int reverse, cudaStream_t stream) {
    using Layout = TiledLayout<Op, T>;
    if (n <= 0 || batch <= 0) return batch < 0 ? cudaErrorInvalidValue : cudaSuccess;
    if (batch > 1)
      return grid_launch<Op, T, GridOf<Op, T>>(in, out, scratch, scratch_bytes, n, batch, reverse, stream);
    if (scratch_bytes < (long long)Layout::scratch_bytes(n, batch)) return cudaErrorInvalidValue;
    const int tiles = Layout::tiles(n);
    const long long tickets = (long long)batch * tiles;
    const size_t smem = (tiled_single<T>(Op::L) ? 1 : 2) * Layout::smem_bytes();
    // Blocks of this kernel each card runs at once, by device ordinal: the
    // launch goes to the current device (the wrapper makes it the tensors'
    // own), and the shared-memory attribute is set per device too.
    static int slots_of[kMaxDevices] = {0};
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    int slots = slots_of[device];
    if (slots == 0) {
      int sms = 0, per_sm = 0;
      e = allow_smem(tiled_scan_kernel<Op, T>, smem);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tiled_scan_kernel<Op, T>,
                                                          kScanThreads, smem);
      if (e != cudaSuccess) return e;
      if (per_sm < 1) return cudaErrorLaunchOutOfResources;
      slots = slots_of[device] = sms * per_sm;
    }
    // Every block draws one ticket past the last: the counter must not wrap.
    if (tickets + slots > 0x7fffffffLL) return cudaErrorInvalidValue;
    char* base = static_cast<char*>(scratch);
    T* agg = reinterpret_cast<T*>(base + Layout::values_offset(n, batch));
    T* incl = agg + (size_t)tickets * Op::L;
    e = cudaMemsetAsync(scratch, 0, Layout::flag_bytes(n, batch), stream);
    if (e != cudaSuccess) return e;
    tiled_scan_kernel<Op, T><<<tickets < slots ? (int)tickets : slots, kScanThreads, smem, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n, batch, reverse, tiles,
        reinterpret_cast<int*>(base), agg, incl);
    return cudaGetLastError();
  }
};

// Scratch of the path `batch` rows of n elements take.
template <class Op, typename T>
struct TiledScratch {
  static cudaError_t run(int n, int batch, long long* bytes) {
    using G = GridOf<Op, T>;
    *bytes = batch > 1 ? (long long)LookbackLayout<Op, T, G::kItems, G::kThreads>::scratch_bytes(n, batch)
                       : (long long)TiledLayout<Op, T>::scratch_bytes(n, batch);
    return cudaSuccess;
  }
};

template <class Op, typename T>
struct TiledTile {
  static cudaError_t run(int batch, int* tile) {
    *tile = batch > 1 ? GridOf<Op, T>::kTile : TiledLayout<Op, T>::kTile;
    return cudaSuccess;
  }
};

// The batch grid's layout on the current device: compute warps, items a
// thread, stages, tile, blocks an SM, shared-memory bytes a block.
template <class Op, typename T>
struct TiledGridLayout {
  static cudaError_t run(int* out) {
    using G = GridOf<Op, T>;
    const size_t smem = grid_smem<Op, T, G>();
    int slots = 0, per_sm = 0;
    cudaError_t e = grid_slots<Op, T, G>(smem, &slots, &per_sm);
    if (e != cudaSuccess) return e;
    out[0] = G::kWarps, out[1] = G::kItems, out[2] = G::kStages, out[3] = G::kTile, out[4] = per_sm;
    out[5] = (int)smem;
    return cudaSuccess;
  }
};

#ifdef GPS_GRID_SWEEP
// Built with -DGPS_GRID_SWEEP=<op code> (tools/scan_grid_sweep.py, a
// library a combine): that combine's batch grid, float64, at every shape of
// GPS_SWEEP_SHAPES and at any batch, B = 1 included, and none of the
// exports below it.
template <int W, int I, int S>
struct Sweep {
  template <class Op, typename T>
  struct Launch {
    static cudaError_t run(const void* in, void* out, void* scratch, long long scratch_bytes, int n, int batch,
                           int reverse, cudaStream_t stream) {
      return grid_launch<Op, T, GridShape<W, I, S>>(in, out, scratch, scratch_bytes, n, batch, reverse, stream);
    }
  };
  template <class Op, typename T>
  struct Scratch {
    static cudaError_t run(int n, int batch, long long* bytes) {
      *bytes = (long long)LookbackLayout<Op, T, I, 32 * W>::scratch_bytes(n, batch);
      return cudaSuccess;
    }
  };
};
// The shape each combine launches (GridOf), the sweep's variant 0.
struct SweepGridOf {
  template <class Op, typename T>
  struct Launch {
    static cudaError_t run(const void* in, void* out, void* scratch, long long scratch_bytes, int n, int batch,
                           int reverse, cudaStream_t stream) {
      return grid_launch<Op, T, GridOf<Op, T>>(in, out, scratch, scratch_bytes, n, batch, reverse, stream);
    }
  };
  template <class Op, typename T>
  struct Scratch {
    static cudaError_t run(int n, int batch, long long* bytes) {
      using G = GridOf<Op, T>;
      *bytes = (long long)LookbackLayout<Op, T, G::kItems, G::kThreads>::scratch_bytes(n, batch);
      return cudaSuccess;
    }
  };
  template <class Op, typename T>
  struct Shape {
    static cudaError_t run(int* out) {
      using G = GridOf<Op, T>;
      out[0] = G::kWarps, out[1] = G::kItems, out[2] = G::kStages;
      return cudaSuccess;
    }
  };
};
template <template <class, typename> class Launch, typename T, typename... Args>
cudaError_t sweep_op(Args... args) {
  if constexpr (GPS_GRID_SWEEP == 0) return Launch<QuatChain<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 1) return Launch<Filter<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 2) return Launch<RtsSuffix<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 3) return Launch<Mobius<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 4) return Launch<Affine3<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 5) return Launch<Add2<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 6) return Launch<Max3<T>, T>::run(args...);
  if constexpr (GPS_GRID_SWEEP == 7) return Launch<Min3<T>, T>::run(args...);
  return cudaErrorInvalidValue;
}
#define GPS_SWEEP_SHAPES(X) \
  X(8, 4, 2) X(8, 4, 3) X(8, 2, 2) X(8, 2, 3) X(7, 2, 2) X(4, 4, 2) X(12, 4, 2) X(16, 2, 2) X(16, 4, 2)
#endif

}  // namespace

#ifndef GPS_GRID_SWEEP
// Op codes are the order of ops/scan.py:OPS. `in` and `out` are (L, batch,
// n) leaves, each of the `batch` rows scanned on its own; `scratch` holds
// gps_scan_tiled_scratch_bytes(op, dtype, n, batch) bytes. Returns a
// cudaError_t.
GPS_EXPORT int gps_scan_tiled(int op, int dtype, const void* in, void* out, void* scratch,
                              long long scratch_bytes, int n, int batch, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GPS_F32)
    return (int)dispatch_op<TiledScan, float>(op, in, out, scratch, scratch_bytes, n, batch, reverse, s);
  if (dtype == GPS_F64)
    return (int)dispatch_op<TiledScan, double>(op, in, out, scratch, scratch_bytes, n, batch, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Scratch bytes of gps_scan_tiled for `batch` rows of n elements; -1 for an
// unknown op or dtype.
GPS_EXPORT long long gps_scan_tiled_scratch_bytes(int op, int dtype, int n, int batch) {
  long long bytes = -1;
  if (dtype == GPS_F32) dispatch_op<TiledScratch, float>(op, n, batch, &bytes);
  if (dtype == GPS_F64) dispatch_op<TiledScratch, double>(op, n, batch, &bytes);
  return bytes;
}

// Elements per tile of gps_scan_tiled for this combine and dtype at
// `batch` rows; -1 for an unknown op or dtype.
GPS_EXPORT int gps_scan_tiled_tile(int op, int dtype, int batch) {
  int tile = -1;
  if (dtype == GPS_F32) dispatch_op<TiledTile, float>(op, batch, &tile);
  if (dtype == GPS_F64) dispatch_op<TiledTile, double>(op, batch, &tile);
  return tile;
}

// The batch grid's layout (six ints, TiledGridLayout) on the current
// device; a cudaError_t.
GPS_EXPORT int gps_scan_tiled_grid_layout(int op, int dtype, int* out) {
  if (dtype == GPS_F32) return (int)dispatch_op<TiledGridLayout, float>(op, out);
  if (dtype == GPS_F64) return (int)dispatch_op<TiledGridLayout, double>(op, out);
  return (int)cudaErrorInvalidValue;
}

#endif  // GPS_GRID_SWEEP

#ifdef GPS_GRID_SWEEP
#define GPS_SWEEP_CASE(W, I, S)                                                                          \
  if (variant == k++)                                                                                    \
    return scratch ? (int)sweep_op<Sweep<W, I, S>::Launch, double>(in, out, scratch, scratch_bytes, n, batch, \
                                                                    reverse, stream)                    \
                   : (int)sweep_op<Sweep<W, I, S>::Scratch, double>(n, batch, bytes);
#define GPS_SWEEP_SHAPE(W, I, S)        \
  if (variant == k++) {                 \
    out[0] = W, out[1] = I, out[2] = S; \
    return 0;                           \
  }
// The sweep's variant `variant` (0: GridOf's shape, then GPS_SWEEP_SHAPES),
// float64: with a scratch, launched; without, its scratch bytes written to
// *bytes. -1 past the last variant.
GPS_EXPORT int gps_scan_tiled_variant(int variant, const void* in, void* out, void* scratch, long long scratch_bytes,
                                      int n, int batch, int reverse, void* stream_, long long* bytes) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaGetLastError();  // a variant the card refused leaves its error behind; it is not this one's
  if (variant == 0)
    return scratch ? (int)sweep_op<SweepGridOf::Launch, double>(in, out, scratch, scratch_bytes, n, batch, reverse,
                                                                 stream)
                   : (int)sweep_op<SweepGridOf::Scratch, double>(n, batch, bytes);
  int k = 1;
  GPS_SWEEP_SHAPES(GPS_SWEEP_CASE)
  return -1;
}
// The sweep's variant `variant`: (warps, items, stages) into out; -1 past
// the last.
GPS_EXPORT int gps_scan_tiled_variant_shape(int variant, int* out) {
  if (variant == 0) return (int)sweep_op<SweepGridOf::Shape, double>(out);
  int k = 1;
  GPS_SWEEP_SHAPES(GPS_SWEEP_SHAPE)
  return -1;
}
GPS_EXPORT const char* gps_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }
#endif

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
