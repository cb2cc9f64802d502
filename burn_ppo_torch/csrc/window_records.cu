// K18 window_records — the completed pool games of one update appended, in
// (t, e) order, to an update window's fixed record buffer: a row
// [learner_place | opp_slot x (P-1) | opp_place x (P-1)] of int8 a game,
// the opponents in seat order with the learner's seat skipped.
//
// Replaces the XLA fusion of burn_ppo_tpu/train.py compact_records
// (462-495), the cumsum-scatter stream compaction of a window's pool
// records (ROADMAP queue B, item B20). Plain PyTorch twin:
// burn_ppo_torch/ppo/window.py window_records_plain.
//
// JAX compacts once a window over the W stacked logs, flattened in
// (w, t, e) order. Here each update appends its own logs after the rows
// of the updates before it, at a running count held on the device
// (``total``), restarted where the window's first-update flag is set: the
// appends keep JAX's (w, t, e) order, so the first ``cap`` rows are JAX's
// rows. ``total`` counts every selected game, the ones past ``cap`` too,
// so the host reads min(total, cap) rows and max(total - cap, 0) games
// lost (JAX's pool_record_overflow).
//
// It reads the pool block of the rollout's logs in place: the columns
// [L, E) of [T, E] and [T, E, P] tensors, rows of stride E, no copy.
//
// Bound: bytes. At the flagship shape (T = 64, Ep = 1229, P = 4) it reads
// 0.31 MB of completed flags an update, plus 32 bytes of seat, placements
// and the P-1 opponents' slots read and 7 written a completed game: far
// under a launch, so what costs is the chain of dependent steps. The
// design is one pass of many blocks, a single-pass chained scan with
// decoupled look-back: a block a tile of TILE = 1024 entries (77 tiles at
// the flagship shape, all resident at once), each block
//   1. takes its tile from an atomic ticket, not from blockIdx, so a tile
//      waits only on tiles whose blocks already run;
//   2. loads its entries' completed flags and seats (both coalesced, in
//      one round trip), and for the selected ones their placements and
//      slots, packing each row in registers before any wait;
//   3. counts its selected entries by warp ballots, scans the warp counts
//      (warp 0) and publishes the tile's count (tile 0 its inclusive
//      prefix at once, from ``*first ? 0 : *total``);
//   4. looks back (warp 0, 32 predecessors a step) over the published
//      counts until a predecessor's inclusive prefix, for its base;
//   5. publishes its inclusive prefix; the block of the last tile stores
//      ``total``;
//   6. writes its rows below ``cap`` at base + rank.
// The ticket and the tiles' flags live in scratch made once (``scan``:
// the ticket word, then a word a tile), so a graph replays the launch with
// no clearing launch and no host write: a flag word holds the launch's
// epoch beside the tile's status and count, and words of an older epoch
// read as not yet published; the ticket word holds the epoch and the next
// ticket, and the block that draws the last ticket starts the next epoch
// at ticket 0 (every block of the launch has drawn by then).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // entries a thread
constexpr int TILE = THREADS * ITEMS;
constexpr int COUNTS = ITEMS * WARPS;  // warp counts a tile, in entry order
constexpr int MAX_PLAYERS = 8;
constexpr unsigned FULL = 0xffffffffu;
// A tile's flag word: epoch (bits 34-63), status (32-33), count (0-31).
constexpr unsigned long long AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;
constexpr unsigned long long STATUS = 3ull << 32;

__device__ __forceinline__ unsigned long long load_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// P players: the row of 2P - 1 bytes packed in registers.
template <int P>
__global__ void __launch_bounds__(THREADS)
    window_records_kernel(const float* __restrict__ completed, const int* __restrict__ outcome,
                          const int* __restrict__ seat, const int* __restrict__ slots, int T,
                          int E, int L, const int* __restrict__ first, int* total,
                          const int* __restrict__ cap, int8_t* __restrict__ rows,
                          unsigned long long* scan, int tiles) {
  constexpr int WIDTH = 2 * P - 1, ROW_WORDS = (WIDTH + 3) / 4;
  __shared__ int warp_base[COUNTS];
  __shared__ unsigned long long s_ticket;
  __shared__ int s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. The tile, and the launch's epoch.
  if (tid == 0) s_ticket = atomicAdd(scan, 1ull);
  __syncthreads();
  const unsigned long long ticket = s_ticket;
  const int tile = static_cast<int>(ticket & 0xffffffffull);
  const unsigned long long epoch = ticket >> 32;
  const unsigned long long tag = epoch << 34;
  if (tid == 0 && tile == tiles - 1) {
    // Every block of this launch has drawn: the next launch's epoch, at 0.
    atomicExch(scan, (epoch + 1) << 32);
  }
  unsigned long long* flags = scan + 1;

  // 2. The entries' flags and seats, then the selected entries' rows.
  const int Ep = E - L;
  const int n = T * Ep;
  const int start = tile * TILE;
  int off[ITEMS];
  float c[ITEMS];
  int s_seat[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int idx = start + j * THREADS + tid;
    off[j] = -1;
    if (idx < n) {
      const int t = idx / Ep;
      off[j] = t * E + L + (idx - t * Ep);
    }
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    c[j] = off[j] >= 0 ? completed[off[j]] : 0.f;
    s_seat[j] = off[j] >= 0 ? seat[off[j]] : -1;
  }
  bool sel[ITEMS];
  uint32_t row[ITEMS][ROW_WORDS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    sel[j] = c[j] > 0.f && s_seat[j] >= 0;
#pragma unroll
    for (int q = 0; q < ROW_WORDS; ++q) row[j][q] = 0;
    if (sel[j]) {
      const int s = s_seat[j];
      const int* place = outcome + static_cast<long>(off[j]) * P;
      const int* slot = slots + static_cast<long>(off[j]) * P;
      int v[WIDTH];
      v[0] = place[s];
#pragma unroll
      for (int k = 0; k < P - 1; ++k) {
        const int o = k + (k >= s);
        v[1 + k] = slot[o];
        v[P + k] = place[o];
      }
#pragma unroll
      for (int b = 0; b < WIDTH; ++b) {
        row[j][b >> 2] |= (static_cast<uint32_t>(v[b]) & 0xffu) << (8 * (b & 3));
      }
    }
  }
  // 3. Ranks in the warp by ballot; the tile's warp counts scanned in
  // entry order ((j, warp) order) by warp 0.
  const unsigned below = (1u << lane) - 1u;
  int rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned ballot = __ballot_sync(FULL, sel[j]);
    rank[j] = __popc(ballot & below);
    if (lane == 0) warp_base[j * WARPS + warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int PER = COUNTS / 32;
    int v[PER];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = warp_base[lane * PER + i];
      sum += v[i];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += x;
    }
    int run = incl - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      warp_base[lane * PER + i] = run;
      run += v[i];
    }
    const int count = __shfl_sync(FULL, incl, 31);
    // 4. Publish, look back, publish the inclusive prefix.
    int base = 0;
    if (tile == 0) {
      base = *first ? 0 : *total;
    } else {
      if (lane == 0) store_flag(flags + tile, tag | AGGREGATE | static_cast<uint32_t>(count));
      int pred = tile - 1;
      for (;;) {
        const int i = pred - lane;
        unsigned long long f = 0;
        if (i >= 0) {
          do {
            f = load_flag(flags + i);
          } while ((f & ~(STATUS | 0xffffffffull)) != tag || (f & STATUS) == 0);
        }
        const unsigned prefix = __ballot_sync(FULL, i >= 0 && (f & STATUS) == PREFIX);
        // The lanes up to the nearest prefix (all 32 when there is none).
        const int upto = prefix ? __ffs(prefix) - 1 : 31;
        int x = lane <= upto && i >= 0 ? static_cast<int>(f & 0xffffffffull) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
        base += x;
        if (prefix) break;
        pred -= 32;
      }
    }
    if (lane == 0) {
      const int incl_tile = base + count;
      store_flag(flags + tile, tag | PREFIX | static_cast<uint32_t>(incl_tile));
      if (tile == tiles - 1) *total = incl_tile;
      s_base = base;
    }
  }
  __syncthreads();
  // 6. The rows below cap.
  const int C = *cap;
  const int base = s_base;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (!sel[j]) continue;
    const int pos = base + warp_base[j * WARPS + warp] + rank[j];
    if (pos >= C) continue;
    int8_t* r = rows + static_cast<long>(pos) * WIDTH;
#pragma unroll
    for (int b = 0; b < WIDTH; ++b) r[b] = static_cast<int8_t>(row[j][b >> 2] >> (8 * (b & 3)));
  }
}

template <int P>
void launch(int tiles, cudaStream_t stream, const void* completed, const void* outcome,
            const void* seat, const void* slots, int T, int E, int L, const void* first,
            void* total, const void* cap, void* rows, void* scan) {
  window_records_kernel<P><<<tiles, THREADS, 0, stream>>>(
      static_cast<const float*>(completed), static_cast<const int*>(outcome),
      static_cast<const int*>(seat), static_cast<const int*>(slots), T, E, L,
      static_cast<const int*>(first), static_cast<int*>(total), static_cast<const int*>(cap),
      static_cast<int8_t*>(rows), static_cast<unsigned long long*>(scan), tiles);
}

}  // namespace

// completed [T, E] f32, outcome [T, E, P] i32, seat [T, E] i32, slots
// [T, E, P] i32 (the pool block is columns [L, E)); first, total, cap:
// device i32 scalars; rows: [>= cap, 2P - 1] int8; scan: u64 [1 + tiles],
// zeroed once, kept between launches; tiles: its tile words (at least
// ceil(T (E - L) / 1024), and 1).
extern "C" int window_records(const void* completed, const void* outcome, const void* seat,
                              const void* slots, int T, int E, int L, int P, const void* first,
                              void* total, const void* cap, void* rows, void* scan, int tiles,
                              void* stream) {
  if (T < 0 || L < 0 || L > E || P < 2 || P > MAX_PLAYERS ||
      static_cast<long>(T) * E > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long n = static_cast<long>(T) * (E - L);
  const int need = n == 0 ? 1 : static_cast<int>((n + TILE - 1) / TILE);
  if (need > tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2: launch<2>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    case 3: launch<3>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    case 4: launch<4>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    case 5: launch<5>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    case 6: launch<6>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    case 7: launch<7>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
    default: launch<8>(need, s, completed, outcome, seat, slots, T, E, L, first, total, cap, rows, scan); break;
  }
  return static_cast<int>(cudaGetLastError());
}
