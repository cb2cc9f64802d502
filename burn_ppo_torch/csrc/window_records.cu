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
// One block of 1024 threads walks the flat (t, e) order in tiles of
// 8 x 1024 entries, entry j * 1024 + tid of a tile to thread tid:
//   1. each thread loads its 8 completed flags (coalesced), and the
//      learner's seat of the completed ones only; a warp's ballot gives
//      each entry its rank in the warp and the warp's count (__popc);
//   2. warp 0 scans the 8 x 32 warp counts in entry order (8 a lane, then
//      a shuffle scan over the lanes): each warp's base in the tile and
//      the tile's count;
//   3. a selected entry below ``cap`` reads its placements and slots and
//      writes its row at base + rank; the tile's count carries to the
//      next tile.
// Bound: bytes. At the flagship shape (T = 64, Ep = 1229, P = 4) it
// reads 0.31 MB of completed flags an update, plus 32 bytes of seat,
// placements and the P-1 opponents' slots read and 7 written a completed
// game; a single block is the simple right design, a multi-block
// decoupled look-back the later one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;  // entries a thread a tile
constexpr int TILE = THREADS * ITEMS;
constexpr int MAX_PLAYERS = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
    window_records_kernel(const float* __restrict__ completed, const int* __restrict__ outcome,
                          const int* __restrict__ seat, const int* __restrict__ slots, int T,
                          int E, int L, int P, const int* __restrict__ first, int* total,
                          const int* __restrict__ cap, int8_t* __restrict__ rows) {
  __shared__ int warp_base[ITEMS * WARPS];
  __shared__ int tile_count;
  __shared__ int start_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ep = E - L;
  const int n = T * Ep;
  const int width = 2 * P - 1;
  if (tid == 0) start_count = *first ? 0 : *total;
  __syncthreads();
  const int C = *cap;
  int base = start_count;
  const unsigned below = (1u << lane) - 1u;
  for (int start = 0; start < n; start += TILE) {
    int off[ITEMS];
    int s_seat[ITEMS];
    int rank[ITEMS];
    bool sel[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int idx = start + j * THREADS + tid;
      off[j] = -1;
      if (idx < n) {
        const int t = idx / Ep;
        off[j] = t * E + L + (idx - t * Ep);
      }
    }
    float c[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) c[j] = off[j] >= 0 ? completed[off[j]] : 0.f;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      s_seat[j] = c[j] > 0.f ? seat[off[j]] : -1;
      sel[j] = s_seat[j] >= 0;
      const unsigned ballot = __ballot_sync(FULL, sel[j]);
      rank[j] = __popc(ballot & below);
      if (lane == 0) warp_base[j * WARPS + warp] = __popc(ballot);
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l scans entries [8 l, 8 l + 8) of the (j, warp) order.
      int v[ITEMS];
      int sum = 0;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        v[i] = warp_base[lane * ITEMS + i];
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
      for (int i = 0; i < ITEMS; ++i) {
        warp_base[lane * ITEMS + i] = run;
        run += v[i];
      }
      if (lane == 31) tile_count = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (!sel[j]) continue;
      const int pos = base + warp_base[j * WARPS + warp] + rank[j];
      if (pos >= C) continue;
      const int s = s_seat[j];
      const int* place = outcome + static_cast<long>(off[j]) * P;
      const int* slot = slots + static_cast<long>(off[j]) * P;
      int8_t* row = rows + static_cast<long>(pos) * width;
      row[0] = static_cast<int8_t>(place[s]);
      for (int k = 0; k < P - 1; ++k) {
        const int o = k + (k >= s);
        row[1 + k] = static_cast<int8_t>(slot[o]);
        row[P + k] = static_cast<int8_t>(place[o]);
      }
    }
    base += tile_count;
    __syncthreads();  // warp_base and tile_count are rewritten by the next tile
  }
  if (tid == 0) *total = base;
}

}  // namespace

// completed [T, E] f32, outcome [T, E, P] i32, seat [T, E] i32, slots
// [T, E, P] i32 (the pool block is columns [L, E)); first, total, cap:
// device i32 scalars; rows: [>= cap, 2P - 1] int8.
extern "C" int window_records(const void* completed, const void* outcome, const void* seat,
                              const void* slots, int T, int E, int L, int P, const void* first,
                              void* total, const void* cap, void* rows, void* stream) {
  if (T < 0 || L < 0 || L > E || P < 2 || P > MAX_PLAYERS ||
      static_cast<long>(T) * E > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  window_records_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(completed), static_cast<const int*>(outcome),
      static_cast<const int*>(seat), static_cast<const int*>(slots), T, E, L, P,
      static_cast<const int*>(first), static_cast<int*>(total), static_cast<const int*>(cap),
      static_cast<int8_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}
