// Tiles of one slot's rows: the prologue that K7's tower and feature front
// (csrc/opponent_tower.cuh) and K20 (csrc/opponent_cnn_front.cu) share.
// Rows [0, rows) each name a slot; a block takes tile ``tile`` of the
// slots' tiles of R rows in slot order (a slot's rows in row order), so
// that every row is in exactly one tile and a block reads one slot's
// weights. Three steps, each block on its own, with no pass before the
// launch:
//   1. count_slots: WARPS warps each count the slots of a contiguous range
//      of rows, a lane four rows (kept for step 3 where the range is one
//      pass), through __match_any_sync and one shared atomic a slot and
//      group of lanes; a row whose slot is outside [0, K) is handed to
//      ``zero_row`` by one block. A block barrier follows, the caller's.
//   2. name_tile: every warp names the block's (slot, first rank, rows)
//      from the counts by itself: lane q owns slots 4q..4q+3, a scan of
//      their tile counts. False past the last tile.
//   3. collect_rows: the tile's row ids in row order, each warp those of
//      its range (a shuffle scan of its lanes' matches). A barrier follows
//      before they are read.

#pragma once

#include <cuda_runtime.h>

namespace slot_tiles {

constexpr int WARPS = 8;  // the warps that scan
constexpr int MAX_SLOTS = 128;

// Step 1's rows of the calling warp, and its lane's first four slots.
struct Scan {
  int r_lo, r_hi;
  int kept[4];
};

template <typename ZeroRow>
__device__ __forceinline__ Scan count_slots(const int* __restrict__ slot, int rows, int K, int warp,
                                            int lane, int (*cnt)[MAX_SLOTS], ZeroRow zero_row) {
  Scan s;
  const int span = (rows + WARPS * 128 - 1) / (WARPS * 128) * 128;
  s.r_lo = min(rows, warp * span);
  s.r_hi = min(rows, s.r_lo + span);
#pragma unroll
  for (int j = 0; j < 4; ++j) s.kept[j] = -1;
  for (int i = lane; i < MAX_SLOTS; i += 32) cnt[warp][i] = 0;
  __syncwarp();
  for (int i0 = s.r_lo; i0 < s.r_hi; i0 += 128) {
    int sl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + 4 * lane + j;
      sl[j] = i < s.r_hi ? __ldg(slot + i) : -1;
      if (i0 == s.r_lo) s.kept[j] = sl[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + 4 * lane + j;
      const bool inside = i < s.r_hi && sl[j] >= 0 && sl[j] < K;
      if (i < s.r_hi && !inside && i % gridDim.x == blockIdx.x) zero_row(i);
      const unsigned same = __match_any_sync(0xffffffffu, inside ? sl[j] : -1);
      if (inside && lane == __ffs(same) - 1) atomicAdd(&cnt[warp][sl[j]], __popc(same));
    }
  }
  return s;
}

__device__ __forceinline__ bool name_tile(int (*cnt)[MAX_SLOTS], int K, int R, int tile,
                                          int lane, int& k, int& rank0, int& seg) {
  int tot[4] = {0, 0, 0, 0}, n[4], tiles_q = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int4 c = *reinterpret_cast<const int4*>(&cnt[w][4 * lane]);
    tot[0] += c.x, tot[1] += c.y, tot[2] += c.z, tot[3] += c.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    n[j] = 4 * lane + j < K ? (tot[j] + R - 1) / R : 0;
    tiles_q += n[j];
  }
  int incl = tiles_q;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  int first = incl - tiles_q, found = -1, fr = 0, fs = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (tile >= first && tile < first + n[j]) {
      found = 4 * lane + j;
      fr = (tile - first) * R;
      fs = min(R, tot[j] - fr);
    }
    first += n[j];
  }
  const unsigned who = __ballot_sync(0xffffffffu, found >= 0);
  if (who == 0) return false;
  const int src = __ffs(who) - 1;
  k = __shfl_sync(0xffffffffu, found, src);
  rank0 = __shfl_sync(0xffffffffu, fr, src);
  seg = __shfl_sync(0xffffffffu, fs, src);
  return true;
}

__device__ __forceinline__ void collect_rows(const int* __restrict__ slot, const Scan& s,
                                             int (*cnt)[MAX_SLOTS], int k, int rank0,
                                             int seg, int warp, int lane, int* rows) {
  int base = 0;
  for (int w = 0; w < warp; ++w) base += cnt[w][k];
  if (base >= rank0 + seg || base + cnt[warp][k] <= rank0) return;
  for (int i0 = s.r_lo; i0 < s.r_hi; i0 += 128) {
    bool m[4];
    int c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + 4 * lane + j;
      m[j] = i < s.r_hi && (i0 == s.r_lo ? s.kept[j] : __ldg(slot + i)) == k;
      c += m[j];
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    int rk = base + incl - c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (m[j]) {
        if (rk >= rank0 && rk < rank0 + seg) rows[rk - rank0] = i0 + 4 * lane + j;
        ++rk;
      }
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}

}  // namespace slot_tiles
