// K19 window_report — one update's metrics and episode summaries folded
// into an update window's report: the last update's metrics, the guard
// counters summed, approx_kl and clip_fraction at their window maximum,
// the episode counts and sums summed and player 0's return extrema kept.
//
// Replaces the XLA fusion of burn_ppo_tpu/train.py _aggregate_window
// (333-360), which reduces the W stacked outputs of a window's scan
// (ROADMAP queue B, item B21). Plain PyTorch twin:
// burn_ppo_torch/ppo/window.py window_report_plain.
//
// The port runs a window as a host loop of graph replays, so the report
// is a running fold: one launch at the end of each update's last graph,
// reading that update's outputs where the graph wrote them and the
// window's accumulators in device memory. The window's first-update flag
// (set by the host once a window) makes the fold copy instead of
// combining; the launch clears it, so K18 and this launch of the next
// update combine. The sums run in update order, one f32 add an update.
//
// Bound: a launch; it moves ~0.3 KB. So the design is the shortest chain
// of dependent steps: a table an accumulator entry, built by the host at
// a graph's capture as the graph's own output addresses are fixed (the
// entry's source address, its field's pointer plus the entry's index, and
// its fold), passed by value (__grid_constant__, ~1.2 KB of parameters).
// One warp: lane l folds entries l, l + 32, l + 64, l + 96, each one
// table read, one load of its source and of its accumulator, and one
// branch-free fold; ``*first`` read once a lane; after the warp's barrier
// lane 0 clears the flag.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int MAX_ENTRIES = 128;
constexpr int PER_LANE = MAX_ENTRIES / 32;
enum Op { LAST = 0, SUM = 1, MAX = 2, MIN = 3 };

struct Table {
  const float* src[MAX_ENTRIES];
  uint8_t op[MAX_ENTRIES];
  int n;
};

// jnp.max / jnp.min propagate a NaN (the accumulator's first).
__device__ __forceinline__ float fold(int op, float a, float v) {
  const bool nan = isnan(a) || isnan(v);
  const float pick = isnan(a) ? a : v;
  const float mx = nan ? pick : (v > a ? v : a);
  const float mn = nan ? pick : (v < a ? v : a);
  const float sum = a + v;
  return op == SUM ? sum : op == MAX ? mx : op == MIN ? mn : v;
}

__global__ void __launch_bounds__(32)
    window_report_kernel(const __grid_constant__ Table t, float* __restrict__ acc, int* first) {
  const int lane = threadIdx.x;
  const bool copy = *first != 0;
  float v[PER_LANE], a[PER_LANE];
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int i = lane + 32 * q;
    if (i < t.n) {
      v[q] = *t.src[i];
      a[q] = acc[i];
    }
  }
#pragma unroll
  for (int q = 0; q < PER_LANE; ++q) {
    const int i = lane + 32 * q;
    if (i < t.n) acc[i] = copy ? v[q] : fold(t.op[i], a[q], v[q]);
  }
  __syncwarp();
  if (lane == 0) *first = 0;
}

}  // namespace

// srcs, ops: host arrays of n accumulator entries (the device f32 address
// each entry folds from; its fold, 0 last, 1 sum, 2 max, 3 min); acc: f32,
// at least n entries; first: a device i32 scalar.
extern "C" int window_report(const void* const* srcs, const int* ops, int n, void* acc,
                             void* first, void* stream) {
  if (n < 0 || n > MAX_ENTRIES) return static_cast<int>(cudaErrorInvalidValue);
  Table t = {};
  for (int i = 0; i < n; ++i) {
    if (ops[i] < LAST || ops[i] > MIN) return static_cast<int>(cudaErrorInvalidValue);
    t.src[i] = static_cast<const float*>(srcs[i]);
    t.op[i] = static_cast<uint8_t>(ops[i]);
  }
  t.n = n;
  window_report_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<float*>(acc), static_cast<int*>(first));
  return static_cast<int>(cudaGetLastError());
}
