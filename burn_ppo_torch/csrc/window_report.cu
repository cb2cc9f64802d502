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
// The fields come as one parameter struct (their source pointers, lengths,
// operations and offsets into the accumulators), fixed at a graph's
// capture as the graph's own output addresses are. One block, an
// accumulator entry a thread (a [P] field one thread a player).
// Bound: a launch; it moves ~0.3 KB.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int MAX_FIELDS = 48;
constexpr int MAX_ENTRIES = 128;
enum Op { LAST = 0, SUM = 1, MAX = 2, MIN = 3 };

struct Fields {
  const float* src[MAX_FIELDS];
  int len[MAX_FIELDS];
  int op[MAX_FIELDS];
  int off[MAX_FIELDS];
  int n;
};

// jnp.max / jnp.min propagate a NaN.
__device__ __forceinline__ float fold(int op, float a, float v) {
  switch (op) {
    case SUM: return a + v;
    case MAX: return (isnan(a) || isnan(v)) ? (isnan(a) ? a : v) : (v > a ? v : a);
    case MIN: return (isnan(a) || isnan(v)) ? (isnan(a) ? a : v) : (v < a ? v : a);
    default: return v;
  }
}

__global__ void __launch_bounds__(MAX_ENTRIES)
    window_report_kernel(const Fields f, float* __restrict__ acc, int* first) {
  const int i = threadIdx.x;
  const bool copy = *first != 0;
  for (int k = 0; k < f.n; ++k) {
    const int j = i - f.off[k];
    if (j >= 0 && j < f.len[k]) {
      const float v = f.src[k][j];
      acc[i] = copy ? v : fold(f.op[k], acc[i], v);
    }
  }
  __syncthreads();
  if (i == 0) *first = 0;
}

}  // namespace

// srcs, lens, ops: host arrays of n fields (device f32 pointers, lengths,
// operations 0 last, 1 sum, 2 max, 3 min), laid out one after another in
// acc (f32, at least the lengths' sum); first: a device i32 scalar.
extern "C" int window_report(const void* const* srcs, const int* lens, const int* ops, int n,
                             void* acc, void* first, void* stream) {
  if (n < 0 || n > MAX_FIELDS) return static_cast<int>(cudaErrorInvalidValue);
  Fields f;
  int off = 0;
  for (int k = 0; k < n; ++k) {
    if (lens[k] < 1 || ops[k] < LAST || ops[k] > MIN) return static_cast<int>(cudaErrorInvalidValue);
    f.src[k] = static_cast<const float*>(srcs[k]);
    f.len[k] = lens[k];
    f.op[k] = ops[k];
    f.off[k] = off;
    off += lens[k];
  }
  if (off > MAX_ENTRIES) return static_cast<int>(cudaErrorInvalidValue);
  f.n = n;
  window_report_kernel<<<1, MAX_ENTRIES, 0, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<float*>(acc), static_cast<int*>(first));
  return static_cast<int>(cudaGetLastError());
}
