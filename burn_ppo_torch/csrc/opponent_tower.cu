// K7's bf16 tower over the raw obs (ROADMAP queue B, item B11b): the
// body of csrc/opponent_tower.cuh with BF16 set and FEAT clear, a cluster
// of CLUSTER blocks a tile of ROWS rows splitting each layer's columns.
// Replaces the bf16 XLA fusion of burn_ppo_tpu/ppo/pool_rollout.py
// opponent_logits (126-139) and the slot selection (170-186); plain twin:
// burn_ppo_torch/ppo/pool_rollout.py opponent_actor_forward_plain on a
// bf16 stack. Its bound: the products at the bf16 tensor cores' rate (the
// slot's packed weights read from L2 by every tile); the design and its
// answers to the parent's latency chain are in the header.

#include "opponent_tower.cuh"

namespace opp_tower {
namespace {

// Rows a tile and blocks a cluster (column slices). 32 x 3, 48 x 2, 48 x
// 3, 32 x 4 and 64 x 4 were slower at the pool blocks (PERF.md, B11b).
constexpr int ROWS = 32, CLUSTER = 2;

__global__ void __launch_bounds__(THREADS, 1)
    opponent_tower_bf16_kernel(const __grid_constant__ Params p) {
  tower<ROWS, CLUSTER, true, false>(p);
}

}  // namespace
}  // namespace opp_tower

using namespace opp_tower;

// The shared-memory layout of a tower (bf16: the bf16 tower's, else the
// f32 feature front's; feat: the feature front's): out[0] the stages,
// out[1] the bytes a stage, out[2] the two input buffers' bytes. Returns
// the dynamic shared memory, or -1 where it does not fit.
extern "C" int opp_tower_layout(const int* widths, int depth, int bf16, int feat, int* out) {
  Params p = {};
  const int smem = feat ? layout(p, widths, depth, FEATURE_ROWS, 1, bf16 != 0)
                        : layout(p, widths, depth, ROWS, CLUSTER, true);
  if (smem > 0) {
    out[0] = p.stages;
    out[1] = p.stage_bytes;
    out[2] = p.scratch_off;
  }
  return smem;
}

// x [rows, widths[0]] f32 raw obs, slot [rows] i32; norm_mean, norm_m2
// ([K, widths[0]]), norm_count ([K]): all null for no normalisation; w:
// depth host pointers to the packed bf16 layers (ppo/opponent_pack.py),
// b: depth host pointers to the f32 biases [K, n_out]; act: 0 none, 1
// relu, 2 tanh; out [rows, head] f32.
extern "C" int opp_tower_forward(const void* x, const void* slot, const void* norm_mean,
                                 const void* norm_m2, const void* norm_count, float clip,
                                 const void* const* w, const void* const* b, const int* widths,
                                 int depth, int act, void* out, int rows, int K, void* stream) {
  Params p = front(x, slot, norm_mean, norm_m2, norm_count, clip, out, rows);
  int err = fill_tower(p, w, b, widths, depth, act, K);
  if (err != 0) return err;
  if (rows == 0) return 0;
  p.obs_stride = widths[0];
  p.obs_off = 0;
  const int smem = layout(p, widths, depth, ROWS, CLUSTER, true);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;
  return launch<ROWS, CLUSTER>(opponent_tower_bf16_kernel, p, smem,
                               static_cast<cudaStream_t>(stream), &smem_set);
}

#ifdef OPP_TOWER_TRACE
// Record the phase marks of every later launch of the bf16 tower and the
// feature front into buf ([blocks, TRACE_SLOTS] u64, %globaltimer ns;
// large enough for the launch's grid), or stop (null).
extern "C" int opp_tower_trace(void* buf) {
  trace_buffer() = static_cast<unsigned long long*>(buf);
  return 0;
}
#endif
