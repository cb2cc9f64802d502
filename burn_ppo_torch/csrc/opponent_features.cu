// K7's feature front (ROADMAP queue B, item B11c): the body of
// csrc/opponent_tower.cuh with FEAT set, f32 (3xTF32 products,
// opponent_features_kernel) or bf16 (opponent_features_bf16_kernel), one
// block a tile of FEATURE_ROWS rows of one slot, no cluster: the block
// holds the slot's whole FC tower and head. Replaces the tail of the CNN
// opponents' XLA fusion, burn_ppo_tpu/models/network.py _cnn_features'
// last relu, flatten and concat (187-198) and the FC tower and policy
// head (216-219) under the vmap of ppo/pool_rollout.py opponent_logits;
// plain twin: burn_ppo_torch/ppo/pool_rollout.py
// opponent_features_forward_plain.
// A row of slot k reads its row of K20's output, slot k's last conv: one
// contiguous range of C' H W floats (the packed first layer's rows are in
// that NCHW order), relu'd as it is stored; then its obs columns past the
// spatial slice, normalised by slot k. Its bound: the features' bytes and
// the tower's operations.

#include "opponent_tower.cuh"

namespace opp_tower {
namespace {

__global__ void __launch_bounds__(THREADS, 1)
    opponent_features_kernel(const __grid_constant__ Params p) {
  tower<FEATURE_ROWS, 1, false, true>(p);
}

__global__ void __launch_bounds__(THREADS, 1)
    opponent_features_bf16_kernel(const __grid_constant__ Params p) {
  tower<FEATURE_ROWS, 1, true, true>(p);
}

}  // namespace
}  // namespace opp_tower

using namespace opp_tower;

// opp_tower_forward's arguments up to the stream (the weights packed f32,
// or bf16 with bf16 set; widths[0] the tower's input width feat_len + D -
// spatial), then the last conv's output feat (contiguous [rows,
// feat_len], each row's own slot's C' H W floats, NCHW; before its relu)
// and the raw obs x [rows, D]'s spatial width (its extra columns start
// there; the normalisers are [K, D]).
extern "C" int opp_features_forward(const void* x, const void* slot, const void* norm_mean,
                                    const void* norm_m2, const void* norm_count, float clip,
                                    const void* const* w, const void* const* b, const int* widths,
                                    int depth, int act, void* out, int rows, int K, int bf16,
                                    const void* feat, int feat_len, int spatial, void* stream) {
  Params p = front(x, slot, norm_mean, norm_m2, norm_count, clip, out, rows);
  int err = fill_tower(p, w, b, widths, depth, act, K);
  if (err != 0) return err;
  if (feat == nullptr || feat_len < 1 || feat_len > widths[0] || spatial < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  p.feat = static_cast<const float*>(feat);
  p.feat_len = feat_len;
  p.obs_off = spatial;
  p.obs_stride = spatial + widths[0] - feat_len;
  const int smem = layout(p, widths, depth, FEATURE_ROWS, 1, bf16 != 0);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int smem_set[2] = {0, 0};
  return bf16 ? launch<FEATURE_ROWS, 1>(opponent_features_bf16_kernel, p, smem, s, &smem_set[1])
              : launch<FEATURE_ROWS, 1>(opponent_features_kernel, p, smem, s, &smem_set[0]);
}
