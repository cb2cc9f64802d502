// K2 masked_gumbel_sample — action mask, Gumbel-max sample and log pi(a)
// for one rollout step, one launch.
//
// Replaces the XLA fusion of burn_ppo_tpu/ops/categorical.py
// apply_action_mask + sample_categorical (jax.random.categorical) +
// log_prob_categorical (27-81) as used at burn_ppo_tpu/ppo/rollout.py:249-252
// (ROADMAP queue B, item B2). Plain PyTorch twin:
// burn_ppo_torch/ops/categorical.py masked_sample_plain.
//
// What bounds it on an H100: launch latency, then bytes. At [4096, 49] a
// launch reads 3 x 803 KB (logits, mask, uniforms) and writes 32 KB (~0.7
// us of HBM time); the opponents' calls have 1024-1229 rows. The eager
// version is ~15 kernels (mask add, two logs, add, argmax, log_softmax's
// max/sub/exp/sum/log, gather).
//
// The design: G lanes a row, each lane every G-th entry, ceil(A / G) of
// them in registers; a warp takes 32 / G consecutive rows and a block two
// warps, so that the opponents' 1024 rows of A = 49 make 256 blocks. The row
// max, the argmax and the sum of exps are warp shuffles inside the row's G
// lanes. G = 16 for A > 8 and G = 2 for A <= 8, each lane reading its
// entries where they lie: at those widths a warp's load instruction already
// covers whole 64-byte runs (16 lanes) or the warp's 16 contiguous rows (2
// lanes). Staging the warp's rows in shared memory with 16-byte cp.async
// first (8 or 2 lanes a row) was slower at every width of the main path on
// an H100 (PERF.md).
//
// Semantics:
//   * masked = logits + (mask != 0 ? 0 : -1e9)  (additive mask, finite);
//     without a mask, masked = logits;
//   * Gumbel noise -log(-log(u)) with u in [tiny, 1) supplied by the caller
//     (the port's explicit random source, so tests can replay JAX's draws);
//   * action = argmax(masked + noise), FIRST maximum on ties (jnp.argmax):
//     a lane keeps its first maximum (entries in increasing order), and
//     across lanes (value, index) compares with the lower index winning a
//     tie;
//   * log pi(a) = (masked[a] - max) - log(sum exp(masked - max)), the
//     order of jax.nn.log_softmax; the sum is a tree over the lanes, so its
//     last bits differ from the plain version's (tolerance 1e-5).
// Compiled without --use_fast_math: logf/expf are the accurate ones.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float MASK_NEG = -1.0e9f;
constexpr int MAX_ACTIONS = 64;
constexpr int WARPS = 2;  // per block

// (value, index) of the better of two candidates: the larger value, the
// lower index on a tie; index -1 is no candidate.
__device__ __forceinline__ void better(float& v, int& j, float v2, int j2) {
  if (j2 >= 0 && (j < 0 || v2 > v || (v2 == v && j2 < j))) {
    v = v2;
    j = j2;
  }
}

template <int G>
__global__ void __launch_bounds__(32 * WARPS) masked_gumbel_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ mask,
    const float* __restrict__ uniforms, int* __restrict__ actions,
    float* __restrict__ log_probs, int rows, int A) {
  constexpr int RW = 32 / G;                         // rows per warp
  constexpr int EPL = G >= 8 ? MAX_ACTIONS / G : 8 / G;  // entries per lane, at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (static_cast<long>(blockIdx.x) * WARPS + warp) * RW;
  if (row0 >= rows) return;
  const int nrows = static_cast<int>(min(static_cast<long>(RW), rows - row0));
  const bool has_mask = mask != nullptr;
  const float* z = logits + row0 * A;
  const float* u = uniforms + row0 * A;
  const float* m = has_mask ? mask + row0 * A : nullptr;

  const int rr = lane / G, sub = lane % G;
  const bool live = rr < nrows;
  const int base = rr * A;
  float xs[EPL];
  float mx = -INFINITY, best = -INFINITY;
  int best_j = -1;
#pragma unroll
  for (int k = 0; k < EPL; ++k) {
    const int j = sub + k * G;
    const bool in = live && j < A;
    float x = -INFINITY;
    if (in) {
      x = z[base + j];
      if (has_mask) x += (m[base + j] != 0.0f) ? 0.0f : MASK_NEG;
      const float noisy = x + (-logf(-logf(u[base + j])));
      if (best_j < 0 || noisy > best) {  // strict '>' keeps the first maximum
        best = noisy;
        best_j = j;
      }
    }
    xs[k] = x;
    mx = fmaxf(mx, x);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int j2 = __shfl_xor_sync(0xffffffffu, best_j, o);
    better(best, best_j, v2, j2);
  }
  float se = 0.0f;
#pragma unroll
  for (int k = 0; k < EPL; ++k) se += expf(xs[k] - mx);  // 0 for absent entries
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
  if (live && sub == 0) {
    float xa = z[base + best_j];
    if (has_mask) xa += (m[base + best_j] != 0.0f) ? 0.0f : MASK_NEG;
    actions[row0 + rr] = best_j;
    log_probs[row0 + rr] = (xa - mx) - logf(se);
  }
}

template <int G>
cudaError_t launch(const float* logits, const float* mask, const float* uniforms, int* actions,
                   float* log_probs, int rows, int A, cudaStream_t stream) {
  const long warps = (static_cast<long>(rows) + 32 / G - 1) / (32 / G);
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  masked_gumbel_sample_kernel<G><<<blocks, 32 * WARPS, 0, stream>>>(
      logits, mask, uniforms, actions, log_probs, rows, A);
  return cudaGetLastError();
}

}  // namespace

extern "C" int masked_gumbel_sample(const void* logits, const void* mask,
                                    const void* uniforms, void* actions,
                                    void* log_probs, int rows, int num_actions,
                                    void* stream) {
  if (num_actions < 1 || num_actions > MAX_ACTIONS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  const auto* l = static_cast<const float*>(logits);
  const auto* m = static_cast<const float*>(mask);
  const auto* u = static_cast<const float*>(uniforms);
  auto* a = static_cast<int*>(actions);
  auto* lp = static_cast<float*>(log_probs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = num_actions > 8 ? launch<16>(l, m, u, a, lp, rows, num_actions, s)
                                          : launch<2>(l, m, u, a, lp, rows, num_actions, s);
  return static_cast<int>(err);
}
