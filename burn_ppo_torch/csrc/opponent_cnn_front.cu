// K20 opponent_cnn_front — the first conv's input of every CNN opponent
// of the rotation: each slot's obs normalisation of the pool block's
// spatial obs, laid out as one grouped-conv input.
//
// Replaces the part of the XLA fusion of burn_ppo_tpu/ppo/pool_rollout.py
// opponent_logits (126-139) that feeds the convs: under jax.vmap over the
// K stacked opponents, each slot's obs_norm_apply of the raw obs and
// models/network.py _cnn_features' reshape of the spatial slice to NHWC
// (187-191), fused into the first conv's operand (ROADMAP queue B, item
// B22). Plain PyTorch twin: burn_ppo_torch/ppo/pool_rollout.py
// opponent_cnn_front_plain.
//
// out[r, k * C + c, h, w] = norm_k(x[r, (h * W + w) * C + c]), with
// norm_k the identity while slot k's count < 2, otherwise
// clip((x - mean) / max(sqrt(m2 / max(count, 1)), 1e-8), -clip, clip)
// in the order of K6 and of the plain version (correctly rounded f32
// division and square root: the same bits). With bf16 set the value is
// rounded to bf16 (to nearest even) and stored widened, the bf16 conv's
// operand rounding; the grouped conv then runs in f32 on it.
//
// What bounds it on an H100: bytes. Every output element is written once
// (at Ep = 1024, K = 8 and Connect Four's 6 x 7 x 2, 2.75 MB), the raw obs
// (0.35 MB) and the K normalisers (5.5 KB) are read once from device
// memory and again from L1/L2 by the K slots: ~0.93 us at 3.35 TB/s.
//
// The design: one thread an output element, in output order, so that the
// stores of a warp are 128 contiguous bytes; the NHWC -> NCHW permute is
// in the load's index. A thread's slot and column pick their mean and
// standard deviation from the [K, D] normalisers, which every block
// reads through L1. No shared memory and no barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    opponent_cnn_front_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                              const float* __restrict__ m2, const float* __restrict__ count,
                              float clip, float* __restrict__ out, long n, int D, int K, int HW,
                              int C, int bf16) {
  for (long i = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * THREADS) {
    const int hw = static_cast<int>(i % HW);
    const long q = i / HW;
    const int c = static_cast<int>(q % C);
    const long q2 = q / C;
    const int k = static_cast<int>(q2 % K);
    const long r = q2 / K;
    const int col = hw * C + c;
    float v = x[r * D + col];
    if (mean != nullptr) {
      const float cnt = count[k];
      if (cnt >= 2.0f) {
        const long d = static_cast<long>(k) * D + col;
        const float sd = fmaxf(sqrtf(m2[d] / fmaxf(cnt, 1.0f)), 1e-8f);
        const float z = (v - mean[d]) / sd;
        v = z < -clip ? -clip : (z > clip ? clip : z);
      }
    }
    if (bf16) v = __bfloat162float(__float2bfloat16_rn(v));
    out[i] = v;
  }
}

}  // namespace

// x: [rows, D] f32 raw obs; norm_mean, norm_m2: [K, D], norm_count: [K]
// (all null: no normalisation); out: [rows, K * C, H, W] f32. The spatial
// slice is x's first H * W * C columns in NHWC order.
extern "C" int opp_cnn_front(const void* x, const void* norm_mean, const void* norm_m2,
                             const void* norm_count, float clip, void* out, int rows, int D, int K,
                             int H, int W, int C, int bf16, void* stream) {
  if (rows < 0 || K < 1 || H < 1 || W < 1 || C < 1 || H * W * C > D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((norm_mean == nullptr) != (norm_m2 == nullptr) ||
      (norm_mean == nullptr) != (norm_count == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long n = static_cast<long>(rows) * K * C * H * W;
  if (n == 0) return 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return static_cast<int>(cudaGetLastError());
    }
  }
  const long want = (n + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 16L * sms ? want : 16L * sms);
  opponent_cnn_front_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(norm_mean),
      static_cast<const float*>(norm_m2), static_cast<const float*>(norm_count), clip,
      static_cast<float*>(out), n, D, K, H * W, C, bf16);
  return static_cast<int>(cudaGetLastError());
}
