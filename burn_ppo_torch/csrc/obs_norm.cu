// K6 obs_norm_apply / obs_norm_update — the observation normaliser: the
// clipped z-score of every obs, and the merge of a raw obs batch into the
// running per-column (mean, M2, count) state.
//
// Replaces the XLA fusions of burn_ppo_tpu/ppo/normalization.py
// obs_norm_apply (78-83) and obs_norm_update (68-75) (ROADMAP queue B,
// item B3). Plain PyTorch twins: burn_ppo_torch/ppo/normalization.py
// obs_norm_apply_plain and obs_norm_update_plain.
//
// What bounds them on an H100: bytes. Apply reads and writes the [N, D]
// obs once (per rollout step [4096, 86], 2.8 MB; per update [262144, 86],
// 180 MB, ~55 us of HBM time). Update reads the [N, D] batch once (90 MB
// at [262144, 86]). The eager versions are ~10 kernels each, and the
// update makes two passes over the batch (mean, then the squares around
// it).
//
// apply: one thread per element. It reads ``count`` from device memory, so
// the rollout never waits on the device; while count < 2 it is the
// identity. std = max(sqrt(m2 / max(count, 1)), 1e-8), then
// clip((x - mean) / std, -clip, clip), with IEEE division and sqrt (no
// --use_fast_math), the plain version's operation order.
//
// update, two launches:
//   1. every thread keeps one column (its index mod D) and strides down the
//      rows, so a warp reads 32 neighbouring floats; it sums u = x - shift
//      and u^2 in double, shift being the column's first value. Per-thread
//      partials go to scratch.
//   2. one block per column adds the partials in a fixed tree order
//      (deterministic), forms the batch's mean and M2 in double, rounds
//      them to f32 and merges them into the state with Chan's formula in
//      f32, written as the plain version writes it (no contraction into
//      FMAs). The batch statistics differ from the plain version's f32
//      two-pass ones by its rounding, not the kernel's.

#include <cuda_runtime.h>

namespace {

constexpr int MERGE_THREADS = 256;

__global__ void obs_norm_apply_kernel(const float* __restrict__ x,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ m2,
                                      const float* __restrict__ count,
                                      float* __restrict__ out, long total,
                                      int D, float clip) {
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const float c = count[0];
  const float v = x[i];
  if (c < 2.0f) {
    out[i] = v;
    return;
  }
  const int d = static_cast<int>(i % D);
  const float std = fmaxf(sqrtf(m2[d] / fmaxf(c, 1.0f)), 1e-8f);
  const float z = (v - mean[d]) / std;
  out[i] = z < -clip ? -clip : (z > clip ? clip : z);  // NaN passes, as clamp
}

__global__ void obs_norm_partial_kernel(const float* __restrict__ x, long N,
                                        int D, long active,
                                        double* __restrict__ sums,
                                        double* __restrict__ squares) {
  const long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (t >= active) return;
  const double shift = x[t % D];
  double s = 0.0, q = 0.0;
  for (long i = t; i < N * D; i += active) {  // same column: active % D == 0
    const double u = static_cast<double>(x[i]) - shift;
    s += u;
    q += u * u;
  }
  sums[t] = s;
  squares[t] = q;
}

__global__ void obs_norm_merge_kernel(
    const float* __restrict__ x, const double* __restrict__ sums,
    const double* __restrict__ squares, long lanes, long N, int D,
    const float* __restrict__ mean_a, const float* __restrict__ m2_a,
    const float* __restrict__ count_a, float* __restrict__ mean_out,
    float* __restrict__ m2_out, float* __restrict__ count_out) {
  __shared__ double ss[MERGE_THREADS];
  __shared__ double qq[MERGE_THREADS];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0, q = 0.0;
  for (long l = tid; l < lanes; l += MERGE_THREADS) {
    s += sums[l * D + d];
    q += squares[l * D + d];
  }
  ss[tid] = s;
  qq[tid] = q;
  __syncthreads();
  for (int stride = MERGE_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      ss[tid] += ss[tid + stride];
      qq[tid] += qq[tid + stride];
    }
    __syncthreads();
  }
  if (tid != 0) return;
  const double n = static_cast<double>(N);
  const float mean_b = static_cast<float>(static_cast<double>(x[d]) + ss[0] / n);
  const float m2_b = static_cast<float>(fmax(qq[0] - ss[0] * ss[0] / n, 0.0));
  // _welford_merge in f32, operation by operation.
  const float nb = static_cast<float>(N);
  const float ca = count_a[0];
  const float total = __fadd_rn(ca, nb);
  const float safe = fmaxf(total, 1.0f);
  const float delta = __fsub_rn(mean_b, mean_a[d]);
  const float mean = __fadd_rn(mean_a[d], __fmul_rn(delta, __fdiv_rn(nb, safe)));
  const float m2 = __fadd_rn(__fadd_rn(m2_a[d], m2_b),
                             __fmul_rn(__fmul_rn(delta, delta),
                                       __fdiv_rn(__fmul_rn(ca, nb), safe)));
  mean_out[d] = mean;
  m2_out[d] = m2;
  if (d == 0) count_out[0] = total;
}

}  // namespace

extern "C" int obs_norm_apply(const void* x, const void* mean, const void* m2,
                              const void* count, void* out, long N, int D,
                              float clip, void* stream) {
  const long total = N * D;
  if (total <= 0) return 0;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  obs_norm_apply_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(m2), static_cast<const float*>(count),
      static_cast<float*>(out), total, D, clip);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 2 * lanes * D doubles. N >= 1 (an empty batch leaves the state
// as it is; the wrapper does not launch).
extern "C" int obs_norm_update(const void* x, const void* mean, const void* m2,
                               const void* count, void* scratch,
                               void* mean_out, void* m2_out, void* count_out,
                               long N, int D, long lanes, void* stream) {
  if (N <= 0 || D <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long active = lanes * D;
  double* sums = static_cast<double*>(scratch);
  double* squares = sums + active;
  const int threads = 256;
  obs_norm_partial_kernel<<<(active + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(x), N, D, active, sums, squares);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  obs_norm_merge_kernel<<<D, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(x), sums, squares, lanes, N, D,
      static_cast<const float*>(mean), static_cast<const float*>(m2),
      static_cast<const float*>(count), static_cast<float*>(mean_out),
      static_cast<float*>(m2_out), static_cast<float*>(count_out));
  return static_cast<int>(cudaGetLastError());
}
