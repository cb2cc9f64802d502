// K9 clip_adam — optax chain(clip_by_global_norm, scale_by_adam) and the
// step p -= lr * u, over every parameter of the network at once.
//
// Replaces the XLA fusion of burn_ppo_tpu/ppo/update.py make_optimizer
// (82-89) and the step at 358-361 (ROADMAP queue B, item B7). Plain
// PyTorch twin: burn_ppo_torch/ppo/update.py clip_adam_plain.
//
// What bounds it on an H100: bytes. The parameters, gradients and both
// moments live in four flat f32 buffers (the network's parameters are
// views of one buffer); the step reads four and writes three: at the 311,304
// parameters of the MLP 512x2 on Connect Four, ~8.7 MB, ~2.6 us of HBM
// time. The per-parameter loop it replaces issued ~10 kernels a tensor.
//
// Two launches:
//   1. clip_adam_norm: per block, the sum of g^2 over a grid-stride of the
//      buffer, in double, reduced in a fixed tree;
//   2. clip_adam_step: every block adds those partials in block order (the
//      global norm, the same in every block and from run to run, never
//      leaving the device), then per element, as optax writes it:
//        g' = norm < max_norm ? g : (g / norm) * max_norm
//        mu = (1 - b1) * g' + b1 * mu,  nu = (1 - b2) * g'^2 + b2 * nu
//        u  = (mu / bc1) / (sqrt(nu / bc2) + eps),  p = p - lr * u
//      with the bias corrections bc = 1 - b^count formed on the host.
//      Not torch's clip_grad_norm_, which scales by max / (norm + 1e-6).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) clip_adam_norm_kernel(
    const float* __restrict__ g, long n, double* __restrict__ partial) {
  __shared__ double sm[THREADS];
  double acc = 0.0;
  for (long i = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * THREADS) {
    const double x = g[i];
    acc += x * x;
  }
  sm[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm[threadIdx.x] += sm[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = sm[0];
}

__global__ void __launch_bounds__(THREADS) clip_adam_step_kernel(
    float* __restrict__ p, const float* __restrict__ g, float* __restrict__ mu,
    float* __restrict__ nu, long n, const double* __restrict__ partial, int G, float lr,
    float max_norm, float eps, float b1, float b2, float one_minus_b1, float one_minus_b2,
    float bc1, float bc2) {
  __shared__ float norm;
  if (threadIdx.x == 0) {
    double ss = 0.0;
    for (int b = 0; b < G; ++b) ss += partial[b];
    norm = static_cast<float>(sqrt(ss));
  }
  __syncthreads();
  const float gn = norm;
  const bool keep = gn < max_norm;
  for (long i = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * THREADS) {
    const float gi = keep ? g[i] : (g[i] / gn) * max_norm;
    const float m = one_minus_b1 * gi + b1 * mu[i];
    const float v = one_minus_b2 * (gi * gi) + b2 * nu[i];
    mu[i] = m;
    nu[i] = v;
    const float u = (m / bc1) / (sqrtf(v / bc2) + eps);
    p[i] = p[i] - lr * u;
  }
}

}  // namespace

// partial: [G] double scratch. All buffers flat, n elements.
extern "C" int clip_adam(void* params, const void* grads, void* mu, void* nu, void* partial,
                         long n, int G, float lr, float max_norm, float eps, float b1, float b2,
                         float one_minus_b1, float one_minus_b2, float bc1, float bc2,
                         void* stream) {
  if (n <= 0 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  clip_adam_norm_kernel<<<G, THREADS, 0, s>>>(static_cast<const float*>(grads), n,
                                              static_cast<double*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  clip_adam_step_kernel<<<G, THREADS, 0, s>>>(
      static_cast<float*>(params), static_cast<const float*>(grads), static_cast<float*>(mu),
      static_cast<float*>(nu), n, static_cast<const double*>(partial), G, lr, max_norm, eps, b1,
      b2, one_minus_b1, one_minus_b2, bc1, bc2);
  return static_cast<int>(cudaGetLastError());
}
