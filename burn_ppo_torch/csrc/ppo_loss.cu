// K8 ppo_loss — the PPO minibatch loss after the network forward: masked
// log-softmax, ratio, clipped surrogate, (clipped) value loss, entropy
// bonus, the 14 metrics, and dL/dlogits and dL/dvalues, in one forward
// (the backward only scales the saved gradients).
//
// Replaces the non-matmul part of the XLA fusions of
// burn_ppo_tpu/ppo/update.py _minibatch_loss (125-212) under
// jax.value_and_grad (ROADMAP queue B, item B6). Plain PyTorch twin:
// burn_ppo_torch/ppo/update.py ppo_loss_plain.
//
// What bounds it on an H100: bytes, and launches. At M = 65,536 rows and
// A = 7 it reads logits, mask and eight [M] columns and writes the
// gradients, ~7.6 MB, ~2.3 us of HBM time; autograd ran it as ~60 small
// kernels forward and backward.
//
// Three launches:
//   1. ppo_loss_stats: per block, the valid-weighted sums of the advantages
//      (w, w*a, w*a^2) in double, over a grid-stride of rows;
//   2. ppo_loss_rows: every block adds the stats partials in a fixed order
//      (the advantage mean and Bessel std, as the plain version forms them),
//      then one thread per row computes the row's terms and its gradients,
//      and the block reduces 12 metric sums in double in a fixed tree;
//   3. ppo_loss_finalize: one block adds the partials in a fixed order and
//      writes the loss and the 14 metrics. No float atomics: the result is
//      the same from run to run.
// Gradient rules at ties follow JAX: d max(a, b) splits 1/2 - 1/2 where
// a == b, and jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)) passes 1/2
// of the gradient at x == lo or x == hi. Masked actions (additive -1e9)
// have p = 0 and add nothing to the entropy or the gradient.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float MASK_NEG = -1.0e9f;
constexpr int THREADS = 256;
constexpr int NSUM = 12;  // metric sums per block, see ppo_loss_rows

struct AdvStats {
  double wsum;
  float wc, mean, std;
};

// The advantage statistics from the stats partials, added in block order.
__device__ AdvStats adv_stats(const double* __restrict__ stats, int G) {
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int g = 0; g < G; ++g) {
    s0 += stats[3 * g];
    s1 += stats[3 * g + 1];
    s2 += stats[3 * g + 2];
  }
  AdvStats a;
  a.wsum = s0;
  a.wc = fmaxf(static_cast<float>(s0), 1e-8f);
  const double m = s1 / a.wc;
  a.mean = static_cast<float>(m);
  const double ss = fmax(s2 - 2.0 * m * s1 + m * m * s0, 0.0);
  a.std = static_cast<float>(sqrt(ss / fmax(s0 - 1.0, 1.0)));
  return a;
}

// jnp.maximum(a, b) and the shares of its gradient.
__device__ __forceinline__ float jmax(float a, float b, float* ga, float* gb) {
  if (a > b) {
    *ga = 1.0f, *gb = 0.0f;
    return a;
  }
  if (b > a) {
    *ga = 0.0f, *gb = 1.0f;
    return b;
  }
  *ga = 0.5f, *gb = 0.5f;
  return a;
}

// jnp.clip(x, lo, hi) and its derivative.
__device__ __forceinline__ float jclip(float x, float lo, float hi, float* d) {
  const float m1 = fmaxf(lo, x);
  const float d1 = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float m2 = fminf(hi, m1);
  const float d2 = m1 < hi ? 1.0f : (m1 == hi ? 0.5f : 0.0f);
  *d = d1 * d2;
  return m2;
}

template <int N>
__device__ void block_sum(double (*sm)[THREADS], double* v, double* out) {
  const int tid = threadIdx.x;
  for (int j = 0; j < N; ++j) sm[j][tid] = v[j];
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int j = 0; j < N; ++j) sm[j][tid] += sm[j][tid + s];
    }
    __syncthreads();
  }
  if (tid < N) out[tid] = sm[tid][0];
}

__global__ void __launch_bounds__(THREADS) ppo_loss_stats_kernel(
    const float* __restrict__ adv, const float* __restrict__ valid, int M,
    double* __restrict__ stats) {
  __shared__ double sm[3][THREADS];
  double v[3] = {0.0, 0.0, 0.0};
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < M; i += gridDim.x * THREADS) {
    const double w = valid[i], a = adv[i];
    v[0] += w;
    v[1] += w * a;
    v[2] += w * a * a;
  }
  block_sum<3>(sm, v, stats + 3 * blockIdx.x);
}

__global__ void __launch_bounds__(THREADS) ppo_loss_rows_kernel(
    const float* __restrict__ logits, const float* __restrict__ values,
    const float* __restrict__ mask, const int* __restrict__ actions,
    const float* __restrict__ old_lp, const float* __restrict__ adv,
    const float* __restrict__ returns, const float* __restrict__ old_values,
    const float* __restrict__ valid, int M, int A, float eps, float lo, float hi,
    int clip_value, float value_coef, float ent_coef, const double* __restrict__ stats,
    float* __restrict__ dlogits, float* __restrict__ dvalues, double* __restrict__ sums) {
  __shared__ double sm[NSUM][THREADS];
  __shared__ AdvStats st;
  if (threadIdx.x == 0) st = adv_stats(stats, gridDim.x);
  __syncthreads();
  const AdvStats s = st;
  double v[NSUM] = {};
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < M; i += gridDim.x * THREADS) {
    const float* z = logits + static_cast<long>(i) * A;
    const float* mk = mask == nullptr ? nullptr : mask + static_cast<long>(i) * A;
    float zmax = -INFINITY, cnt = 0.0f;
    for (int j = 0; j < A; ++j) {
      const float zj = z[j] + (mk == nullptr ? 0.0f : (mk[j] != 0.0f ? 0.0f : MASK_NEG));
      zmax = fmaxf(zmax, zj);
      if (mk != nullptr) cnt += mk[j];
    }
    float se = 0.0f;
    for (int j = 0; j < A; ++j) {
      const float zj = z[j] + (mk == nullptr ? 0.0f : (mk[j] != 0.0f ? 0.0f : MASK_NEG));
      se += expf(zj - zmax);
    }
    const float lse = logf(se);
    const int a = actions[i];
    float lp = 0.0f, ent = 0.0f;
    for (int j = 0; j < A; ++j) {
      const float zj = z[j] + (mk == nullptr ? 0.0f : (mk[j] != 0.0f ? 0.0f : MASK_NEG));
      const float lj = (zj - zmax) - lse;
      const float pj = expf(lj);
      if (pj > 0.0f) ent += pj * lj;
      if (j == a) lp = lj;
    }
    ent = -ent;
    const float w = valid[i];
    const float log_ratio = lp - old_lp[i];
    const float r = expf(log_ratio);
    const float an = (adv[i] - s.mean) / (s.std + 1e-8f);
    float dclip, g1, g2;
    const float rc = jclip(r, lo, hi, &dclip);
    const float pmax = jmax(-an * r, -an * rc, &g1, &g2);
    const float dpmax_dr = g1 * -an + g2 * (-an * dclip);

    const float val = values[i], ret = returns[i];
    float vl, dvl;
    if (clip_value) {
      const float ov = old_values[i];
      float dd, h1, h2;
      const float vcl = ov + jclip(val - ov, -eps, eps, &dd);
      const float e1 = val - ret, e2 = vcl - ret;
      vl = jmax(e1 * e1, e2 * e2, &h1, &h2);
      dvl = h1 * (2.0f * e1) + h2 * (2.0f * e2 * dd);
    } else {
      const float e1 = val - ret;
      vl = e1 * e1;
      dvl = 2.0f * e1;
    }
    const float coef = w / s.wc;
    dvalues[i] = value_coef * 0.5f * coef * dvl;
    const float dlp = dpmax_dr * r * coef;
    const float dent = ent_coef * coef;
    float* dz = dlogits + static_cast<long>(i) * A;
    for (int j = 0; j < A; ++j) {
      const float zj = z[j] + (mk == nullptr ? 0.0f : (mk[j] != 0.0f ? 0.0f : MASK_NEG));
      const float lj = (zj - zmax) - lse;
      const float pj = expf(lj);
      const float hj = pj > 0.0f ? pj * (lj + ent) : 0.0f;
      dz[j] = dlp * ((j == a ? 1.0f : 0.0f) - pj) + dent * hj;
    }

    const double wd = w;
    const float err = fabsf(val - ret);
    v[0] += wd * pmax;
    v[1] += wd * vl;
    v[2] += wd * ent;
    v[3] += wd * ((r - 1.0f) - log_ratio);
    v[4] += wd * (fabsf(r - 1.0f) > eps ? 1.0 : 0.0);
    v[5] += wd * val;
    v[6] += wd * ret;
    v[7] += wd * err;
    v[8] += wd * static_cast<double>(err) * err;
    v[9] += wd * cnt;
    const float hc = (cnt > 1.0f ? 1.0f : 0.0f) * w;
    const float max_ent = logf(fmaxf(cnt, 1.0f + 1e-8f));
    v[10] += static_cast<double>(ent / fmaxf(max_ent, 1e-8f) * hc);
    v[11] += hc;
  }
  block_sum<NSUM>(sm, v, sums + NSUM * blockIdx.x);
}

// out: [0] loss, then the 14 metrics in METRIC_KEYS order.
__global__ void ppo_loss_finalize_kernel(const double* __restrict__ stats,
                                         const double* __restrict__ sums, int G, int has_mask,
                                         float value_coef, float ent_coef,
                                         float* __restrict__ out) {
  __shared__ double tot[NSUM];
  const int tid = threadIdx.x;
  if (tid < NSUM) {
    double acc = 0.0;
    for (int g = 0; g < G; ++g) acc += sums[NSUM * g + tid];
    tot[tid] = acc;
  }
  __syncthreads();
  if (tid != 0) return;
  const AdvStats s = adv_stats(stats, G);
  const double wc = s.wc;
  const float policy_loss = static_cast<float>(tot[0] / wc);
  const float value_loss = 0.5f * static_cast<float>(tot[1] / wc);
  const float entropy = static_cast<float>(tot[2] / wc);
  const double me = tot[7] / wc;
  const double ss_e = fmax(tot[8] - 2.0 * me * tot[7] + me * me * s.wsum, 0.0);
  const float total = policy_loss + value_loss * value_coef - entropy * ent_coef;
  out[0] = total;
  out[1] = policy_loss;
  out[2] = value_loss;
  out[3] = entropy;
  out[4] = static_cast<float>(tot[3] / wc);  // approx_kl
  out[5] = static_cast<float>(tot[4] / wc);  // clip_fraction
  out[6] = total;                              // total_loss
  out[7] = static_cast<float>(tot[5] / wc);  // value_mean
  out[8] = static_cast<float>(tot[6] / wc);  // returns_mean
  out[9] = s.mean;                             // adv_mean_raw
  out[10] = s.std;                             // adv_std_raw
  out[11] = static_cast<float>(me);            // value_error_mean
  out[12] = static_cast<float>(sqrt(ss_e / fmax(s.wsum - 1.0, 1.0)));  // value_error_std
  out[13] = has_mask ? static_cast<float>(tot[9] / wc) : 0.0f;  // avg_valid_actions
  out[14] = has_mask ? static_cast<float>(tot[10] / fmax(tot[11], 1e-8)) : 0.0f;
}

}  // namespace

// stats: [G, 3] and sums: [G, 12] double scratch; out: [15] f32.
extern "C" int ppo_loss_forward(const void* logits, const void* values, const void* mask,
                                const void* actions, const void* old_lp, const void* adv,
                                const void* returns, const void* old_values,
                                const void* valid, int M, int A, int G, float eps, float lo,
                                float hi, int clip_value, float value_coef, float ent_coef,
                                void* stats, void* sums, void* out, void* dlogits,
                                void* dvalues, void* stream) {
  if (M <= 0 || A < 1 || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ppo_loss_stats_kernel<<<G, THREADS, 0, s>>>(static_cast<const float*>(adv),
                                              static_cast<const float*>(valid), M,
                                              static_cast<double*>(stats));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_rows_kernel<<<G, THREADS, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const float*>(mask), static_cast<const int*>(actions),
      static_cast<const float*>(old_lp), static_cast<const float*>(adv),
      static_cast<const float*>(returns), static_cast<const float*>(old_values),
      static_cast<const float*>(valid), M, A, eps, lo, hi, clip_value, value_coef, ent_coef,
      static_cast<const double*>(stats), static_cast<float*>(dlogits),
      static_cast<float*>(dvalues), static_cast<double*>(sums));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ppo_loss_finalize_kernel<<<1, 32, 0, s>>>(
      static_cast<const double*>(stats), static_cast<const double*>(sums), G,
      mask != nullptr ? 1 : 0, value_coef, ent_coef, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
