// K12 return_norm_roll / return_norm_finalize — the return normaliser:
// the per-step rolling return of the acting player, and the prefix-Welford
// normalisation of a whole rollout's rewards.
//
// Replaces the XLA fusions of burn_ppo_tpu/ppo/normalization.py
// return_norm_roll (105-133) and return_norm_finalize (136-209)
// (ROADMAP queue B, item B5). Plain PyTorch twins:
// burn_ppo_torch/ppo/normalization.py return_norm_roll_plain and
// return_norm_finalize_f64_plain, used for CPU tensors.
//
// roll: one thread per env over its P slots. The acting slot becomes
// returns * gamma + reward, rounded twice as the plain version rounds it
// (__fmul_rn / __fadd_rn: no contraction into one fma), is captured as
// the sample, and is reset to 0 where the episode ended. Bound: bytes,
// ~(2P + 4) * 4 B per env.
//
// finalize: every position i of the flat [N] rollout is normalised with
// the stats of samples 0..i (inclusive), in coordinates shifted by the
// batch mean: count_i = count0 + sum w, s_i = sum w u, q_i = sum w u^2 for
// u = x - shift, mean_i = (count0 (mean0 - shift) + s_i) / count_i,
// m2_i = m2_0 + count0 (mean0 - shift)^2 + q_i - count_i mean_i^2.
// q_i - count_i mean_i^2 nearly cancels while the count is small, so
// every sum is f64 (ROADMAP C). Bound: bytes, 12-16 B per element.
// Three launches, each a grid of G blocks over contiguous chunks:
//   1. block sums of w and w x (the shift's numerator and denominator);
//   2. every block adds the G partials in block order (the same shift in
//      every block), then its chunk's sums of w, w u and w u^2;
//   3. every block derives the shift again and its exclusive offset from
//      the earlier blocks' sums (in block order), then scans its chunk:
//      each thread a run of consecutive elements, the run totals scanned
//      across the block in shared memory, then each run walked again to
//      write the normalised rewards. The thread that owns the last
//      element writes the new stats; a batch without a valid sample
//      leaves them exactly as they were.
// Every sum is taken in a fixed order, so the result does not change from
// run to run; it differs from torch.cumsum's order only in f64 rounding.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void return_norm_roll_kernel(const float* __restrict__ returns,
                                        const float* __restrict__ rewards,
                                        const int* __restrict__ acting,
                                        const float* __restrict__ dones, float gamma,
                                        float* __restrict__ new_returns,
                                        float* __restrict__ samples, int E, int P) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int a = acting[e];
  const bool done = dones[e] != 0.0f;
  const float r = rewards[e];
  for (int p = 0; p < P; ++p) {
    const long i = static_cast<long>(e) * P + p;
    float v = returns[i];
    if (p == a) {
      v = __fadd_rn(__fmul_rn(v, gamma), r);
      samples[e] = v;
      if (done) v = 0.0f;
    }
    new_returns[i] = v;
  }
}

struct Chunk {
  long begin, end;  // this thread's run [begin, end)
};

__device__ __forceinline__ Chunk thread_run(long N, long per_thread) {
  const long block_begin = static_cast<long>(blockIdx.x) * THREADS * per_thread;
  const long begin = block_begin + static_cast<long>(threadIdx.x) * per_thread;
  const long end = begin + per_thread < N ? begin + per_thread : N;
  return {begin < N ? begin : N, end};
}

__device__ __forceinline__ double weight(const float* valid, long i) {
  return valid == nullptr ? 1.0 : static_cast<double>(valid[i]);
}

// Sum of `width` doubles per thread over the block, into out[0, width).
template <int W>
__device__ void block_sum(double (&v)[W], double* out) {
  __shared__ double red[W][THREADS];
  for (int k = 0; k < W; ++k) red[k][threadIdx.x] = v[k];
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
      for (int k = 0; k < W; ++k) red[k][threadIdx.x] += red[k][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < W; ++k) out[k] = red[k][0];
  }
}

__global__ void finalize_moments(const float* __restrict__ x, const float* __restrict__ valid,
                                 long N, long per_thread, double* __restrict__ part1) {
  const Chunk c = thread_run(N, per_thread);
  double v[2] = {0.0, 0.0};
  for (long i = c.begin; i < c.end; ++i) {
    const double w = weight(valid, i);
    v[0] += w;
    v[1] += w * static_cast<double>(x[i]);
  }
  block_sum<2>(v, part1 + 2 * blockIdx.x);
}

// The batch shift, the same in every block: the partials added in block order.
__device__ double batch_shift(const double* part1, int G, bool weighted, long N,
                              double* n_valid) {
  __shared__ double sh[2];
  if (threadIdx.x == 0) {
    double sw = 0.0, swx = 0.0;
    for (int g = 0; g < G; ++g) {
      sw += part1[2 * g];
      swx += part1[2 * g + 1];
    }
    sh[0] = sw;
    sh[1] = weighted ? swx / (sw > 1.0 ? sw : 1.0) : swx / static_cast<double>(N);
  }
  __syncthreads();
  *n_valid = sh[0];
  return sh[1];
}

__global__ void finalize_sums(const float* __restrict__ x, const float* __restrict__ valid,
                              long N, long per_thread, int G, const double* __restrict__ part1,
                              double* __restrict__ part2) {
  double n_valid;
  const double shift = batch_shift(part1, G, valid != nullptr, N, &n_valid);
  const Chunk c = thread_run(N, per_thread);
  double v[3] = {0.0, 0.0, 0.0};
  for (long i = c.begin; i < c.end; ++i) {
    const double w = weight(valid, i);
    const double u = static_cast<double>(x[i]) - shift;
    v[0] += w;
    v[1] += w * u;
    v[2] += w * (u * u);
  }
  block_sum<3>(v, part2 + 3 * blockIdx.x);
}

__global__ void finalize_apply(const float* __restrict__ x, const float* __restrict__ rewards,
                               const float* __restrict__ valid, const float* __restrict__ mean0_p,
                               const float* __restrict__ m20_p, const float* __restrict__ count0_p,
                               long N, long per_thread, int G, const double* __restrict__ part1,
                               const double* __restrict__ part2, float clip,
                               float* __restrict__ normalized, double* __restrict__ stats) {
  __shared__ double base[3];
  __shared__ double scan[3][THREADS];
  double n_valid;
  const double shift = batch_shift(part1, G, valid != nullptr, N, &n_valid);
  if (threadIdx.x == 0) {
    double o[3] = {0.0, 0.0, 0.0};
    for (int g = 0; g < static_cast<int>(blockIdx.x); ++g) {
      for (int k = 0; k < 3; ++k) o[k] += part2[3 * g + k];
    }
    for (int k = 0; k < 3; ++k) base[k] = o[k];
  }
  const Chunk c = thread_run(N, per_thread);
  double t[3] = {0.0, 0.0, 0.0};
  for (long i = c.begin; i < c.end; ++i) {
    const double w = weight(valid, i);
    const double u = static_cast<double>(x[i]) - shift;
    t[0] += w;
    t[1] += w * u;
    t[2] += w * (u * u);
  }
  // Inclusive scan of the run totals across the block (Hillis-Steele).
  for (int k = 0; k < 3; ++k) scan[k][threadIdx.x] = t[k];
  __syncthreads();
  for (int off = 1; off < THREADS; off *= 2) {
    double add[3] = {0.0, 0.0, 0.0};
    if (threadIdx.x >= off) {
      for (int k = 0; k < 3; ++k) add[k] = scan[k][threadIdx.x - off];
    }
    __syncthreads();
    for (int k = 0; k < 3; ++k) scan[k][threadIdx.x] += add[k];
    __syncthreads();
  }
  double cw = base[0], su = base[1], sq = base[2];
  if (threadIdx.x > 0) {
    cw += scan[0][threadIdx.x - 1];
    su += scan[1][threadIdx.x - 1];
    sq += scan[2][threadIdx.x - 1];
  }
  const double mean0 = mean0_p[0], m20 = m20_p[0], count0 = count0_p[0];
  const double base_u = __dsub_rn(mean0, shift);
  const double c0_base = __dmul_rn(count0, base_u);
  const double m2_base = __dadd_rn(m20, __dmul_rn(count0, __dmul_rn(base_u, base_u)));
  for (long i = c.begin; i < c.end; ++i) {
    const double w = weight(valid, i);
    const double u = static_cast<double>(x[i]) - shift;
    cw += w;
    su += w * u;
    sq += w * (u * u);
    const double count_e = __dadd_rn(count0, cw);
    const double safe_c = count_e > 1.0 ? count_e : 1.0;
    const double mean_u = __ddiv_rn(__dadd_rn(c0_base, su), safe_c);
    double m2 = __dsub_rn(__dadd_rn(m2_base, sq), __dmul_rn(count_e, __dmul_rn(mean_u, mean_u)));
    m2 = m2 > 0.0 ? m2 : 0.0;
    const float std = static_cast<float>(sqrt(__dadd_rn(__ddiv_rn(m2, safe_c), 1e-8)));
    const float r = rewards[i];
    float z = __fdiv_rn(r, std);
    z = fminf(fmaxf(z, -clip), clip);
    normalized[i] = count_e < 2.0 ? r : z;
    if (i == N - 1) {
      const bool any = n_valid > 0.0;
      stats[0] = any ? __dadd_rn(mean_u, shift) : mean0;
      stats[1] = any ? m2 : m20;
      stats[2] = any ? count_e : count0;
    }
  }
}

}  // namespace

extern "C" int return_norm_roll(const void* returns, const void* rewards, const void* acting,
                                const void* dones, void* new_returns, void* samples, int E, int P,
                                float gamma, void* stream) {
  if (E <= 0) return 0;
  const int threads = 128;
  return_norm_roll_kernel<<<(E + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(returns), static_cast<const float*>(rewards),
      static_cast<const int*>(acting), static_cast<const float*>(dones), gamma,
      static_cast<float*>(new_returns), static_cast<float*>(samples), E, P);
  return static_cast<int>(cudaGetLastError());
}

// scratch: 5 * G doubles (the [G, 2] moments, then the [G, 3] sums).
extern "C" int return_norm_finalize(const void* samples, const void* rewards, const void* valid,
                                    const void* mean, const void* m2, const void* count,
                                    void* scratch, void* normalized, void* stats, long N, int G,
                                    float clip, void* stream) {
  if (N <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long per_thread = (N + static_cast<long>(G) * THREADS - 1) / (static_cast<long>(G) * THREADS);
  const float* x = static_cast<const float*>(samples);
  const float* w = static_cast<const float*>(valid);
  double* part1 = static_cast<double*>(scratch);
  double* part2 = part1 + 2 * G;
  finalize_moments<<<G, THREADS, 0, st>>>(x, w, N, per_thread, part1);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  finalize_sums<<<G, THREADS, 0, st>>>(x, w, N, per_thread, G, part1, part2);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  finalize_apply<<<G, THREADS, 0, st>>>(
      x, static_cast<const float*>(rewards), w, static_cast<const float*>(mean),
      static_cast<const float*>(m2), static_cast<const float*>(count), N, per_thread, G, part1,
      part2, clip, static_cast<float*>(normalized), static_cast<double*>(stats));
  return static_cast<int>(cudaGetLastError());
}
