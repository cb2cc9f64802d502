// K10 episode_stats — the [T, E] episode logs of an update reduced to the
// window scalars the host tracker reads: count, ret_sum[P], ret0_max,
// ret0_min, len_sum, pts_sum[P] and draws.
//
// Replaces the XLA fusion of burn_ppo_tpu/ppo/episode_stats.py
// summarize_episode_logs (25-61) (ROADMAP queue B, item B14). Plain
// PyTorch twin: burn_ppo_torch/ppo/episode_stats.py
// summarize_episode_logs_plain.
//
// What bounds it on an H100: bytes. It reads completed, total_rewards,
// length and outcome once: at [64, 4096] with P = 2, ~5 MB, ~1.6 us of
// HBM time; the eager reduction was ~30 kernels.
//
// It reads columns [0, L) of [T, E] logs (the vs-pool path summarises the
// learner block only), so no copy of the slice is made. Two launches:
//   1. per block, over a grid-stride of the T x L entries: sums in double
//      (count, lengths, draws, per-player returns and Swiss points) and
//      the max / min of player 0's return over completed episodes;
//   2. one block adds the partials in block order: the same result from
//      run to run.
// Swiss points keep the reference's "1224" tie rule, points = P - (place +
// (tied - 1) / 2) with tied the players sharing the place; an episode with
// a zero placement (the no-outcome sentinel of an invalid move) counts in
// ``count`` but not in the points or the draws.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PLAYERS = 8;

template <int P>
__global__ void __launch_bounds__(THREADS) episode_stats_partial_kernel(
    const float* __restrict__ completed, const float* __restrict__ totals,
    const int* __restrict__ length, const int* __restrict__ outcome, int T, int E, int L,
    double* __restrict__ sums, float* __restrict__ extrema) {
  constexpr int NS = 3 + 2 * P;  // count, len, draws, ret[P], pts[P]
  __shared__ double sm[NS][THREADS];
  __shared__ float smax[THREADS], smin[THREADS];
  double v[NS] = {};
  float mx = -INFINITY, mn = INFINITY;
  const long n = static_cast<long>(T) * L;
  for (long i = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * THREADS) {
    const long t = i / L, e = i % L, idx = t * E + e;
    if (!(completed[idx] > 0.0f)) continue;
    const float* tot = totals + idx * P;
    const int* place = outcome + idx * P;
    v[0] += 1.0;
    v[1] += static_cast<double>(length[idx]);
    bool has_outcome = true, all_first = true;
    for (int p = 0; p < P; ++p) {
      has_outcome = has_outcome && place[p] >= 1;
      all_first = all_first && place[p] == 1;
      v[3 + p] += tot[p];
    }
    if (all_first) v[2] += 1.0;
    mx = fmaxf(mx, tot[0]);
    mn = fminf(mn, tot[0]);
    if (has_outcome) {
      for (int p = 0; p < P; ++p) {
        float tied = 0.0f;
        for (int q = 0; q < P; ++q) tied += place[q] == place[p] ? 1.0f : 0.0f;
        v[3 + P + p] +=
            static_cast<float>(P) - (static_cast<float>(place[p]) + (tied - 1.0f) / 2.0f);
      }
    }
  }
  const int tid = threadIdx.x;
  for (int j = 0; j < NS; ++j) sm[j][tid] = v[j];
  smax[tid] = mx;
  smin[tid] = mn;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      for (int j = 0; j < NS; ++j) sm[j][tid] += sm[j][tid + s];
      smax[tid] = fmaxf(smax[tid], smax[tid + s]);
      smin[tid] = fminf(smin[tid], smin[tid + s]);
    }
    __syncthreads();
  }
  if (tid < NS) sums[NS * blockIdx.x + tid] = sm[tid][0];
  if (tid == 0) {
    extrema[2 * blockIdx.x] = smax[0];
    extrema[2 * blockIdx.x + 1] = smin[0];
  }
}

// out: count, ret_sum[P], ret0_max, ret0_min, len_sum, pts_sum[P], draws.
__global__ void episode_stats_final_kernel(const double* __restrict__ sums,
                                           const float* __restrict__ extrema, int G, int P,
                                           float* __restrict__ out) {
  const int NS = 3 + 2 * P;
  const int j = threadIdx.x;
  if (j < NS) {
    double acc = 0.0;
    for (int g = 0; g < G; ++g) acc += sums[NS * g + j];
    const float a = static_cast<float>(acc);
    if (j == 0) out[0] = a;
    else if (j == 1) out[P + 3] = a;
    else if (j == 2) out[2 * P + 4] = a;
    else if (j < 3 + P) out[1 + (j - 3)] = a;
    else out[P + 4 + (j - 3 - P)] = a;
  } else if (j == NS) {
    float mx = -INFINITY, mn = INFINITY;
    for (int g = 0; g < G; ++g) {
      mx = fmaxf(mx, extrema[2 * g]);
      mn = fminf(mn, extrema[2 * g + 1]);
    }
    out[P + 1] = mx;
    out[P + 2] = mn;
  }
}

template <int P>
cudaError_t launch(const float* completed, const float* totals, const int* length,
                   const int* outcome, int T, int E, int L, int G, double* sums,
                   float* extrema, cudaStream_t s) {
  episode_stats_partial_kernel<P><<<G, THREADS, 0, s>>>(completed, totals, length, outcome, T,
                                                         E, L, sums, extrema);
  return cudaGetLastError();
}

}  // namespace

// sums: [G, 3 + 2P] double and extrema: [G, 2] f32 scratch; out: [5 + 2P] f32.
extern "C" int episode_stats(const void* completed, const void* totals, const void* length,
                             const void* outcome, int T, int E, int L, int P, int G,
                             void* sums, void* extrema, void* out, void* stream) {
  if (T < 0 || L < 0 || L > E || G < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(completed);
  const float* tr = static_cast<const float*>(totals);
  const int* len = static_cast<const int*>(length);
  const int* oc = static_cast<const int*>(outcome);
  double* sm = static_cast<double*>(sums);
  float* ex = static_cast<float*>(extrema);
  cudaError_t err;
  switch (P) {
    case 1: err = launch<1>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 2: err = launch<2>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 3: err = launch<3>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 4: err = launch<4>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 5: err = launch<5>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 6: err = launch<6>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 7: err = launch<7>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    case 8: err = launch<8>(c, tr, len, oc, T, E, L, G, sm, ex, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  episode_stats_final_kernel<<<1, 32, 0, s>>>(sm, ex, G, P, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
