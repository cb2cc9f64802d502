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
// obs once (per rollout step [4096, 270], 4.4 MB; on the update batch
// [524288, 270], 1.13 GB, ~0.34 ms of HBM time). Update reads the [N, D]
// batch once (566 MB at [524288, 270]). The eager versions are ~10
// kernels each, and the update makes two passes over the batch (mean,
// then the squares around it).
//
// apply: a grid sized to the card (at most 6 blocks an SM, all resident)
// strides over the flat buffer 16 bytes a thread (float4 loads where the
// input shares the output's alignment, four scalar loads where it does
// not; a scalar head up to the output's 16-byte boundary and a scalar
// tail). Each block reads ``count`` once (the rollout never waits on the
// device; while count < 2 it is the identity) and puts every column's
// mean and std = max(sqrt(m2 / max(count, 1)), 1e-8) into shared memory
// once, the first three columns again after the last, so that a float4's
// four columns d..d+3 need no wrap. A thread's column advances by a
// constant each stride: no 64-bit modulo in the loop. Then
// clip((x - mean) / std, -clip, clip) with IEEE division and sqrt (no
// --use_fast_math): the plain version's operation order, and the same
// bits as the one-thread-per-element kernel it replaced.
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
//   The merge is in place (the stats keep their addresses from update to
//   update, as a CUDA graph of the update needs): block d reads column d
//   before it writes it, and launch 1 copies the old count into the
//   scratch, where launch 2 reads it, so block 0's new count races with no
//   other block's read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int APPLY_THREADS = 256;
constexpr int APPLY_BLOCKS_PER_SM = 6;
constexpr int MAX_APPLY_DIM = 6000;  // 2 x (D + 3) floats of shared memory, under 48 KB
constexpr int MERGE_THREADS = 256;

__device__ __forceinline__ float column_std(float m2, float c) {
  return fmaxf(sqrtf(m2 / fmaxf(c, 1.0f)), 1e-8f);
}

// NaN passes, as clamp lets it.
__device__ __forceinline__ float normalize(float v, float mean, float std, float clip) {
  const float z = (v - mean) / std;
  return z < -clip ? -clip : (z > clip ? clip : z);
}

// One element by index (the head and the tail).
__device__ __forceinline__ void apply_one(const float* x, float* out, long i, int D,
                                          const float* mean_s, const float* std_s,
                                          bool identity, float clip) {
  const int d = static_cast<int>(i % D);
  out[i] = identity ? x[i] : normalize(x[i], mean_s[d], std_s[d], clip);
}

template <bool X_VEC>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (X_VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(p[0], p[1], p[2], p[3]);
  }
}

// X_VEC: x + head is 16-byte aligned as out + head is, so x loads as
// float4 too. Shared memory: mean and std of columns 0..D-1, 0, 1, 2. A
// thread's first float4 is loaded before the column table is built, so
// that its latency and the state's overlap.
template <bool X_VEC>
__global__ void __launch_bounds__(APPLY_THREADS, APPLY_BLOCKS_PER_SM) obs_norm_apply_kernel(
    const float* __restrict__ x, const float* __restrict__ mean, const float* __restrict__ m2,
    const float* __restrict__ count, float* __restrict__ out, long total, int D, int head,
    float clip) {
  extern __shared__ float smem[];
  float* mean_s = smem;
  float* std_s = smem + D + 3;
  const long nvec = (total - head) / 4;
  const long stride = static_cast<long>(gridDim.x) * APPLY_THREADS;
  long v = blockIdx.x * static_cast<long>(APPLY_THREADS) + threadIdx.x;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (v < nvec) a = load4<X_VEC>(x + head + 4 * v);
  const float c = count[0];
  const bool identity = c < 2.0f;
  for (int j = threadIdx.x; j < D + 3; j += APPLY_THREADS) {
    const int d = j % D;
    mean_s[j] = mean[d];
    std_s[j] = column_std(m2[d], c);
  }
  __syncthreads();
  const long tail_at = head + 4 * nvec;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long i = threadIdx.x < 4 ? threadIdx.x : tail_at + threadIdx.x - 4;
    if ((threadIdx.x < 4 && i < head) || (threadIdx.x >= 4 && i < total))
      apply_one(x, out, i, D, mean_s, std_s, identity, clip);
  }
  if (v >= nvec) return;
  const int step = static_cast<int>((4 * stride) % D);
  int d = static_cast<int>((head + 4 * v) % D);
  while (true) {
    if (!identity) {
      a.x = normalize(a.x, mean_s[d], std_s[d], clip);
      a.y = normalize(a.y, mean_s[d + 1], std_s[d + 1], clip);
      a.z = normalize(a.z, mean_s[d + 2], std_s[d + 2], clip);
      a.w = normalize(a.w, mean_s[d + 3], std_s[d + 3], clip);
    }
    *reinterpret_cast<float4*>(out + head + 4 * v) = a;
    v += stride;
    if (v >= nvec) break;
    a = load4<X_VEC>(x + head + 4 * v);
    d += step;
    if (d >= D) d -= D;
  }
}

__global__ void obs_norm_partial_kernel(const float* __restrict__ x, long N,
                                        int D, long active, const float* __restrict__ count_a,
                                        double* __restrict__ sums,
                                        double* __restrict__ squares) {
  const long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (t == 0) squares[active] = count_a[0];  // the old count, for launch 2
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
    float* mean, float* m2, float* __restrict__ count) {
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
  const float ca = static_cast<float>(squares[lanes * D]);
  const float total = __fadd_rn(ca, nb);
  const float safe = fmaxf(total, 1.0f);
  const float mean_a = mean[d];
  const float delta = __fsub_rn(mean_b, mean_a);
  mean[d] = __fadd_rn(mean_a, __fmul_rn(delta, __fdiv_rn(nb, safe)));
  m2[d] = __fadd_rn(__fadd_rn(m2[d], m2_b),
                    __fmul_rn(__fmul_rn(delta, delta), __fdiv_rn(__fmul_rn(ca, nb), safe)));
  if (d == 0) count[0] = total;
}

int multiprocessors() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

}  // namespace

// x: any 4-byte aligned start; D at most 6000.
extern "C" int obs_norm_apply(const void* x, const void* mean, const void* m2,
                              const void* count, void* out, long N, int D,
                              float clip, void* stream) {
  const long total = N * D;
  if (total <= 0) return 0;
  if (D > MAX_APPLY_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = multiprocessors();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const auto xa = reinterpret_cast<std::uintptr_t>(x), oa = reinterpret_cast<std::uintptr_t>(out);
  long head = static_cast<long>(((16 - oa % 16) % 16) / 4);
  if (head > total) head = total;
  const long nvec = (total - head) / 4;
  long blocks = (nvec + APPLY_THREADS - 1) / APPLY_THREADS;
  if (blocks > static_cast<long>(sms) * APPLY_BLOCKS_PER_SM) blocks = sms * APPLY_BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  const size_t smem = 2 * (D + 3) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = (xa - oa) % 16 == 0 ? obs_norm_apply_kernel<true> : obs_norm_apply_kernel<false>;
  kernel<<<static_cast<int>(blocks), APPLY_THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(m2), static_cast<const float*>(count),
      static_cast<float*>(out), total, D, static_cast<int>(head), clip);
  return static_cast<int>(cudaGetLastError());
}

// mean, m2, count: the state, merged into in place. scratch: 2 * lanes *
// D + 1 doubles. N >= 1 (an empty batch leaves the state as it is; the
// wrapper does not launch).
extern "C" int obs_norm_update(const void* x, void* mean, void* m2, void* count, void* scratch,
                               long N, int D, long lanes, void* stream) {
  if (N <= 0 || D <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long active = lanes * D;
  double* sums = static_cast<double*>(scratch);
  double* squares = sums + active;
  const int threads = 256;
  obs_norm_partial_kernel<<<(active + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(x), N, D, active, static_cast<const float*>(count), sums,
      squares);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  obs_norm_merge_kernel<<<D, MERGE_THREADS, 0, s>>>(
      static_cast<const float*>(x), sums, squares, lanes, N, D, static_cast<float*>(mean),
      static_cast<float*>(m2), static_cast<float*>(count));
  return static_cast<int>(cudaGetLastError());
}
