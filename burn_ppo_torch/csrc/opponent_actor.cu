// K7 opponent_actor_forward — the policy logits of every pool env's acting
// opponent: per row, the acting slot's obs normalisation and actor MLP.
//
// Replaces the XLA fusion of burn_ppo_tpu/ppo/pool_rollout.py
// opponent_logits (126-139) and the slot selection (170-186) (ROADMAP
// queue B, item B11). Plain PyTorch twin:
// burn_ppo_torch/ppo/pool_rollout.py opponent_actor_forward_plain.
//
// What bounds it on an H100: operations. JAX runs all K opponents over
// every row and contracts with a one-hot of the acting slot: K times the
// work. Here each row runs its own slot only: at Ep = 1024 rows, the MLP
// 86 -> 512 -> 512 -> 7 is 309,760 MACs a row, 0.63 GFLOP a rollout step,
// ~9.5 us at the 67 TFLOP/s f32 rate without tensor cores; the K = 8
// stacked weights are 9.9 MB, ~3 us of HBM time.
//
// The design, two entry points:
//   1. opp_slot_sort: one block sorts the row indices by slot (a stable
//      counting sort: per slot, a block-wide ballot scan over the rows),
//      giving ``perm`` and the segment starts ``offsets[0..K]``; rows with
//      a slot outside [0, K) land after offsets[K] and are never computed.
//   2. opp_grouped_dense, one launch per layer: a 64 x 64 output tile per
//      block, every row of the tile from ONE slot segment, so the block
//      loads that slot's weight tile into shared memory once for 64 rows
//      (16 x 64 tiles of K and N, 4 x 4 outputs per thread, f32 FMAs).
//      The first layer gathers its rows through ``perm`` and applies the
//      slot's obs normalisation as it loads (the identity while the
//      slot's count < 2, otherwise clip((x - mean) / max(sqrt(m2 /
//      max(count, 1)), 1e-8), -clip, clip), the order of K6 and of the
//      plain version); hidden layers apply relu or tanh; the last layer
//      scatters each row back to its place through ``perm``.
// Sums run in another order than cuBLAS's: the logits agree with the plain
// version to f32 rounding of 512-term dot products.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int SORT_THREADS = 1024;
constexpr int TILE_M = 64;
constexpr int TILE_N = 64;
constexpr int TILE_K = 16;
constexpr int GEMM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void slot_sort_kernel(const int* __restrict__ slot, int rows, int K,
                                 int* __restrict__ perm, int* __restrict__ offsets) {
  __shared__ int warp_sums[SORT_THREADS / 32];
  __shared__ int running;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  int start = 0;
  // Bucket K holds the rows whose slot is out of range.
  for (int k = 0; k <= K; ++k) {
    if (tid == 0) running = 0;
    __syncthreads();
    for (int base = 0; base < rows; base += blockDim.x) {
      const int i = base + tid;
      const int s = i < rows ? slot[i] : -1;
      const int bucket = (s >= 0 && s < K) ? s : K;
      const bool flag = i < rows && bucket == k;
      const unsigned ballot = __ballot_sync(0xffffffffu, flag);
      if (lane == 0) warp_sums[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < warps; ++w) {
        if (w < warp) before += warp_sums[w];
        total += warp_sums[w];
      }
      if (flag) {
        perm[start + running + before + __popc(ballot & ((1u << lane) - 1u))] = i;
      }
      __syncthreads();
      if (tid == 0) running += total;
      __syncthreads();
    }
    if (tid == 0) offsets[k] = start;
    start += running;
    __syncthreads();
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v > 0.0f ? v : 0.0f;
  if (act == 2) return tanhf(v);
  return v;
}

__global__ void __launch_bounds__(GEMM_THREADS) grouped_dense_kernel(
    const float* __restrict__ x, const int* __restrict__ gather,
    const float* __restrict__ norm_mean, const float* __restrict__ norm_m2,
    const float* __restrict__ norm_count, float clip, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, const int* __restrict__ scatter,
    const int* __restrict__ offsets, int K, int n_in, int n_out, int act) {
  // Which slot segment and which 64-row tile of it this block computes.
  int t = blockIdx.x, k = 0, seg0 = 0, seg_rows = 0;
  for (; k < K; ++k) {
    const int n_k = offsets[k + 1] - offsets[k];
    const int tiles = (n_k + TILE_M - 1) / TILE_M;
    if (t < tiles) {
      seg0 = offsets[k] + t * TILE_M;
      seg_rows = min(TILE_M, n_k - t * TILE_M);
      break;
    }
    t -= tiles;
  }
  if (k == K) return;
  const int col0 = blockIdx.y * TILE_N;

  __shared__ float As[TILE_K][TILE_M + 4];
  __shared__ float Bs[TILE_K][TILE_N];
  __shared__ int src_row[TILE_M];
  const int tid = threadIdx.x;
  if (tid < TILE_M) {
    const int p = seg0 + tid;
    src_row[tid] = tid < seg_rows ? (gather != nullptr ? gather[p] : p) : -1;
  }
  const float* wk = w + static_cast<long>(k) * n_in * n_out;
  const bool normed = norm_mean != nullptr;
  float cnt = 0.0f;
  if (normed) cnt = norm_count[k];
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < n_in; k0 += TILE_K) {
    // A tile: 64 rows x 16 inputs, 4 per thread, stored transposed.
    for (int e = tid; e < TILE_M * TILE_K; e += GEMM_THREADS) {
      const int r = e / TILE_K, c = e % TILE_K, kk = k0 + c;
      const int src = src_row[r];
      float v = 0.0f;
      if (src >= 0 && kk < n_in) {
        v = x[static_cast<long>(src) * n_in + kk];
        if (normed && cnt >= 2.0f) {
          const long d = static_cast<long>(k) * n_in + kk;
          const float sd = fmaxf(sqrtf(norm_m2[d] / fmaxf(cnt, 1.0f)), 1e-8f);
          const float z = (v - norm_mean[d]) / sd;
          v = z < -clip ? -clip : (z > clip ? clip : z);
        }
      }
      As[c][r] = v;
    }
    // B tile: 16 inputs x 64 outputs, neighbouring threads on neighbouring columns.
    for (int e = tid; e < TILE_K * TILE_N; e += GEMM_THREADS) {
      const int r = e / TILE_N, c = e % TILE_N, kk = k0 + r, col = col0 + c;
      Bs[r][c] = (kk < n_in && col < n_out) ? wk[static_cast<long>(kk) * n_out + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE_K; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float* bk = b + static_cast<long>(k) * n_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= seg_rows) continue;
    const int p = seg0 + r;
    const long out_row = scatter != nullptr ? scatter[p] : p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < n_out) y[out_row * n_out + col] = activate(acc[i][j] + bk[col], act);
    }
  }
}

}  // namespace

extern "C" int opp_slot_sort(const void* slot, int rows, int K, void* perm, void* offsets,
                             void* stream) {
  if (K < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  slot_sort_kernel<<<1, SORT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot), rows, K, static_cast<int*>(perm),
      static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// act: 0 = none (the policy head), 1 = relu, 2 = tanh.
extern "C" int opp_grouped_dense(const void* x, const void* gather, const void* norm_mean,
                                 const void* norm_m2, const void* norm_count, float clip,
                                 const void* w, const void* b, void* y, const void* scatter,
                                 const void* offsets, int rows, int K, int n_in, int n_out,
                                 int act, void* stream) {
  if (K < 1 || n_in < 1 || n_out < 1 || act < 0 || act > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  const dim3 grid((rows + TILE_M - 1) / TILE_M + K, (n_out + TILE_N - 1) / TILE_N);
  grouped_dense_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(gather),
      static_cast<const float*>(norm_mean), static_cast<const float*>(norm_m2),
      static_cast<const float*>(norm_count), clip, static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(y), static_cast<const int*>(scatter),
      static_cast<const int*>(offsets), K, n_in, n_out, act);
  return static_cast<int>(cudaGetLastError());
}
