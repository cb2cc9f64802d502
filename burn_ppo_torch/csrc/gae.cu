// K3 gae_reverse_scan — single-player GAE(gamma, lambda) over a [T, E]
// rollout, one launch.
//
// Replaces the XLA reverse lax.scan of burn_ppo_tpu/ops/gae.py compute_gae
// (30-53) (ROADMAP queue B, item B4). Plain PyTorch twin:
// burn_ppo_torch/ops/gae.py compute_gae_plain.
//
// What bounds it on an H100: bytes. At [128, 4096] it reads the rewards,
// values and dones (2.1 MB each) and writes advantages and returns (2.1
// MB each): 10.5 MB, 3.1 us of HBM time. The first version (one thread an
// env in blocks of 128, 32 blocks at E = 4096, on a quarter of the SMs)
// issued each step's loads only when the scan reached that step: one DRAM
// round trip a step, 0.0095 ms there.
//
// The design, K5's pipeline (gae_multiplayer.cu) at one seat:
//   - 16 envs a block (256 blocks at E = 4096, two an SM), 256 threads.
//     The block's inputs go through a ring of STAGES stages of CHUNK
//     steps in dynamic shared memory, copied by cp.async from all 256
//     threads (16-byte copies where E % 4 == 0 and the buffers are 16-byte
//     aligned, so that every run starts on a 16-byte boundary; 4-byte
//     copies otherwise). Each step's slice is three contiguous 64-byte
//     runs: rewards[t, e0:e0+16], values and dones. Chunk c + 1 is in
//     flight while chunk c is scanned; at T <= 128 every copy is issued
//     before the scan starts.
//   - Threads 0-15 scan, one env each (an env has one chain); all threads
//     copy and store. Each step's inputs are loaded from shared memory
//     while the step before computes.
//   - The scan writes each step's advantage and return into a static
//     shared array; after the chunk the block stores it row by row, 16
//     bytes a thread where the rows are aligned.
//   - The recurrence keeps the first version's expressions, in its order,
//     so that nvcc contracts the same FMAs: its output is the first
//     version's bit for bit (chip_smoke.py --parent checks it).
// Measured (scripts/gae_variants.py, NVIDIA H100 80GB HBM3, 700.00 W,
// device ms at [128, 4096] in turns with this geometry's 0.0063 and the
// first version's 0.0095): 32 envs a block 0.0064, 64 envs 0.0077;
// 32-step chunks in 4 stages 0.0077 (at 32 envs 0.0075), 16-step chunks
// in 8 stages at 32 envs 0.0100: smaller chunks pay more barriers. The
// bound is 0.0031 (PERF.md row B4).
//
// Recurrence (gae.py:41-53), in the reference's operation order:
//   not_done = 1 - done
//   delta    = reward + gamma * next_value * not_done - value
//   gae      = delta + gamma_lambda * not_done * gae
//   next_value = value; returns = gae + value
// gamma_lambda is gamma * lambda formed on the host in double, as the
// reference forms it from two Python floats.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int ENVS = 16;      // envs a block, one a thread of the scan
constexpr int THREADS = 256;  // every thread copies and stores; threads 0 .. ENVS-1 scan
constexpr int CHUNK = 64;     // steps a stage
constexpr int STAGES = 2;     // stages of the ring: chunk c + 1 lands while c is scanned
// A stage in floats: rewards, values and dones [CHUNK][ENVS] each.
constexpr int VALUES = CHUNK * ENVS;
constexpr int DONES = 2 * CHUNK * ENVS;
constexpr int STAGE_FLOATS = 3 * CHUNK * ENVS;

// The block's copies of steps [t0, t0 + n) of envs [e0, e0 + nb) into a
// stage, in units of W floats spread over all its threads: a step's
// rewards, values and dones are three runs of nb floats.
template <bool VEC>
__device__ __forceinline__ void issue(float* stage, const float* __restrict__ rewards,
                                      const float* __restrict__ values,
                                      const float* __restrict__ dones, int t0, int n, int e0,
                                      int nb, int E, int tid) {
  constexpr int W = VEC ? 4 : 1;
  const int uv = nb / W, units = 3 * uv;
  for (int i = tid; i < n * units; i += THREADS) {
    const int k = i / units, u = i - k * units;
    const int seg = u / uv, j = u - seg * uv;
    const float* src = seg == 0 ? rewards : seg == 1 ? values : dones;
    copy_unit<VEC>(stage + seg * CHUNK * ENVS + k * ENVS + j * W,
                   src + static_cast<long>(t0 + k) * E + e0 + j * W);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) gae_reverse_scan_staged_kernel(
    const float* __restrict__ rewards, const float* __restrict__ values,
    const float* __restrict__ dones, const float* __restrict__ last_values,
    float* __restrict__ advantages, float* __restrict__ returns, int T, int E, float gamma,
    float gamma_lambda) {
  extern __shared__ __align__(16) float smem[];
  // The chunk's advantages and returns, stored in rows after its scan: an
  // array of its own, so that the scan's next loads need not wait for its
  // stores.
  __shared__ __align__(16) float out[2][CHUNK][ENVS];
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * ENVS;
  const int nb = min(ENVS, E - e0);
  const bool scans = tid < ENVS;  // thread tid scans env e0 + tid
  const int chunks = (T + CHUNK - 1) / CHUNK;
  // Chunk c, the scan's c-th from the end, holds steps [lo(c), T - c * CHUNK).
  auto lo = [T](int c) { return max(0, T - (c + 1) * CHUNK); };
  // One commit group a chunk, empty past the last, so that wait_group
  // counts chunks.
  auto start = [&](int c) {
    if (c < chunks) {
      issue<VEC>(smem + (c % STAGES) * STAGE_FLOATS, rewards, values, dones, lo(c),
                 T - c * CHUNK - lo(c), e0, nb, E, tid);
    }
    cp_async_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) start(c);

  float next_value = 0.0f, gae = 0.0f;
  if (tid < nb) next_value = last_values[e0 + tid];
  for (int c = 0; c < chunks; ++c) {
    start(c + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // chunk c has landed
    __syncthreads();
    const int l = lo(c), n = T - c * CHUNK - l;
    if (scans) {
      const float* st = smem + (c % STAGES) * STAGE_FLOATS;
      // Step k's inputs are loaded while step k + 1 computes (step 0's
      // twice: the index is clamped, so no branch).
      float next_r = st[(n - 1) * ENVS + tid];
      float next_v = st[VALUES + (n - 1) * ENVS + tid];
      float next_d = st[DONES + (n - 1) * ENVS + tid];
#pragma unroll 4
      for (int k = n - 1; k >= 0; --k) {
        const float reward = next_r, value = next_v, done = next_d;
        const int kn = k > 0 ? k - 1 : 0;
        next_r = st[kn * ENVS + tid];
        next_v = st[VALUES + kn * ENVS + tid];
        next_d = st[DONES + kn * ENVS + tid];
        const float not_done = 1.0f - done;
        const float delta = reward + gamma * next_value * not_done - value;
        gae = delta + gamma_lambda * not_done * gae;
        out[0][k][tid] = gae;
        out[1][k][tid] = gae + value;
        next_value = value;
      }
    }
    __syncthreads();
    // The chunk's outputs by rows: 16-byte stores where rows start on a
    // 16-byte boundary (4 threads a row), else 4-byte (16 a row).
    constexpr int W = VEC ? 4 : 1, ROW = ENVS / W, ROWS = THREADS / ROW;
    const int j = tid % ROW;
    if (W * j < nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = (h ? returns : advantages) + static_cast<long>(l) * E + e0 + W * j;
        for (int k = tid / ROW; k < n; k += ROWS) {
          if constexpr (VEC) {
            *reinterpret_cast<float4*>(dst + static_cast<long>(k) * E) =
                *reinterpret_cast<const float4*>(&out[h][k][4 * j]);
          } else {
            dst[static_cast<long>(k) * E] = out[h][k][j];
          }
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const void* rewards, const void* values, const void* dones,
                   const void* last_values, void* advantages, void* returns, int T, int E,
                   float gamma, float gamma_lambda, cudaStream_t stream) {
  auto kernel = gae_reverse_scan_staged_kernel<VEC>;
  // The ring's attribute once a device (24 KB at 16 envs a block: under
  // the 48 KB a block takes without it, but not at every geometry
  // scripts/gae_variants.py builds).
  constexpr int most = STAGES * STAGE_FLOATS * static_cast<int>(sizeof(float));
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int chunks = (T + CHUNK - 1) / CHUNK;
  const int smem = (chunks < STAGES ? chunks : STAGES) * STAGE_FLOATS *
                   static_cast<int>(sizeof(float));
  kernel<<<(E + ENVS - 1) / ENVS, THREADS, smem, stream>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones), static_cast<const float*>(last_values),
      static_cast<float*>(advantages), static_cast<float*>(returns), T, E, gamma, gamma_lambda);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gae_reverse_scan(const void* rewards, const void* values,
                                const void* dones, const void* last_values,
                                void* advantages, void* returns, int T, int E,
                                float gamma, float gamma_lambda, void* stream) {
  if (T <= 0 || E <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies and stores when every step's runs start on a 16-byte
  // boundary.
  const bool vec = E % 4 == 0 && aligned16(rewards) && aligned16(values) && aligned16(dones) &&
                   aligned16(advantages) && aligned16(returns);
  const cudaError_t err =
      vec ? launch<true>(rewards, values, dones, last_values, advantages, returns, T, E, gamma,
                         gamma_lambda, s)
          : launch<false>(rewards, values, dones, last_values, advantages, returns, T, E, gamma,
                          gamma_lambda, s);
  return static_cast<int>(err);
}
