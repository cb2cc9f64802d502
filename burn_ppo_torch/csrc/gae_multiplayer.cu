// K5 gae_multiplayer_reverse_scan — turn-based multiplayer GAE(gamma,
// lambda) with reward attribution over a [T, E, P] rollout, one launch.
//
// Replaces the XLA reverse lax.scan of burn_ppo_tpu/ops/gae.py
// compute_gae_multiplayer (56-127) (ROADMAP queue B, item B9). Plain
// PyTorch twin: burn_ppo_torch/ops/gae.py compute_gae_multiplayer_plain.
//
// What bounds it on an H100: bytes, then the scan's step latency. At
// [128, 4096, 4] it reads the rewards (8.4 MB), values, dones and acting
// players (2.1 MB each) and writes advantages and returns (2.1 MB each):
// 18.9 MB, 5.65 us of HBM time. The first version (one thread an env in
// blocks of 128, 32 blocks at E = 4096) issued each step's loads only when
// the scan reached that step: one DRAM round trip a step, 0.0335 ms there.
//
// The design:
//   - 32 envs a block (128 blocks at E = 4096), 256 threads. The block's
//     inputs go through a ring of STAGES stages of CHUNK steps in dynamic
//     shared memory, copied by cp.async from all 256 threads (16-byte
//     copies where every run starts on a 16-byte boundary, E % 4 == 0 and
//     aligned buffers; 4-byte copies otherwise). Each step's slice is
//     contiguous: rewards[t, e0:e0+32, :], values, dones and acting[t,
//     e0:e0+32]. Chunk c + 1 is in flight while chunk c is scanned; at T
//     <= 128 every copy is issued before the scan starts.
//   - Warp p scans seat p (P warps; the rest only copy): a seat's reward
//     attribution, GAE and next value evolve on their own, meeting only
//     through the acting seat, so each lane carries three floats and
//     there are P times as many chains in flight as envs. Each step's
//     inputs are loaded while the step before computes.
//   - The acting seat's warp (seat 0's where the acting index selects no
//     seat) writes the step's advantage and return into a static shared
//     array; after the chunk the block stores it row by row, 16 bytes a
//     thread.
//   - The recurrence keeps the first version's expressions, in its order,
//     so that nvcc contracts the same FMAs: its output is the first
//     version's bit for bit (chip_smoke.py --parent checks it).
// Lost designs (chip runs on the H100): the same ring filled by one warp
// (one env a lane, all seats): 2x slower than the first version, one
// warp's cp.async issue capped the block at ~0.4 TB/s; TMA bulk copies
// (four a step, from one lane): 0.025 ms at [128, 4096, 4], held back by
// the small requests; a register ring of D steps a lane: no faster than
// the first version, deeper rings slower. Measured (chip_smoke.py
// --parent, NVIDIA H100 80GB HBM3, 700.00 W, device ms in turns with the
// first version): [64, 4096, 2] 0.00556 (0.01414), [64, 4096, 4] 0.00596
// (0.01736), [128, 4096, 4] 0.0107 (0.0335); bounds 0.0022, 0.0028,
// 0.0057 (PERF.md row B9).
//
// Recurrence, per step in the reference's order (gae.py:85-117), with
// a = acting player and onehot(p) = (p == a):
//   reward_carry *= 1 - done          (before attribution: no credit
//                                      crosses an episode boundary)
//   attributed = reward[a] + reward_carry[a]
//   reward_carry[p] = p == a ? 0 : reward_carry[p] + reward[p]
//   gae_carry *= 1 - done
//   if done > 0.5: next_value[p] = p == a ? next_value[p] : 0
//   delta = attributed + gamma * next_value[a] * (1 - done) - value
//   adv = delta + gamma_lambda * (1 - done) * gae_carry[a]
//   gae_carry[a] = adv; next_value[a] = value; returns = adv + value
// An acting index outside [0, P) selects no seat, as a one-hot of it would.
// gamma_lambda is gamma * lambda formed on the host in double, as the
// reference forms it from two Python floats.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int MAX_PLAYERS = 8;
constexpr int ENVS = 32;      // envs a block, one a lane of each seat's warp
constexpr int THREADS = 256;  // every warp copies; warps 0 .. P-1 scan
constexpr int CHUNK = 64;     // steps a stage
constexpr int STAGES = 2;     // stages of the ring: chunk c + 1 lands while c is scanned

// A stage in floats: rewards [CHUNK][ENVS * P], then values, dones and
// acting players (their int bits) [CHUNK][ENVS] each.
template <int P>
struct Stage {
  static constexpr int VALUES = CHUNK * ENVS * P;
  static constexpr int DONES = VALUES + CHUNK * ENVS;
  static constexpr int ACTING = DONES + CHUNK * ENVS;
  static constexpr int FLOATS = ACTING + CHUNK * ENVS;
};

// The block's copies of steps [t0, t0 + n) of envs [e0, e0 + nb) into a
// stage, in units of W floats spread over all its threads: a step's
// rewards are one run of nb * P floats, its values, dones and acting
// players three runs of nb.
template <int P, bool VEC>
__device__ __forceinline__ void issue(float* stage, const float* __restrict__ rewards,
                                      const float* __restrict__ values,
                                      const float* __restrict__ dones,
                                      const int* __restrict__ acting, int t0, int n, int e0,
                                      int nb, int E, int tid) {
  constexpr int W = VEC ? 4 : 1;
  const int ur = nb * P / W, uv = nb / W, units = ur + 3 * uv;
  // The thread's units tid, tid + THREADS, ...: (step k, unit u) of the
  // chunk, stepped without a division.
  const int dk = THREADS / units, du = THREADS - dk * units;
  for (int k = tid / units, u = tid - k * units; k < n;
       u += du, k += dk + (u >= units), u -= u >= units ? units : 0) {
    int j = u;
    const long row = static_cast<long>(t0 + k) * E + e0;
    if (j < ur) {
      copy_unit<VEC>(stage + k * ENVS * P + j * W, rewards + row * P + j * W);
    } else {
      j -= ur;
      int seg = 0;
      if (j >= uv) j -= uv, seg = 1;
      if (j >= uv) j -= uv, seg = 2;
      const float* src = seg == 0 ? values
                         : seg == 1 ? dones
                                    : reinterpret_cast<const float*>(acting);
      copy_unit<VEC>(stage + Stage<P>::VALUES + seg * CHUNK * ENVS + k * ENVS + j * W,
                     src + row + j * W);
    }
  }
}

template <int P, bool VEC>
__global__ void __launch_bounds__(THREADS) gae_multiplayer_staged_kernel(
    const float* __restrict__ all_rewards, const float* __restrict__ values,
    const float* __restrict__ dones, const int* __restrict__ acting,
    const float* __restrict__ last_vpp, float* __restrict__ advantages,
    float* __restrict__ returns, int T, int E, float gamma, float gamma_lambda) {
  extern __shared__ __align__(16) float smem[];
  // The chunk's advantages and returns, stored in rows after its scan: an
  // array of its own, so that the scan's next loads need not wait for its
  // stores.
  __shared__ __align__(16) float out[2][CHUNK][ENVS];
  __shared__ float discard[MAX_PLAYERS][2][ENVS];  // the stores of a seat that does not act
  const int tid = threadIdx.x, lane = tid & 31, seat = tid >> 5;
  const int e0 = blockIdx.x * ENVS;
  const int nb = min(ENVS, E - e0);
  const int e = e0 + lane;
  const bool scans = seat < P;
  const int chunks = (T + CHUNK - 1) / CHUNK;
  // Chunk c, the scan's c-th from the end, holds steps [lo(c), T - c * CHUNK).
  auto lo = [T](int c) { return max(0, T - (c + 1) * CHUNK); };
  // One commit group a chunk, empty past the last, so that wait_group
  // counts chunks.
  auto start = [&](int c) {
    if (c < chunks) {
      issue<P, VEC>(smem + (c % STAGES) * Stage<P>::FLOATS, all_rewards, values, dones, acting,
                    lo(c), T - c * CHUNK - lo(c), e0, nb, E, tid);
    }
    cp_async_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) start(c);

  // Warp ``seat`` carries that seat's reward attribution, GAE and next
  // value for the lane's env: the seats' chains meet only through the
  // acting player's, so each step is the first version's per-seat
  // expressions in its order.
  float reward_carry = 0.0f, gae_carry = 0.0f, next_value = 0.0f;
  if (scans && lane < nb) next_value = last_vpp[static_cast<long>(e) * P + seat];
  for (int c = 0; c < chunks; ++c) {
    start(c + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // chunk c has landed
    __syncthreads();
    const int l = lo(c), n = T - c * CHUNK - l;
    if (scans) {
      const float* st = smem + (c % STAGES) * Stage<P>::FLOATS;
      // Step k's inputs are loaded while step k + 1 computes (step 0's
      // twice: the index is clamped, so no branch), and every step stores
      // (to ``discard`` where this seat does not write): nothing stops the
      // steps' independent work from overlapping.
      auto in = [&](int k, float& r, float& d, float& v, int& a) {
        r = st[k * ENVS * P + lane * P + seat];
        d = st[Stage<P>::DONES + k * ENVS + lane];
        v = st[Stage<P>::VALUES + k * ENVS + lane];
        a = __float_as_int(st[Stage<P>::ACTING + k * ENVS + lane]);
      };
      float next_rp, next_done, next_value_in;
      int next_a;
      in(n - 1, next_rp, next_done, next_value_in, next_a);
#pragma unroll 4
      for (int k = n - 1; k >= 0; --k) {
        const float rp = next_rp, done = next_done, value = next_value_in;
        const int a = next_a;
        in(k > 0 ? k - 1 : 0, next_rp, next_done, next_value_in, next_a);
        const float keep = 1.0f - done;

        float attributed = 0.0f, nv_acting = 0.0f, gae_acting = 0.0f;
        reward_carry *= keep;
        gae_carry *= keep;
        if (done > 0.5f && seat != a) next_value = 0.0f;
        if (seat == a) {
          attributed = rp + reward_carry;
          reward_carry = 0.0f;
          nv_acting = next_value;
          gae_acting = gae_carry;
        } else {
          reward_carry += rp;
        }
        const float delta = attributed + gamma * nv_acting * keep - value;
        const float adv = delta + gamma_lambda * keep * gae_acting;
        if (seat == a) {
          gae_carry = adv;
          next_value = value;
        }
        // The acting seat's warp writes the step; seat 0's where the
        // acting index selects no seat (its adv from zeros, as a one-hot
        // of it gives).
        const bool writes =
            seat == a || (seat == 0 && static_cast<unsigned>(a) >= static_cast<unsigned>(P));
        *(writes ? &out[0][k][lane] : &discard[seat][0][lane]) = adv;
        *(writes ? &out[1][k][lane] : &discard[seat][1][lane]) = adv + value;
      }
    }
    __syncthreads();
    // The chunk's outputs by rows: 16-byte stores where rows start on a
    // 16-byte boundary (8 threads a row), else 4-byte (32 a row).
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

template <int P, bool VEC>
cudaError_t launch(const void* all_rewards, const void* values, const void* dones,
                   const void* acting, const void* last_vpp, void* advantages, void* returns,
                   int T, int E, float gamma, float gamma_lambda, cudaStream_t stream) {
  auto kernel = gae_multiplayer_staged_kernel<P, VEC>;
  constexpr int most = STAGES * Stage<P>::FLOATS * static_cast<int>(sizeof(float));
  // The attribute once a device, for the whole ring (at P = 8, 180 KB).
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
  const int smem =
      (chunks < STAGES ? chunks : STAGES) * Stage<P>::FLOATS * static_cast<int>(sizeof(float));
  kernel<<<(E + ENVS - 1) / ENVS, THREADS, smem, stream>>>(
      static_cast<const float*>(all_rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones), static_cast<const int*>(acting),
      static_cast<const float*>(last_vpp), static_cast<float*>(advantages),
      static_cast<float*>(returns), T, E, gamma, gamma_lambda);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gae_multiplayer_reverse_scan(
    const void* all_rewards, const void* values, const void* dones,
    const void* acting, const void* last_vpp, void* advantages, void* returns,
    int T, int E, int P, float gamma, float gamma_lambda, void* stream) {
  if (P < 1 || P > MAX_PLAYERS) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || E <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies and stores when every step's runs start on a 16-byte
  // boundary.
  const bool vec = E % 4 == 0 && aligned16(all_rewards) && aligned16(values) &&
                   aligned16(dones) && aligned16(acting) && aligned16(advantages) &&
                   aligned16(returns);
  cudaError_t err = cudaErrorInvalidValue;
  switch (P) {
#define CASE(n)                                                                          \
  case n:                                                                                \
    err = vec ? launch<n, true>(all_rewards, values, dones, acting, last_vpp, advantages, \
                                returns, T, E, gamma, gamma_lambda, s)                   \
              : launch<n, false>(all_rewards, values, dones, acting, last_vpp,           \
                                 advantages, returns, T, E, gamma, gamma_lambda, s);     \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
  }
  return static_cast<int>(err);
}
