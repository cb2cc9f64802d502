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
// ~(2P + 4) * 4 B per env. On the single-player CartPole path the env step
// K1 (cartpole_step.cu) does the same arithmetic as its epilogue; this
// kernel serves the multiplayer rollouts.
//
// finalize: every position i of the flat [N] rollout is normalised with
// the stats of samples 0..i (inclusive), in coordinates shifted by the
// batch mean: count_i = count0 + sum w, s_i = sum w u, q_i = sum w u^2 for
// u = x - shift, mean_i = (count0 (mean0 - shift) + s_i) / count_i,
// m2_i = m2_0 + count0 (mean0 - shift)^2 + q_i - count_i mean_i^2.
// q_i - count_i mean_i^2 nearly cancels while the count is small, so
// every sum is f64 (ROADMAP C). Bound: bytes, 12-16 B per element.
//
// One cooperative launch (cudaLaunchKernelEx with the cooperative
// attribute) of at most the blocks the card holds at once, so the two
// grid barriers cannot deadlock. Each thread owns ITEMS consecutive
// elements of a tile of FT * ITEMS, each block a contiguous run of tiles;
// the block's first tile (samples, valid and rewards) stays in registers
// across both barriers, later tiles are read again (from L2):
//   1. the block's sums of w and w x, by warp shuffles, into its partial;
//      grid barrier;
//   2. every block's first warp adds all G partials (each lane's loads
//      all in flight, then one fixed shuffle tree), so every block gets
//      the same shift bits; then the block's sums of w, w u and w u^2
//      into its second partial; grid barrier;
//   3. warps 0-2 add the partials of the earlier blocks, one sum each, by
//      the same kind of tree: the block's exclusive prefix. Per tile, the
//      threads' run totals are scanned across the block by warp shuffles
//      (each warp's exclusive scan, then the earlier warps' totals in
//      order), and each thread walks its run to write the normalised
//      rewards (both quotients by the count through one reciprocal,
//      __drcp_rn: within an f64 ulp of two divisions, far inside the
//      tolerances). The thread that owns the last element writes the new
//      stats; a batch without a valid sample leaves them exactly as they
//      were.
// Every sum is taken in a fixed order, so the result does not change from
// run to run; it differs from torch.cumsum's order only in f64 rounding.
// The launch allocates nothing and sets no function attribute, so it can
// be captured into a CUDA graph; the partials' scratch is the caller's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

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

constexpr int FT = 256;               // threads of a finalize block
constexpr int FWARPS = FT / 32;
constexpr int ITEMS = 8;              // consecutive elements per thread
constexpr long TILE = FT * ITEMS;
constexpr int PARTIALS_PER_LANE = 16;           // a warp adds at most 512 partials
constexpr int MAX_BLOCKS = 32 * PARTIALS_PER_LANE;
constexpr unsigned FULL = 0xffffffffu;

struct FinArgs {
  const float* x;
  const float* r;
  const float* w;  // null: every sample counts
  const float* mean0;
  const float* m20;
  const float* count0;
  double* part1;  // [G, 2]: w, w x
  double* part2;  // [G, 3]: w, w u, w u^2
  float* out;
  double* stats;
  long n;
  long tiles;           // tiles in all
  long tiles_per_block;
  float clip;
  bool vec;             // x, r, w and out 16-byte aligned
};

// One thread's ITEMS consecutive elements of a tile; w = 0 past the end.
struct Run {
  float x[ITEMS], r[ITEMS], w[ITEMS];
};

__device__ __forceinline__ void load_run(const FinArgs& a, long begin, Run& run) {
  if (a.vec && begin + ITEMS <= a.n) {
#pragma unroll
    for (int k = 0; k < ITEMS; k += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(a.x + begin + k);
      const float4 r4 = *reinterpret_cast<const float4*>(a.r + begin + k);
      const float4 w4 = a.w != nullptr ? *reinterpret_cast<const float4*>(a.w + begin + k)
                                       : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      run.x[k] = x4.x, run.x[k + 1] = x4.y, run.x[k + 2] = x4.z, run.x[k + 3] = x4.w;
      run.r[k] = r4.x, run.r[k + 1] = r4.y, run.r[k + 2] = r4.z, run.r[k + 3] = r4.w;
      run.w[k] = w4.x, run.w[k + 1] = w4.y, run.w[k + 2] = w4.z, run.w[k + 3] = w4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long i = begin + k;
      const bool in = i < a.n;
      run.x[k] = in ? a.x[i] : 0.0f;
      run.r[k] = in ? a.r[i] : 0.0f;
      run.w[k] = in ? (a.w != nullptr ? a.w[i] : 1.0f) : 0.0f;
    }
  }
}

// Every lane ends with the same bits: a + b == b + a at each level.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The block's sum of each thread's v[0..K), in warp order, into out.
template <int K>
__device__ __forceinline__ void block_sum(const double (&v)[K], double* out,
                                          double (&red)[FWARPS][3]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const double s = warp_sum(v[c]);
    if (lane == 0) red[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = 0.0;
    for (int wi = 0; wi < FWARPS; ++wi) s += red[wi][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// The sum of column c of `count` rows of `width` partials, by one warp:
// lane l loads rows l, l + 32, ... (all its loads in flight at once), adds
// them in order, then a fixed shuffle tree.
__device__ __forceinline__ double sum_partials(const double* part, int width, int c, long count) {
  const int lane = threadIdx.x & 31;
  double v[PARTIALS_PER_LANE];
#pragma unroll
  for (int k = 0; k < PARTIALS_PER_LANE; ++k) {
    const long b = lane + 32L * k;
    v[k] = b < count ? __ldcg(part + b * width + c) : 0.0;
  }
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < PARTIALS_PER_LANE; ++k) s += v[k];
  return warp_sum(s);
}

__device__ __forceinline__ void run_sums(const Run& run, double shift, double (&t)[3]) {
  t[0] = t[1] = t[2] = 0.0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const double w = run.w[k];
    const double u = static_cast<double>(run.x[k]) - shift;
    t[0] += w;
    t[1] += w * u;
    t[2] += w * (u * u);
  }
}

__global__ void __launch_bounds__(FT) return_norm_finalize_kernel(FinArgs a) {
  __shared__ double red[FWARPS][3];
  __shared__ double warp_tot[FWARPS][3];
  __shared__ double bcast[5];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long G = gridDim.x;
  const long tile0 = blockIdx.x * a.tiles_per_block;
  const long tile1 = min(tile0 + a.tiles_per_block, a.tiles);

  // The block's first tile stays in registers; later ones are read again.
  Run first;
  load_run(a, tile0 * TILE + t * ITEMS, first);

  // 1. The block's sums of w and w x.
  double m[2] = {0.0, 0.0};
  auto moments = [&](const Run& run) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      m[0] += static_cast<double>(run.w[i]);
      m[1] += static_cast<double>(run.w[i]) * static_cast<double>(run.x[i]);
    }
  };
  moments(first);
  for (long k = tile0 + 1; k < tile1; ++k) {
    Run later;
    load_run(a, k * TILE + t * ITEMS, later);
    moments(later);
  }
  block_sum<2>(m, a.part1 + 2 * blockIdx.x, red);
  cg::this_grid().sync();

  // 2. The batch shift, the same bits in every block, then the block's
  // sums of w, w u and w u^2.
  if (warp == 0) {
    const double sw = sum_partials(a.part1, 2, 0, G);
    const double swx = sum_partials(a.part1, 2, 1, G);
    if (lane == 0) {
      bcast[0] = sw;
      bcast[1] = a.w != nullptr ? swx / (sw > 1.0 ? sw : 1.0) : swx / static_cast<double>(a.n);
    }
  }
  __syncthreads();
  const double n_valid = bcast[0], shift = bcast[1];
  double first_t[3];
  run_sums(first, shift, first_t);
  double s[3] = {first_t[0], first_t[1], first_t[2]};
  for (long k = tile0 + 1; k < tile1; ++k) {
    Run later;
    load_run(a, k * TILE + t * ITEMS, later);
    double tk[3];
    run_sums(later, shift, tk);
    s[0] += tk[0], s[1] += tk[1], s[2] += tk[2];
  }
  block_sum<3>(s, a.part2 + 3 * blockIdx.x, red);
  cg::this_grid().sync();

  // 3. The block's exclusive prefix: the earlier blocks' sums.
  if (warp < 3) {
    const double p = sum_partials(a.part2, 3, warp, blockIdx.x);
    if (lane == 0) bcast[2 + warp] = p;
  }
  __syncthreads();
  double carry[3] = {bcast[2], bcast[3], bcast[4]};
  const double mean0 = a.mean0[0], m20 = a.m20[0], count0 = a.count0[0];
  const double base_u = __dsub_rn(mean0, shift);
  const double c0_base = __dmul_rn(count0, base_u);
  const double m2_base = __dadd_rn(m20, __dmul_rn(count0, __dmul_rn(base_u, base_u)));

  // One tile: the threads' exclusive prefix within it (each warp's scan by
  // shuffles, then the earlier warps' totals in order), the tile's total
  // carried on, and each thread's run normalised.
  auto normalise = [&](const Run& run, const double (&tk)[3], long begin) {
    double ex[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      double inc = tk[c];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      const double prev = __shfl_up_sync(FULL, inc, 1);
      ex[c] = lane == 0 ? 0.0 : prev;
      if (lane == 31) warp_tot[warp][c] = inc;
    }
    __syncthreads();
    double cw = carry[0], su = carry[1], sq = carry[2];
    for (int wi = 0; wi < warp; ++wi) {
      cw += warp_tot[wi][0];
      su += warp_tot[wi][1];
      sq += warp_tot[wi][2];
    }
    cw += ex[0], su += ex[1], sq += ex[2];
    for (int wi = 0; wi < FWARPS; ++wi) {
      carry[0] += warp_tot[wi][0];
      carry[1] += warp_tot[wi][1];
      carry[2] += warp_tot[wi][2];
    }
    __syncthreads();  // warp_tot is written again by the next tile

    float z[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const double w = run.w[i];
      const double u = static_cast<double>(run.x[i]) - shift;
      cw += w;
      su += w * u;
      sq += w * (u * u);
      const double count_e = __dadd_rn(count0, cw);
      const double safe_c = count_e > 1.0 ? count_e : 1.0;
      // One reciprocal for both quotients: within an f64 ulp of each.
      const double inv_c = __drcp_rn(safe_c);
      const double mean_u = __dmul_rn(__dadd_rn(c0_base, su), inv_c);
      double m2 = __dsub_rn(__dadd_rn(m2_base, sq), __dmul_rn(count_e, __dmul_rn(mean_u, mean_u)));
      m2 = m2 > 0.0 ? m2 : 0.0;
      const float std = static_cast<float>(sqrt(__dadd_rn(__dmul_rn(m2, inv_c), 1e-8)));
      const float rv = run.r[i];
      float zi = __fdiv_rn(rv, std);
      zi = fminf(fmaxf(zi, -a.clip), a.clip);
      z[i] = count_e < 2.0 ? rv : zi;
      if (begin + i == a.n - 1) {
        const bool any = n_valid > 0.0;
        a.stats[0] = any ? __dadd_rn(mean_u, shift) : mean0;
        a.stats[1] = any ? m2 : m20;
        a.stats[2] = any ? count_e : count0;
      }
    }
    if (a.vec && begin + ITEMS <= a.n) {
#pragma unroll
      for (int i = 0; i < ITEMS; i += 4) {
        *reinterpret_cast<float4*>(a.out + begin + i) =
            make_float4(z[i], z[i + 1], z[i + 2], z[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (begin + i < a.n) a.out[begin + i] = z[i];
      }
    }
  };
  normalise(first, first_t, tile0 * TILE + t * ITEMS);
  for (long k = tile0 + 1; k < tile1; ++k) {
    Run later;
    load_run(a, k * TILE + t * ITEMS, later);
    double tk[3];
    run_sums(later, shift, tk);
    normalise(later, tk, k * TILE + t * ITEMS);
  }
}

// The blocks the whole grid may hold at once on the current device.
int finalize_resident_blocks() {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, return_norm_finalize_kernel, FT,
                                                      0) != cudaSuccess)
      return 0;
    resident[dev] = min(sms * per_sm, MAX_BLOCKS);
  }
  return resident[dev];
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

// Doubles of scratch a finalize on the current device may use: 5 per
// block of the largest grid it launches.
extern "C" int return_norm_finalize_scratch_len() { return 5 * finalize_resident_blocks(); }

// samples, rewards, valid (nullable: all count) and normalized: [N] f32;
// mean, m2, count: f32 scalars; stats: f64 [3]; scratch: [scratch_len]
// doubles of the caller's.
extern "C" int return_norm_finalize(const void* samples, const void* rewards, const void* valid,
                                    const void* mean, const void* m2, const void* count,
                                    void* scratch, int scratch_len, void* normalized,
                                    void* stats, long N, float clip, void* stream) {
  const int resident = finalize_resident_blocks();
  if (N <= 0 || resident < 1 || scratch_len < 5 * resident)
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = (N + TILE - 1) / TILE;
  const long per_block = (tiles + resident - 1) / resident;
  const long blocks = (tiles + per_block - 1) / per_block;
  const auto addr = [](const void* b) { return reinterpret_cast<std::uintptr_t>(b); };
  FinArgs a;
  a.x = static_cast<const float*>(samples);
  a.r = static_cast<const float*>(rewards);
  a.w = static_cast<const float*>(valid);
  a.mean0 = static_cast<const float*>(mean);
  a.m20 = static_cast<const float*>(m2);
  a.count0 = static_cast<const float*>(count);
  a.part1 = static_cast<double*>(scratch);
  a.part2 = a.part1 + 2 * blocks;
  a.out = static_cast<float*>(normalized);
  a.stats = static_cast<double*>(stats);
  a.n = N;
  a.tiles = tiles;
  a.tiles_per_block = per_block;
  a.clip = clip;
  a.vec = (addr(samples) | addr(rewards) | addr(valid) | addr(normalized)) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(FT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, return_norm_finalize_kernel, a));
}
