// K15 popart_update / K16 popart_denormalize — PopArt's value normaliser:
// once per update, the valid raw returns merged into the scalar Welford
// stats and the value head rescaled to keep its denormalised outputs;
// every rollout step, the critic's values denormalised where the rollout
// stores them.
//
// Replaces the XLA fusions of burn_ppo_tpu/ppo/normalization.py
// popart_update, popart_rescale_value_head (272-317) and
// popart_denormalize (293-294), as burn_ppo_tpu/ppo/update.py:241-257 and
// ppo/rollout.py:253-254, 355-356 call them (ROADMAP queue B, item B18).
// Plain PyTorch twins: burn_ppo_torch/ppo/normalization.py
// popart_update_rescale_plain and popart_denormalize_plain, used for CPU
// tensors.
//
// update (K15): one cooperative launch (cudaLaunchKernelEx with the
// cooperative attribute) of at most the blocks the card holds at once, so
// the two grid barriers cannot deadlock. Each thread owns ITEMS consecutive
// elements of a tile of FT * ITEMS, each block a contiguous run of tiles;
// the block's first tile (returns and valid) stays in registers across
// both barriers, later tiles are read again (from L2):
//   1. the block's sums of w and w x in f64, by warp shuffles, into its
//      partial; grid barrier;
//   2. every block's first warp adds all G partials (each lane's loads all
//      in flight, then one fixed shuffle tree), so every block has the same
//      batch mean bits, rounded to f32 as the plain version rounds it;
//      then the block's sum of w (x - mean)^2 in f64; grid barrier;
//   3. block 0 adds those partials the same way and merges the batch into
//      (mean, m2, count) in f32 (Chan et al., the plain version's order of
//      operations, each rounded on its own: __fmul_rn / __fadd_rn, no
//      contraction), then, where the new count is >= 2, rescales the head:
//      W' = W * s_old / s_new, b' = (b s_old + mu_old - mu_new) / s_new.
// Every sum is taken in a fixed order, so two calls (and two graph replays)
// give the same bits; the batch sums differ from the plain version's
// torch.sum only in f64 rounding. Bound: bytes, 8 B an element read once.
// The launch allocates nothing and sets no function attribute, so it can
// be captured into a CUDA graph; the partials' scratch is the caller's.
//
// denormalise (K16): a thread an element, y = x * std + mean once the
// count is >= 2 (two roundings, as the plain version), else x; it writes
// the rollout's values slice in place of the copy it replaces.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int FT = 256;  // threads of an update block
constexpr int FWARPS = FT / 32;
constexpr int ITEMS = 8;  // consecutive elements per thread
constexpr long TILE = FT * ITEMS;
constexpr int PARTIALS_PER_LANE = 16;  // a warp adds at most 512 partials
constexpr int MAX_BLOCKS = 32 * PARTIALS_PER_LANE;
constexpr unsigned FULL = 0xffffffffu;
constexpr float POPART_EPS = 1e-4f;

// PopArt's std: 1 before two samples, else sqrt(m2 / max(count, 1) + eps).
__device__ __forceinline__ float popart_std(float m2, float count) {
  if (count < 2.0f) return 1.0f;
  return sqrtf(__fadd_rn(__fdiv_rn(m2, fmaxf(count, 1.0f)), POPART_EPS));
}

struct UpdArgs {
  const float* x;
  const float* w;
  float* mean;
  float* m2;
  float* count;
  float* head_w;  // [H]
  float* head_b;  // [1]
  double* part1;  // [G, 2]: w, w x
  double* part2;  // [G]: w (x - mean)^2
  long n;
  long tiles;
  long tiles_per_block;
  int H;
  bool vec;  // x and w 16-byte aligned
};

struct Run {
  float x[ITEMS], w[ITEMS];
};

__device__ __forceinline__ void load_run(const UpdArgs& a, long begin, Run& run) {
  if (a.vec && begin + ITEMS <= a.n) {
#pragma unroll
    for (int k = 0; k < ITEMS; k += 4) {
      const float4 x4 = *reinterpret_cast<const float4*>(a.x + begin + k);
      const float4 w4 = *reinterpret_cast<const float4*>(a.w + begin + k);
      run.x[k] = x4.x, run.x[k + 1] = x4.y, run.x[k + 2] = x4.z, run.x[k + 3] = x4.w;
      run.w[k] = w4.x, run.w[k + 1] = w4.y, run.w[k + 2] = w4.z, run.w[k + 3] = w4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long i = begin + k;
      const bool in = i < a.n;
      run.x[k] = in ? a.x[i] : 0.0f;
      run.w[k] = in ? a.w[i] : 0.0f;
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
                                          double (&red)[FWARPS][2]) {
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

__global__ void __launch_bounds__(FT) popart_update_kernel(UpdArgs a) {
  __shared__ double red[FWARPS][2];
  __shared__ double bcast[2];
  __shared__ float head[3];  // W scale, new bias, rescale flag
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

  // 2. The batch mean, the same f32 bits in every block, then the block's
  // sum of w (x - mean)^2.
  if (warp == 0) {
    const double sw = sum_partials(a.part1, 2, 0, G);
    const double swx = sum_partials(a.part1, 2, 1, G);
    if (lane == 0) {
      bcast[0] = sw;
      bcast[1] = static_cast<double>(static_cast<float>(swx / (sw > 1.0 ? sw : 1.0)));
    }
  }
  __syncthreads();
  const double mean_b = bcast[1];
  double q[1] = {0.0};
  auto squares = [&](const Run& run) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const double d = static_cast<double>(run.x[i]) - mean_b;
      q[0] += (d * d) * static_cast<double>(run.w[i]);
    }
  };
  squares(first);
  for (long k = tile0 + 1; k < tile1; ++k) {
    Run later;
    load_run(a, k * TILE + t * ITEMS, later);
    squares(later);
  }
  block_sum<1>(q, a.part2 + blockIdx.x, red);
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;

  // 3. Block 0: the merge, then the head.
  if (warp == 0) {
    const double sq = sum_partials(a.part2, 1, 0, G);
    if (lane == 0) {
      const float nb = static_cast<float>(bcast[0]), mb = static_cast<float>(mean_b);
      const float m2b = static_cast<float>(sq);
      const float ma = *a.mean, m2a = *a.m2, ca = *a.count;
      const float total = __fadd_rn(ca, nb);
      const float safe = fmaxf(total, 1.0f);
      const float delta = __fsub_rn(mb, ma);
      const float mean = __fadd_rn(ma, __fmul_rn(delta, __fdiv_rn(nb, safe)));
      const float m2 = __fadd_rn(__fadd_rn(m2a, m2b), __fmul_rn(__fmul_rn(delta, delta),
                                                                __fdiv_rn(__fmul_rn(ca, nb), safe)));
      const bool keep = nb > 0.0f;
      const float new_mean = keep ? mean : ma, new_m2 = keep ? m2 : m2a;
      const float new_count = keep ? total : ca;
      const float s_old = popart_std(m2a, ca), s_new = popart_std(new_m2, new_count);
      const bool rescale = new_count >= 2.0f;
      head[0] = __fdiv_rn(s_old, s_new);
      head[1] = __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(*a.head_b, s_old), ma), new_mean), s_new);
      head[2] = rescale ? 1.0f : 0.0f;
      *a.mean = new_mean;
      *a.m2 = new_m2;
      *a.count = new_count;
    }
  }
  __syncthreads();
  if (head[2] == 0.0f) return;
  const float scale = head[0];
  for (int h = t; h < a.H; h += FT) a.head_w[h] = __fmul_rn(a.head_w[h], scale);
  if (t == 0) *a.head_b = head[1];
}

__global__ void popart_denormalize_kernel(const float* __restrict__ x,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ m2,
                                          const float* __restrict__ count,
                                          float* __restrict__ out, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c = *count, v = x[i];
  out[i] = c < 2.0f ? v : __fadd_rn(__fmul_rn(v, popart_std(*m2, c)), *mean);
}

// The blocks the whole update grid may hold at once on the current device.
int update_resident_blocks() {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, popart_update_kernel, FT, 0) !=
            cudaSuccess)
      return 0;
    resident[dev] = min(sms * per_sm, MAX_BLOCKS);
  }
  return resident[dev];
}

}  // namespace

// Doubles of scratch an update on the current device may use: 3 per block
// of the largest grid it launches.
extern "C" int popart_update_scratch_len() { return 3 * update_resident_blocks(); }

// returns, valid: [N] f32; mean, m2, count: f32 scalars, merged into in
// place; head_w [H] and head_b [1] f32, rescaled in place; scratch:
// [scratch_len] doubles of the caller's.
extern "C" int popart_update(const void* returns, const void* valid, long N, void* mean, void* m2,
                             void* count, void* head_w, void* head_b, int H, void* scratch,
                             int scratch_len, void* stream) {
  const int resident = update_resident_blocks();
  if (N <= 0 || H < 1 || resident < 1 || scratch_len < 3 * resident)
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = (N + TILE - 1) / TILE;
  const long per_block = (tiles + resident - 1) / resident;
  const long blocks = (tiles + per_block - 1) / per_block;
  const auto addr = [](const void* b) { return reinterpret_cast<std::uintptr_t>(b); };
  UpdArgs a;
  a.x = static_cast<const float*>(returns);
  a.w = static_cast<const float*>(valid);
  a.mean = static_cast<float*>(mean);
  a.m2 = static_cast<float*>(m2);
  a.count = static_cast<float*>(count);
  a.head_w = static_cast<float*>(head_w);
  a.head_b = static_cast<float*>(head_b);
  a.part1 = static_cast<double*>(scratch);
  a.part2 = a.part1 + 2 * blocks;
  a.n = N;
  a.tiles = tiles;
  a.tiles_per_block = per_block;
  a.H = H;
  a.vec = (addr(returns) | addr(valid)) % 16 == 0;
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
  return static_cast<int>(cudaLaunchKernelEx(&cfg, popart_update_kernel, a));
}

// x, out: [n] f32 (out may be any slice of a larger buffer); mean, m2,
// count: f32 scalars.
extern "C" int popart_denormalize(const void* x, const void* mean, const void* m2,
                                  const void* count, void* out, long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  popart_denormalize_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(m2), static_cast<const float*>(count), static_cast<float*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}
