// K15 popart_update / K16 popart_denormalize — PopArt's value normaliser:
// once per update, the valid raw returns merged into the scalar Welford
// stats and the value head rescaled to keep its denormalised outputs;
// the bootstrap's values denormalised (each rollout step's are
// denormalised in K2's launch, csrc/masked_gumbel_sample.cu).
//
// Replaces the XLA fusions of burn_ppo_tpu/ppo/normalization.py
// popart_update, popart_rescale_value_head (272-317) and
// popart_denormalize (293-294), as burn_ppo_tpu/ppo/update.py:241-257 and
// ppo/rollout.py:253-254, 355-356 call them (ROADMAP queue B, item B18).
// Plain PyTorch twins: burn_ppo_torch/ppo/normalization.py
// popart_update_rescale_plain and popart_denormalize_plain, used for CPU
// tensors.
//
// update (K15): one ordinary launch, no grid barrier. Each thread owns
// ITEMS consecutive elements of a tile of FT * ITEMS (16-byte loads where
// the buffers allow), each block a contiguous run of tiles, at most
// MAX_BLOCKS blocks. One pass: the block's f64 sums of w, w (x - c) and
// w (x - c)^2 about the shift c, the state's running mean as it was
// before the launch (every block reads it first; 0 on a fresh state), by
// warp shuffles into the block's partial. Then one acq_rel ticket a block
// on an i32 counter in the scratch (K10's take_ticket); the block that
// takes the last ticket:
//   1. adds all partials in block order (thread t blocks t, t + FT, ...,
//      then lanes and warps by one fixed shuffle tree), so the sums have
//      the same bits in every run;
//   2. forms the batch mean f32((S1 + c S0) / max(S0, 1)), as the plain
//      version rounds it, and the batch m2 about that f32 mean m as
//      S2 - 2 (m - c) S1 + (m - c)^2 S0 in f64 (the plain version's
//      sum of w (x - m)^2, up to f64 rounding; never below 0);
//   3. merges the batch into (mean, m2, count) in f32 (Chan et al., the
//      plain version's order of operations, each rounded on its own:
//      __fmul_rn / __fadd_rn, no contraction), then, where the new count
//      is >= 2, rescales the head: W' = W * s_old / s_new,
//      b' = (b s_old + mu_old - mu_new) / s_new;
//   4. sets the ticket back to 0, so that the next launch (or graph
//      replay) starts from 0.
// The batch sums differ from the plain version's torch.sum only in f64
// rounding. Bound: bytes, 8 B an element read once. The launch allocates
// nothing and sets no attribute, so it can be captured into a CUDA
// graph; the partials' scratch is the caller's, zeroed once.
//
// denormalise (K16): a thread an element, y = x * std + mean once the
// count is >= 2 (two roundings, as the plain version; popart.cuh), else x.
// The rollout's steps denormalise in K2's launch (its value epilogue,
// csrc/masked_gumbel_sample.cu, the same operations); K16 is the update's
// one launch, the bootstrap's values.

#include <cuda_runtime.h>

#include <cstdint>

#include "popart.cuh"

namespace {

constexpr int FT = 256;  // threads of an update block
constexpr int FWARPS = FT / 32;
constexpr int ITEMS = 8;  // consecutive elements per thread
constexpr long TILE = FT * ITEMS;
constexpr int MAX_BLOCKS = 1024;  // the grid's cap: a fixed scratch
constexpr int PER_THREAD = MAX_BLOCKS / FT;  // partials a thread of the last block adds
constexpr int NS = 3;  // sums a block: w, w (x - c), w (x - c)^2
constexpr unsigned FULL = 0xffffffffu;
struct UpdArgs {
  const float* x;
  const float* w;
  float* mean;
  float* m2;
  float* count;
  float* head_w;  // [H]
  float* head_b;  // [1]
  double* part;  // [G, NS]
  unsigned* ticket;  // the scratch's last double, 0 between launches
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

// The block's sums of each thread's v[0..NS), warps in order; thread
// c < NS returns sum c (the others 0).
__device__ __forceinline__ double block_sum(const double (&v)[NS], double (&red)[FWARPS][NS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const double s = warp_sum(v[c]);
    if (lane == 0) red[warp][c] = s;
  }
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < NS) {
    for (int wi = 0; wi < FWARPS; ++wi) s += red[wi][threadIdx.x];
  }
  return s;
}

// Takes a ticket: the add happens after this thread's earlier writes are
// visible on the device (release), and the thread that takes the last
// ticket sees every write made before the others (acquire).
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

__global__ void __launch_bounds__(FT) popart_update_kernel(UpdArgs a) {
  __shared__ double red[FWARPS][NS];
  __shared__ bool is_last;
  __shared__ float head[3];  // W scale, new bias, rescale flag
  const int t = threadIdx.x;
  const long tile0 = blockIdx.x * a.tiles_per_block;
  const long tile1 = min(tile0 + a.tiles_per_block, a.tiles);

  // One pass: the block's shifted sums.
  const float ma = *a.mean;
  const double c = static_cast<double>(ma);
  double m[NS] = {0.0, 0.0, 0.0};
  for (long k = tile0; k < tile1; ++k) {
    Run run;
    load_run(a, k * TILE + t * ITEMS, run);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const double w = static_cast<double>(run.w[i]);
      const double wd = w * (static_cast<double>(run.x[i]) - c);
      m[0] += w;
      m[1] += wd;
      m[2] += wd * (static_cast<double>(run.x[i]) - c);
    }
  }
  const double mine = block_sum(m, red);
  // Thread c < NS writes sum c of the partial; then one ticket a block,
  // whose release covers the block's writes (they precede it through the
  // barrier).
  if (t < NS) a.part[NS * blockIdx.x + t] = mine;
  __syncthreads();
  if (t == 0) is_last = take_ticket(a.ticket) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block: every partial, in block order.
  __threadfence();
  double v[NS] = {0.0, 0.0, 0.0};
  {
    double y[PER_THREAD][NS];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const long b = t + static_cast<long>(FT) * k;
#pragma unroll
      for (int j = 0; j < NS; ++j) y[k][j] = b < gridDim.x ? __ldcg(a.part + NS * b + j) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
#pragma unroll
      for (int j = 0; j < NS; ++j) v[j] += y[k][j];
    }
  }
  __syncthreads();  // red is reused
  const double total = block_sum(v, red);
  if (t < NS) red[0][t] = total;
  __syncthreads();
  if (t == 0) {
    const double s0 = red[0][0], s1 = red[0][1], s2 = red[0][2];
    const float mb = static_cast<float>((s1 + c * s0) / (s0 > 1.0 ? s0 : 1.0));
    const double d = static_cast<double>(mb) - c;
    const double q = s2 - 2.0 * d * s1 + d * d * s0;
    const float nb = static_cast<float>(s0), m2b = static_cast<float>(q > 0.0 ? q : 0.0);
    const float m2a = *a.m2, ca = *a.count;
    const float tot = __fadd_rn(ca, nb);
    const float safe = fmaxf(tot, 1.0f);
    const float delta = __fsub_rn(mb, ma);
    const float mean = __fadd_rn(ma, __fmul_rn(delta, __fdiv_rn(nb, safe)));
    const float m2 = __fadd_rn(__fadd_rn(m2a, m2b), __fmul_rn(__fmul_rn(delta, delta),
                                                              __fdiv_rn(__fmul_rn(ca, nb), safe)));
    const bool keep = nb > 0.0f;
    const float new_mean = keep ? mean : ma, new_m2 = keep ? m2 : m2a;
    const float new_count = keep ? tot : ca;
    const float s_old = popart::std_of(m2a, ca), s_new = popart::std_of(new_m2, new_count);
    head[0] = __fdiv_rn(s_old, s_new);
    head[1] = __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(*a.head_b, s_old), ma), new_mean), s_new);
    head[2] = new_count >= 2.0f ? 1.0f : 0.0f;
    *a.mean = new_mean;
    *a.m2 = new_m2;
    *a.count = new_count;
    *a.ticket = 0u;
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
  out[i] = popart::denormalize(v, *mean, *m2, c);
}

}  // namespace

// Doubles of scratch an update may use: every block's partial, then the
// ticket (i32, in the last double, zero before the first launch; each
// launch leaves it 0).
extern "C" int popart_update_scratch_len() { return NS * MAX_BLOCKS + 1; }

// returns, valid: [N] f32; mean, m2, count: f32 scalars, merged into in
// place; head_w [H] and head_b [1] f32, rescaled in place; scratch:
// [scratch_len] doubles of the caller's, zeroed once.
extern "C" int popart_update(const void* returns, const void* valid, long N, void* mean, void* m2,
                             void* count, void* head_w, void* head_b, int H, void* scratch,
                             int scratch_len, void* stream) {
  if (N <= 0 || H < 1 || scratch_len < popart_update_scratch_len())
    return static_cast<int>(cudaErrorInvalidValue);
  const long tiles = (N + TILE - 1) / TILE;
  const long per_block = (tiles + MAX_BLOCKS - 1) / MAX_BLOCKS;
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
  a.part = static_cast<double*>(scratch);
  a.ticket = reinterpret_cast<unsigned*>(a.part + scratch_len - 1);
  a.n = N;
  a.tiles = tiles;
  a.tiles_per_block = per_block;
  a.H = H;
  a.vec = (addr(returns) | addr(valid)) % 16 == 0;
  popart_update_kernel<<<static_cast<unsigned>(blocks), FT, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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
