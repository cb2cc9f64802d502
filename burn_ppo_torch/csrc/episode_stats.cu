// K10 episode_stats — the [T, E] episode logs of an update reduced to the
// window scalars the host tracker reads: count, ret_sum[P], ret0_max,
// ret0_min, len_sum, pts_sum[P] and draws.
//
// Replaces the XLA fusion of burn_ppo_tpu/ppo/episode_stats.py
// summarize_episode_logs (25-61) (ROADMAP queue B, item B14). Plain
// PyTorch twin: burn_ppo_torch/ppo/episode_stats.py
// summarize_episode_logs_plain.
//
// What bounds it on an H100: a launch and three dependent memory round
// trips (the completed flags, the completed rows' fields, the blocks'
// partials), not bytes. It reads completed [:, :L] whole and the length,
// returns and placements of completed rows only: at [64, 3072] with P = 2
// and 5% of the entries completed, ~0.98 MB, 0.29 us of HBM time, a third
// of an empty kernel's launch (0.87 us on the card). The first version
// took two launches, a 64-bit division an entry, loaded a row's fields
// only after its completed flag, and reduced 256 x (3 + 2P) doubles
// through shared memory in 8 synchronised rounds: 0.0166-0.0228 ms.
//
// It reads columns [0, L) of [T, E] logs (the vs-pool path summarises the
// learner block only), so no copy of the slice is made. One launch of at
// most the blocks the card holds at once (one wave):
//   1. block b takes rows t = b, b + G, ...; in a row its 256 threads take
//      16 columns each a pass (four float4 loads where the row starts on a
//      16-byte boundary, E % 4 == 0; 16 scalar loads otherwise), all
//      issued before any is tested;
//   2. each warp lists its completed columns in shared memory (ballots),
//      and its lanes then take the list two entries at a time, the
//      length, returns and placements of both loaded together (one 16-byte
//      load each at P = 4, 8-byte at P = 2);
//   3. counts, draws and twice the Swiss points (integers) reduced over a
//      warp by one redux each, lengths and returns in double by shuffle
//      trees, the max / min of player 0's return as order-preserving int
//      keys by redux; then across warps in warp order, into the block's
//      partial (f64);
//   4. one ticket a block on an i32 counter (an acq_rel atomic after the
//      block's writes); the last block adds every block's partial in a
//      fixed order, blocks by thread, then lanes, then warps, all its
//      loads in flight at once, writes out and puts the counter back to
//      0: the same bits on every call and every graph replay.
// Measured (chip_smoke.py --parent, NVIDIA H100 80GB HBM3, 700.00 W,
// device ms in turns with the first version): [64, 3072] P = 2 0.00532
// (0.0165-0.0173), [64, 2867] P = 4 0.00579 (0.0193), [128, 3072] P = 4
// 0.00636 (0.0233); an empty kernel's launch 0.00087 (PERF.md row B14).
// A finish by one warp of the last block was faster at 64 blocks and
// slower at 128; a ticket for each of the partial's writers was slower
// at 128 blocks (same-address atomics queue at L2).
// Swiss points keep the reference's "1224" tie rule, points = P - (place +
// (tied - 1) / 2) with tied the players sharing the place; an episode with
// a zero placement (the no-outcome sentinel of an invalid move) counts in
// ``count`` but not in the points or the draws.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 16;  // columns a thread a pass
constexpr int MAX_PLAYERS = 8;
constexpr int MAX_NV = 5 + 2 * MAX_PLAYERS;  // a partial: 3 + 2P sums, max, min
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// A float as an int of the same order (NaN aside), and back: the warp's
// max and min by one redux each.
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

// A thread's sums. Counts, draws and twice the Swiss points are integers
// (the points are halves), reduced over a warp by one redux each; lengths
// and returns in double.
template <int P>
struct Sums {
  int count = 0, draws = 0, pts2[P] = {};
  double len = 0.0, ret[P] = {};
  int kmax = static_cast<int>(0x807fffffu), kmin = 0x7f800000;  // the keys of -inf and +inf
};

// One completed entry's fields: a 16-byte load of its returns and one of
// its placements at P = 4, 8-byte at P = 2 (VEC: the buffers aligned).
template <int P, bool VEC>
struct Entry {
  float tot[P];
  int place[P];
  int len;

  __device__ __forceinline__ void load(const float* __restrict__ totals,
                                       const int* __restrict__ length,
                                       const int* __restrict__ outcome, long idx) {
    len = length[idx];
    if constexpr (VEC && P == 4) {
      const float4 a = *reinterpret_cast<const float4*>(totals + idx * 4);
      const int4 b = *reinterpret_cast<const int4*>(outcome + idx * 4);
      tot[0] = a.x, tot[1] = a.y, tot[2] = a.z, tot[3] = a.w;
      place[0] = b.x, place[1] = b.y, place[2] = b.z, place[3] = b.w;
    } else if constexpr (VEC && P == 2) {
      const float2 a = *reinterpret_cast<const float2*>(totals + idx * 2);
      const int2 b = *reinterpret_cast<const int2*>(outcome + idx * 2);
      tot[0] = a.x, tot[1] = a.y;
      place[0] = b.x, place[1] = b.y;
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        tot[p] = totals[idx * P + p];
        place[p] = outcome[idx * P + p];
      }
    }
  }

  // Swiss points P - (place + (tied - 1) / 2), twice: an integer. Player
  // 0's return enters the extrema unless NaN (fmaxf's rule).
  __device__ __forceinline__ void add(Sums<P>& v) const {
    v.count += 1;
    v.len += static_cast<double>(len);
    bool has_outcome = true, all_first = true;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      has_outcome = has_outcome && place[p] >= 1;
      all_first = all_first && place[p] == 1;
      v.ret[p] += tot[p];
    }
    if (all_first) v.draws += 1;
    if (tot[0] == tot[0]) {
      v.kmax = max(v.kmax, order_key(tot[0]));
      v.kmin = min(v.kmin, order_key(tot[0]));
    }
    if (has_outcome) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        int tied = 0;
#pragma unroll
        for (int q = 0; q < P; ++q) tied += place[q] == place[p];
        v.pts2[p] += 2 * P - 2 * place[p] - (tied - 1);
      }
    }
  }
};

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

// Folds y into x: a sum for j < NS, the max at NS, the min at NS + 1.
template <int NS>
__device__ __forceinline__ double fold(int j, double x, double y) {
  return j < NS ? x + y : j == NS ? fmax(x, y) : fmin(x, y);
}

template <int P, bool VEC>
__global__ void __launch_bounds__(THREADS) episode_stats_kernel(
    const float* __restrict__ completed, const float* __restrict__ totals,
    const int* __restrict__ length, const int* __restrict__ outcome, int T, int E, int L,
    double* __restrict__ partials, unsigned* __restrict__ ticket, float* __restrict__ out) {
  constexpr int NS = 3 + 2 * P, NV = NS + 2;
  __shared__ int list[WARPS][32 * SLOTS];
  __shared__ double red[WARPS][NV];
  __shared__ bool is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  Sums<P> v;

  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    const float* row = completed + static_cast<long>(t) * E;
    for (int base = 0; base < L; base += THREADS * SLOTS) {
      // 1. This pass's flags of the thread's 16 columns, all loads first.
      float c[SLOTS];
      int col[SLOTS];
#pragma unroll
      for (int k = 0; k < SLOTS / 4; ++k) {
        if constexpr (VEC) {
          const int c0 = base + 4 * (tid + k * THREADS);
          if (c0 + 3 < L) {
            const float4 f = *reinterpret_cast<const float4*>(row + c0);
            c[4 * k] = f.x, c[4 * k + 1] = f.y, c[4 * k + 2] = f.z, c[4 * k + 3] = f.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) c[4 * k + i] = c0 + i < L ? row[c0 + i] : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) col[4 * k + i] = c0 + i;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = 4 * k + i, cs = base + tid + s * THREADS;
            c[s] = cs < L ? row[cs] : 0.0f;
            col[s] = cs;
          }
        }
      }
      // 2. The warp's completed columns, listed in slot and lane order.
      int n = 0;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const bool hit = c[s] > 0.0f;
        const unsigned m = __ballot_sync(FULL, hit);
        if (hit) list[warp][n + __popc(m & below)] = col[s];
        n += __popc(m);
      }
      __syncwarp();
      const long row0 = static_cast<long>(t) * E;
      for (int i = lane; i < n; i += 64) {
        const bool two = i + 32 < n;
        Entry<P, VEC> a, b;
        a.load(totals, length, outcome, row0 + list[warp][i]);
        if (two) b.load(totals, length, outcome, row0 + list[warp][i + 32]);
        a.add(v);
        if (two) b.add(v);
      }
      __syncwarp();
    }
  }

  // 3. The block's partial: lanes, then warps in order. Its layout:
  // count, len, draws, ret[P], pts[P], max, min.
  {
    const int count = __reduce_add_sync(FULL, v.count), draws = __reduce_add_sync(FULL, v.draws);
    const int kmax = __reduce_max_sync(FULL, v.kmax), kmin = __reduce_min_sync(FULL, v.kmin);
    int pts2[P];
#pragma unroll
    for (int p = 0; p < P; ++p) pts2[p] = __reduce_add_sync(FULL, v.pts2[p]);
    const double len = warp_sum(v.len);
    double ret[P];
#pragma unroll
    for (int p = 0; p < P; ++p) ret[p] = warp_sum(v.ret[p]);
    if (lane == 0) {
      red[warp][0] = count;
      red[warp][1] = len;
      red[warp][2] = draws;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        red[warp][3 + p] = ret[p];
        red[warp][3 + P + p] = 0.5 * pts2[p];
      }
      red[warp][NS] = from_key(kmax);
      red[warp][NS + 1] = from_key(kmin);
    }
  }
  __syncthreads();
  // Thread j < NV writes value j of the partial; then one ticket a block,
  // whose release covers the block's writes (they precede it through the
  // barrier).
  if (tid < NV) {
    double x = red[0][tid];
    for (int w = 1; w < WARPS; ++w) x = fold<NS>(tid, x, red[w][tid]);
    partials[NV * blockIdx.x + tid] = x;
  }
  __syncthreads();
  if (tid == 0) is_last = take_ticket(ticket) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // 4. The last block: thread t adds blocks t, t + 256, ... (its loads all
  // issued first), then lanes and warps in order.
  __threadfence();
  double part[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) part[j] = j < NS ? 0.0 : j == NS ? -INFINITY : INFINITY;
  for (int blk = tid; blk < static_cast<int>(gridDim.x); blk += THREADS) {
    double y[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) y[j] = __ldcg(partials + NV * blk + j);
#pragma unroll
    for (int j = 0; j < NV; ++j) part[j] = fold<NS>(j, part[j], y[j]);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const double x = j < NS ? warp_sum(part[j]) : j == NS ? warp_max(part[j]) : warp_min(part[j]);
    if (lane == 0) red[warp][j] = x;
  }
  __syncthreads();
  if (tid < NV) {
    double x = red[0][tid];
    for (int w = 1; w < WARPS; ++w) x = fold<NS>(tid, x, red[w][tid]);
    const float a = static_cast<float>(x);
    // out: count, ret_sum[P], ret0_max, ret0_min, len_sum, pts_sum[P], draws
    const int j = tid;
    if (j == 0) out[0] = a;
    else if (j == 1) out[P + 3] = a;
    else if (j == 2) out[2 * P + 4] = a;
    else if (j < 3 + P) out[1 + (j - 3)] = a;
    else if (j < NS) out[P + 4 + (j - 3 - P)] = a;
    else if (j == NS) out[P + 1] = a;
    else out[P + 2] = a;
  }
  if (tid == 0) *ticket = 0u;
}

// The blocks of this instance the current device holds at once.
template <int P, bool VEC>
int resident_blocks() {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, episode_stats_kernel<P, VEC>,
                                                      THREADS, 0) != cudaSuccess)
      return 0;
    resident[dev] = sms * per_sm;
  }
  return resident[dev];
}

// At most the blocks the SMs' threads allow, whatever the instance.
int grid_cap() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms * (2048 / THREADS);
}

template <int P, bool VEC>
cudaError_t launch(const float* completed, const float* totals, const int* length,
                   const int* outcome, int T, int E, int L, double* scratch, int scratch_len,
                   float* out, cudaStream_t s) {
  const int resident = resident_blocks<P, VEC>();
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int G = T < 1 ? 1 : (T < resident ? T : resident);
  constexpr int NV = 5 + 2 * P;
  if (static_cast<long>(G) * NV + 1 > scratch_len) return cudaErrorInvalidValue;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + scratch_len - 1);
  episode_stats_kernel<P, VEC><<<G, THREADS, 0, s>>>(completed, totals, length, outcome, T, E, L,
                                                     scratch, ticket, out);
  return cudaGetLastError();
}

bool aligned(const void* p, unsigned long n) { return reinterpret_cast<unsigned long>(p) % n == 0; }

}  // namespace

// Doubles of scratch a launch on the current device may use: every
// block's partial, then the ticket (i32, in the last double, zero before
// the first launch; each launch leaves it 0).
extern "C" int episode_stats_scratch_len() { return grid_cap() * MAX_NV + 1; }

// scratch: [episode_stats_scratch_len()] doubles, zeroed once; out: [5 + 2P] f32.
extern "C" int episode_stats(const void* completed, const void* totals, const void* length,
                             const void* outcome, int T, int E, int L, int P, void* scratch,
                             int scratch_len, void* out, void* stream) {
  if (T < 0 || L < 0 || L > E || scratch_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(completed);
  const float* tr = static_cast<const float*>(totals);
  const int* len = static_cast<const int*>(length);
  const int* oc = static_cast<const int*>(outcome);
  double* sc = static_cast<double*>(scratch);
  float* o = static_cast<float*>(out);
  // Wide loads where every row of completed starts on a 16-byte boundary
  // and an entry's returns and placements on their width.
  const unsigned long w = P == 4 ? 16 : P == 2 ? 8 : 4;
  const bool vec = E % 4 == 0 && aligned(c, 16) && aligned(tr, w) && aligned(oc, w);
  cudaError_t err;
  switch (P) {
#define CASE(n)                                                                        \
  case n:                                                                              \
    err = vec ? launch<n, true>(c, tr, len, oc, T, E, L, sc, scratch_len, o, s)        \
              : launch<n, false>(c, tr, len, oc, T, E, L, sc, scratch_len, o, s);      \
    break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
