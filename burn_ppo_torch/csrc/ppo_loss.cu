// K8 ppo_loss — the PPO minibatch loss after the network forward: masked
// log-softmax, ratio, clipped surrogate, (clipped) value loss, entropy
// bonus, the 14 metrics, and dL/dlogits and dL/dvalues, in one forward
// (the backward only scales the saved gradients).
//
// Replaces the non-matmul part of the XLA fusions of
// burn_ppo_tpu/ppo/update.py _minibatch_loss (125-212) under
// jax.value_and_grad (ROADMAP queue B, item B6). Plain PyTorch twin:
// burn_ppo_torch/ppo/update.py ppo_loss_plain.
//
// What bounds it on an H100: bytes. At M = 65,536 rows and A = 49 it reads
// logits and mask and writes dL/dlogits (12.8 MB each) besides eight [M]
// columns: ~40 MB, ~12 us of HBM time.
//
// Two launches:
//   1. ppo_loss_stats: per block, the valid-weighted sums of the advantages
//      (w, w*a, w*a^2) in double over a grid-stride of rows, reduced with
//      warp shuffles; block 0 also zeroes the done-counter of launch 2.
//   2. ppo_loss_rows, a programmatic dependent launch of 1: its blocks
//      start while 1 runs, issue their first copies, then wait for 1
//      (griddepcontrol.wait) and one warp adds the stats partials in a
//      fixed order (the advantage mean and Bessel std, as the plain
//      version forms them). Each warp takes tiles of 32 rows on its own,
//      with no block barrier between tiles: a tile's 32 x A logits and
//      mask are one contiguous span, copied into the warp's part of
//      shared memory with 16-byte cp.async, its columns beside it. Three
//      phases per tile, with warp barriers between them:
//        A. LPR lanes a row (2 for rows up to 8 wide, else 8), each lane
//           every LPR-th entry: the row max and the sums are shuffles
//           inside the row's lanes; every entry's expf runs once; its prob
//           and log-prob replace the staged mask and logit;
//        B. a lane a row: ratio, clips, value loss and the 12 metric
//           terms, added in double;
//        C. LPR lanes a row write dL/dlogits over the log-probs, and the
//           span goes out with 16-byte stores.
//      The block reduces its metric terms with warp shuffles and over its
//      warps in a fixed order. The block that finishes last (an integer
//      counter, no float atomics) adds the blocks' partials in a fixed
//      order and writes the loss and the 14 metrics. Two calls on the
//      same inputs give the same bits. The grid covers each warp tile
//      once, up to what the card holds at once (occupancy times SMs).
// The entropy coefficient is an f32 scalar on the device, read after the
// wait, so one captured launch serves every update of a CUDA graph.
// With the update's bookkeeping, the last block's finalize also decides
// on the card what the JAX scan decides with lax.cond
// (burn_ppo_tpu/ppo/update.py:346-382), so the host reads nothing back:
//   run = !stop && (!can_be_empty || sum(valid) > 0)   (i32, for K9)
//   where run: sums += the 14 metrics (f32), count += 1, and
//              stop = approx_kl > target_kl (in double; target_kl < 0:
//              no early stop).
// PopArt (normalize_values, ROADMAP B18): with the value normaliser's
// state given (mean, m2, count, f32 scalars on the device), the row pass
// normalises the returns and old values as burn_ppo_tpu/ppo/update.py:
// 164-166 does, (x - mean) / std once the count is >= 2, before the value
// loss and its metrics.
// The adaptive entropy controller (ROADMAP B19): with its state given
// (coef, last entropy: f32; has-entropy: bool), the coefficient is the
// state's; on the update's first minibatch (ent_step) every block steps it
// from the target in ent_coef (burn_ppo_tpu/ppo/entropy.py:49-80, Rust's
// signum through copysign) before its rows read it, and the finalize
// stores it. Every finalize records the update's mean entropy so far,
// sums[entropy] / max(count, 1): after the update's last minibatch, KL
// stop or not, the state holds the mean the JAX package records
// (train.py:240-245), with no launch of its own.
// Gradient rules at ties follow JAX: d max(a, b) splits 1/2 - 1/2 where
// a == b, and jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)) passes 1/2
// of the gradient at x == lo or x == hi. Masked actions (additive -1e9)
// have p = 0 and add nothing to the entropy or the gradient.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float MASK_NEG = -1.0e9f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 12;  // metric sums per block, see ppo_loss_rows
constexpr int STATS_BLOCKS = 264;
constexpr int ROW_BLOCKS = 1056;  // at most eight 256-thread blocks per SM
constexpr int MAX_A = 64;

struct AdvStats {
  double wsum;
  float wc, mean, std;
};

// Sum over the warp's 32 lanes; every lane ends with the same value, added
// in the same order on every run.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reductions inside a row's LPR lanes (aligned groups of the warp).
template <int LPR>
__device__ __forceinline__ float row_max(float v) {
  for (int o = LPR / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LPR>
__device__ __forceinline__ float row_sum(float v) {
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The advantage statistics from the stats partials; called by a whole warp.
__device__ AdvStats adv_stats(const double* __restrict__ stats, int G) {
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int g = lane; g < G; g += 32) {
    s0 += stats[3 * g];
    s1 += stats[3 * g + 1];
    s2 += stats[3 * g + 2];
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  AdvStats a;
  a.wsum = s0;
  a.wc = fmaxf(static_cast<float>(s0), 1e-8f);
  const double m = s1 / a.wc;
  a.mean = static_cast<float>(m);
  const double ss = fmax(s2 - 2.0 * m * s1 + m * m * s0, 0.0);
  a.std = static_cast<float>(sqrt(ss / fmax(s0 - 1.0, 1.0)));
  return a;
}

// jnp.maximum(a, b) and the shares of its gradient.
__device__ __forceinline__ float jmax(float a, float b, float* ga, float* gb) {
  if (a > b) {
    *ga = 1.0f, *gb = 0.0f;
    return a;
  }
  if (b > a) {
    *ga = 0.0f, *gb = 1.0f;
    return b;
  }
  *ga = 0.5f, *gb = 0.5f;
  return a;
}

// jnp.clip(x, lo, hi) and its derivative.
__device__ __forceinline__ float jclip(float x, float lo, float hi, float* d) {
  const float m1 = fmaxf(lo, x);
  const float d1 = x > lo ? 1.0f : (x == lo ? 0.5f : 0.0f);
  const float m2 = fminf(hi, m1);
  const float d2 = m1 < hi ? 1.0f : (m1 == hi ? 0.5f : 0.0f);
  *d = d1 * d2;
  return m2;
}

__global__ void __launch_bounds__(THREADS) ppo_loss_stats_kernel(
    const float* __restrict__ adv, const float* __restrict__ valid, int M,
    double* __restrict__ stats, unsigned* __restrict__ done_count) {
  __shared__ double part[WARPS][3];
  // The row pass may launch now; it waits for this grid's end before it
  // reads the partials or the counter.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  if (blockIdx.x == 0 && threadIdx.x == 0) *done_count = 0u;
  double v[3] = {0.0, 0.0, 0.0};
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < M; i += gridDim.x * THREADS) {
    const double w = valid[i], a = adv[i];
    v[0] += w;
    v[1] += w * a;
    v[2] += w * a * a;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < 3; ++j) {
    v[j] = warp_sum(v[j]);
    if (lane == 0) part[warp][j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int w = 0; w < WARPS; ++w) s += part[w][threadIdx.x];
    stats[3 * blockIdx.x + threadIdx.x] = s;
  }
}

struct RowArgs {
  const float* logits;
  const float* values;
  const float* mask;  // nullable
  const int* actions;
  const float* old_lp;
  const float* adv;
  const float* returns;
  const float* old_values;  // read only with the value clip on
  const float* valid;
  int M, A, G_stats, vec;
  float eps, lo, hi;
  int clip_value;
  float value_coef;
  const float* ent_coef;
  const double* stats;
  double* sums;  // [gridDim.x, NSUM]
  unsigned* done_count;
  float* out;  // [15]: the loss, then the 14 metrics in METRIC_KEYS order
  float* dlogits;
  float* dvalues;
  // The update's bookkeeping: the metric sums [14], the minibatches run
  // (f32), the stop and run flags (i32).
  float* book_sums;
  float* book_count;
  int* book_stop;
  int* book_run;
  int can_be_empty;
  double target_kl;
  // PopArt's state (all null: off).
  const float* pa_mean;
  const float* pa_m2;
  const float* pa_count;
  // The entropy controller's state (all null: off; ent_coef is then the
  // coefficient, else the step's target), whether this launch steps it,
  // and its clamp and step.
  float* ent_cur;
  float* ent_last;
  bool* ent_has;
  int ent_step;
  float ent_min, ent_max, ent_delta;
};

// PopArt's std: 1 before two samples, else sqrt(m2 / max(count, 1) + 1e-4),
// each operation rounded on its own as the plain version rounds it.
__device__ __forceinline__ float popart_std(float m2, float count) {
  if (count < 2.0f) return 1.0f;
  return sqrtf(__fadd_rn(__fdiv_rn(m2, fmaxf(count, 1.0f)), 1e-4f));
}

// The entropy coefficient of this minibatch: the scalar given, or the
// controller's, stepped on the update's first minibatch.
__device__ __forceinline__ float entropy_coef(const RowArgs& g) {
  if (g.ent_cur == nullptr) return *g.ent_coef;
  const float cur = *g.ent_cur;
  if (!g.ent_step || !*g.ent_has) return cur;
  const float error = __fsub_rn(*g.ent_coef, *g.ent_last);
  const float moved = __fadd_rn(cur, __fmul_rn(g.ent_delta, copysignf(1.0f, error)));
  return fminf(g.ent_max, fmaxf(g.ent_min, moved));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The per-row columns staged beside a warp's rows (actions as their i32
// bits), and the row results passed between the phases.
enum Col { VAL, OLP, ADV, RET, OV, W, ACT, NCOL };
enum RowOut { LP, ENT, CNT, DLP, DENT, NOUT };

constexpr int WR = 32;  // rows per warp tile: one per lane in phase B

// Floats of one warp's shared region for rows of A actions: the logits
// span (then log-probs, then dL/dlogits), the mask span (then probs), the
// columns and the row results; each span a multiple of 4 floats.
__host__ __device__ __forceinline__ int warp_region(int A) {
  const int span = (WR * A + 3) / 4 * 4;
  return 2 * span + (NCOL + NOUT) * WR;
}

// Each warp takes tiles of WR rows on its own (no block barrier between
// tiles); LPR lanes a row, EPL = ceil(A / LPR) entries a lane.
template <int LPR, int EPL>
__global__ void __launch_bounds__(THREADS, 2) ppo_loss_rows_kernel(RowArgs g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ AdvStats st;
  __shared__ double red[WARPS][NSUM];
  __shared__ double tot[NSUM];
  __shared__ bool is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPR, rsub = lane / LPR;  // a pass takes 32 / LPR rows
  const int A = g.A, M = g.M;
  const bool has_mask = g.mask != nullptr;
  const int span = (WR * A + 3) / 4 * 4;
  float* z = smem + warp * warp_region(A);  // logits -> log-probs -> dL/dlogits
  float* m = z + span;                      // mask -> probs
  float* col = m + span;                    // [NCOL][WR]
  float* row = col + NCOL * WR;             // [NOUT][WR]
  const float* cols[NCOL] = {g.values, g.old_lp, g.adv, g.returns, g.old_values, g.valid,
                             reinterpret_cast<const float*>(g.actions)};
  auto issue = [&](int t) {
    const int row0 = t * WR, nrows = min(WR, M - row0), n = nrows * A;
    const long base = static_cast<long>(row0) * A;
    int i0 = 0;
    if (g.vec) {
      for (int i = lane; i < (n >> 2); i += 32) {
        cp_async16(z + 4 * i, g.logits + base + 4 * i);
        if (has_mask) cp_async16(m + 4 * i, g.mask + base + 4 * i);
      }
      i0 = n & ~3;
    }
    for (int i = i0 + lane; i < n; i += 32) {
      cp_async4(z + i, g.logits + base + i);
      if (has_mask) cp_async4(m + i, g.mask + base + i);
    }
    if (lane < nrows) {
      for (int c = 0; c < NCOL; ++c) {
        if (c != OV || g.clip_value) cp_async4(col + c * WR + lane, cols[c] + row0 + lane);
      }
    }
    cp_async_commit();
  };

  const int tiles = (M + WR - 1) / WR;
  const int first = blockIdx.x * WARPS + warp, step = gridDim.x * WARPS;
  if (first < tiles) issue(first);
  // Launched before the stats pass ended (programmatic dependent launch):
  // the first tile's copies are in flight; now wait for the stats.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (warp == 0) {
    const AdvStats a = adv_stats(g.stats, g.G_stats);
    if (lane == 0) st = a;
  }
  __syncthreads();
  const AdvStats s = st;
  const float ent_coef = entropy_coef(g);
  const bool popart = g.pa_count != nullptr && *g.pa_count >= 2.0f;
  const float pa_mean = popart ? *g.pa_mean : 0.0f;
  const float pa_std = popart ? popart_std(*g.pa_m2, *g.pa_count) : 1.0f;
  double v[NSUM] = {};
  for (int t = first; t < tiles; t += step) {
    if (t != first) issue(t);
    cp_async_wait<0>();
    __syncwarp();
    const int row0 = t * WR, nrows = min(WR, M - row0);

    // A. LPR lanes a row: max, sum of exps, log-probs, entropy. Every
    // entry's expf runs once; its prob replaces the mask, its log-prob
    // the logit. Two passes unrolled, so that their shuffle chains overlap.
#pragma unroll 2
    for (int r0 = 0; r0 < WR; r0 += 32 / LPR) {
      const int r = r0 + rsub;
      const bool live = r < nrows;
      float zz[EPL], ex[EPL];
      float zmax = -INFINITY, cnt = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int j = sub + e * LPR;
        const bool in = live && j < A;
        const float mk = in ? (has_mask ? m[r * A + j] : 1.0f) : 0.0f;
        zz[e] = in ? z[r * A + j] + (mk != 0.0f ? 0.0f : MASK_NEG) : -INFINITY;
        zmax = fmaxf(zmax, zz[e]);
        cnt += mk;
      }
      zmax = row_max<LPR>(zmax);
      cnt = row_sum<LPR>(cnt);
      if (!live) zmax = 0.0f;
      float se = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        ex[e] = expf(zz[e] - zmax);  // 0 for masked and absent entries
        se += ex[e];
      }
      se = row_sum<LPR>(se);
      if (!live) se = 1.0f;
      const float lse = logf(se);
      const int a = live ? __float_as_int(col[ACT * WR + r]) : -1;
      float lp = 0.0f, ent = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int j = sub + e * LPR;
        const float lj = (zz[e] - zmax) - lse, pj = ex[e] / se;
        if (pj > 0.0f) ent += pj * lj;
        if (j == a) lp = lj;
        if (live && j < A) {
          z[r * A + j] = lj;
          m[r * A + j] = pj;
        }
      }
      ent = -row_sum<LPR>(ent);
      lp = row_sum<LPR>(lp);
      if (live && sub == 0) {
        row[LP * WR + r] = lp;
        row[ENT * WR + r] = ent;
        row[CNT * WR + r] = cnt;
      }
    }
    __syncwarp();

    // B. A lane a row: ratio, clips, value loss, the metric terms.
    float dv = 0.0f;
    if (lane < nrows) {
      const int r = lane;
      const float w = col[W * WR + r], lp = row[LP * WR + r], ent = row[ENT * WR + r];
      const float cnt = row[CNT * WR + r];
      const float log_ratio = lp - col[OLP * WR + r];
      const float ratio = expf(log_ratio);
      const float an = (col[ADV * WR + r] - s.mean) / (s.std + 1e-8f);
      float dclip, g1, g2;
      const float rc = jclip(ratio, g.lo, g.hi, &dclip);
      const float pmax = jmax(-an * ratio, -an * rc, &g1, &g2);
      const float dpmax_dr = g1 * -an + g2 * (-an * dclip);

      const float val = col[VAL * WR + r];
      float ret = col[RET * WR + r];
      if (popart) ret = __fdiv_rn(__fsub_rn(ret, pa_mean), pa_std);
      float vl, dvl;
      if (g.clip_value) {
        float ov = col[OV * WR + r];
        if (popart) ov = __fdiv_rn(__fsub_rn(ov, pa_mean), pa_std);
        float dd, h1, h2;
        const float vcl = ov + jclip(val - ov, -g.eps, g.eps, &dd);
        const float e1 = val - ret, e2 = vcl - ret;
        vl = jmax(e1 * e1, e2 * e2, &h1, &h2);
        dvl = h1 * (2.0f * e1) + h2 * (2.0f * e2 * dd);
      } else {
        const float e1 = val - ret;
        vl = e1 * e1;
        dvl = 2.0f * e1;
      }
      const float coef = w / s.wc;
      dv = g.value_coef * 0.5f * coef * dvl;
      row[DLP * WR + r] = dpmax_dr * ratio * coef;
      row[DENT * WR + r] = ent_coef * coef;

      const double wd = w;
      const float err = fabsf(val - ret);
      v[0] += wd * pmax;
      v[1] += wd * vl;
      v[2] += wd * ent;
      v[3] += wd * ((ratio - 1.0f) - log_ratio);
      v[4] += wd * (fabsf(ratio - 1.0f) > g.eps ? 1.0 : 0.0);
      v[5] += wd * val;
      v[6] += wd * ret;
      v[7] += wd * err;
      v[8] += wd * static_cast<double>(err) * err;
      v[9] += wd * cnt;
      const float hc = (cnt > 1.0f ? 1.0f : 0.0f) * w;
      const float max_ent = logf(fmaxf(cnt, 1.0f + 1e-8f));
      v[10] += static_cast<double>(ent / fmaxf(max_ent, 1e-8f) * hc);
      v[11] += hc;
    }
    __syncwarp();

    // C. LPR lanes a row: dL/dlogits over the log-probs.
#pragma unroll 2
    for (int r0 = 0; r0 < WR; r0 += 32 / LPR) {
      const int r = r0 + rsub;
      if (r < nrows) {
        const int a = __float_as_int(col[ACT * WR + r]);
        const float dlp = row[DLP * WR + r], dent = row[DENT * WR + r], ent = row[ENT * WR + r];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int j = sub + e * LPR;
          if (j < A) {
            const float p = m[r * A + j];
            const float hj = p > 0.0f ? p * (z[r * A + j] + ent) : 0.0f;
            z[r * A + j] = dlp * ((j == a ? 1.0f : 0.0f) - p) + dent * hj;
          }
        }
      }
    }
    __syncwarp();
    // The warp's dL/dlogits span out with 16-byte stores.
    {
      const int n = nrows * A;
      float* dst = g.dlogits + static_cast<long>(row0) * A;
      int i0 = 0;
      if (g.vec) {
        for (int i = lane; i < (n >> 2); i += 32) {
          reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(z)[i];
        }
        i0 = n & ~3;
      }
      for (int i = i0 + lane; i < n; i += 32) dst[i] = z[i];
    }
    if (lane < nrows) g.dvalues[row0 + lane] = dv;
    __syncwarp();
  }

  // Block partials in a fixed order: lanes, then warps.
#pragma unroll
  for (int j = 0; j < NSUM; ++j) {
    const double x = warp_sum(v[j]);
    if (lane == 0) red[warp][j] = x;
  }
  __syncthreads();
  if (tid < NSUM) {
    double x = 0.0;
    for (int w = 0; w < WARPS; ++w) x += red[w][tid];
    g.sums[NSUM * blockIdx.x + tid] = x;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(g.done_count, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block: every block's partials, thread t adding blocks t,
  // t + THREADS, ... (all its loads in flight at once), then lanes and
  // warps in a fixed order.
  __threadfence();
  double part[NSUM] = {};
  for (int blk = tid; blk < static_cast<int>(gridDim.x); blk += THREADS) {
#pragma unroll
    for (int j = 0; j < NSUM; ++j) part[j] += __ldcg(g.sums + NSUM * blk + j);
  }
#pragma unroll
  for (int j = 0; j < NSUM; ++j) {
    const double x = warp_sum(part[j]);
    if (lane == 0) red[warp][j] = x;
  }
  __syncthreads();
  if (tid < NSUM) {
    double x = 0.0;
    for (int w = 0; w < WARPS; ++w) x += red[w][tid];
    tot[tid] = x;
  }
  __syncthreads();
  if (tid != 0) return;
  const double wc = s.wc;
  const float policy_loss = static_cast<float>(tot[0] / wc);
  const float value_loss = 0.5f * static_cast<float>(tot[1] / wc);
  const float entropy = static_cast<float>(tot[2] / wc);
  const double me = tot[7] / wc;
  const double ss_e = fmax(tot[8] - 2.0 * me * tot[7] + me * me * s.wsum, 0.0);
  const float total = policy_loss + value_loss * g.value_coef - entropy * ent_coef;
  float* out = g.out;
  out[0] = total;
  out[1] = policy_loss;
  out[2] = value_loss;
  out[3] = entropy;
  out[4] = static_cast<float>(tot[3] / wc);  // approx_kl
  out[5] = static_cast<float>(tot[4] / wc);  // clip_fraction
  out[6] = total;                              // total_loss
  out[7] = static_cast<float>(tot[5] / wc);  // value_mean
  out[8] = static_cast<float>(tot[6] / wc);  // returns_mean
  out[9] = s.mean;                             // adv_mean_raw
  out[10] = s.std;                             // adv_std_raw
  out[11] = static_cast<float>(me);            // value_error_mean
  out[12] = static_cast<float>(sqrt(ss_e / fmax(s.wsum - 1.0, 1.0)));  // value_error_std
  out[13] = has_mask ? static_cast<float>(tot[9] / wc) : 0.0f;  // avg_valid_actions
  out[14] = has_mask ? static_cast<float>(tot[10] / fmax(tot[11], 1e-8)) : 0.0f;
  const int run = *g.book_stop == 0 && (!g.can_be_empty || s.wsum > 0.0);
  if (run) {
    for (int j = 0; j < 14; ++j) g.book_sums[j] += out[1 + j];
    *g.book_count += 1.0f;
    if (g.target_kl >= 0.0 && static_cast<double>(out[4]) > g.target_kl) *g.book_stop = 1;
  }
  *g.book_run = run;
  if (g.ent_cur != nullptr) {
    if (g.ent_step) *g.ent_cur = ent_coef;
    *g.ent_last = __fdiv_rn(g.book_sums[2], fmaxf(*g.book_count, 1.0f));
    *g.ent_has = true;
  }
}

// The row pass as a programmatic dependent launch of the stats pass: its
// blocks may start while the stats pass runs, and wait for it in the
// kernel (griddepcontrol.wait) after their first copies are issued. The
// grid covers every warp tile once, up to what the card holds at once
// (this variant's occupancy at this shared memory times the SMs).
template <int LPR, int EPL>
cudaError_t launch_rows(const RowArgs& a, cudaStream_t s) {
  auto kernel = ppo_loss_rows_kernel<LPR, EPL>;
  const int smem = static_cast<int>(sizeof(float)) * WARPS * warp_region(a.A);
  static int sms = 0, smem_set = 0, resident_smem = -1, resident = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (smem != resident_smem) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm < ROW_BLOCKS ? sms * per_sm : ROW_BLOCKS;
    resident_smem = smem;
  }
  const int tiles = (a.M + WR - 1) / WR, blocks = (tiles + WARPS - 1) / WARPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks < resident ? blocks : resident);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace

// Scratch doubles the caller provides (f64 [ppo_loss_scratch_len()]): the
// stats partials, the row blocks' partials and the done-counter.
extern "C" int ppo_loss_scratch_len() { return 3 * STATS_BLOCKS + NSUM * ROW_BLOCKS + 1; }

// out: [15] f32; A in [1, 64]; ent_coef: f32 scalar. book_sums (f32
// [14]), book_count (f32), book_stop and book_run (i32). pa_mean, pa_m2,
// pa_count: PopArt's f32 scalars, or all null; ent_cur, ent_last (f32)
// and ent_has (bool): the entropy controller's state, or all null.
extern "C" int ppo_loss_forward(const void* logits, const void* values, const void* mask,
                                const void* actions, const void* old_lp, const void* adv,
                                const void* returns, const void* old_values,
                                const void* valid, int M, int A, float eps, float lo, float hi,
                                int clip_value, float value_coef, const void* ent_coef,
                                void* scratch, void* out, void* dlogits, void* dvalues,
                                void* book_sums, void* book_count, void* book_stop,
                                void* book_run, int can_be_empty, double target_kl,
                                const void* pa_mean, const void* pa_m2, const void* pa_count,
                                void* ent_cur, void* ent_last, void* ent_has, int ent_step,
                                float ent_min, float ent_max, float ent_delta, void* stream) {
  if (M <= 0 || A < 1 || A > MAX_A) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* stats = static_cast<double*>(scratch);
  double* sums = stats + 3 * STATS_BLOCKS;
  unsigned* done_count = reinterpret_cast<unsigned*>(sums + NSUM * ROW_BLOCKS);
  const int per_block = THREADS * 4;
  int G_stats = (M + per_block - 1) / per_block;
  if (G_stats > STATS_BLOCKS) G_stats = STATS_BLOCKS;
  ppo_loss_stats_kernel<<<G_stats, THREADS, 0, s>>>(static_cast<const float*>(adv),
                                                    static_cast<const float*>(valid), M, stats,
                                                    done_count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  RowArgs a;
  a.logits = static_cast<const float*>(logits);
  a.values = static_cast<const float*>(values);
  a.mask = static_cast<const float*>(mask);
  a.actions = static_cast<const int*>(actions);
  a.old_lp = static_cast<const float*>(old_lp);
  a.adv = static_cast<const float*>(adv);
  a.returns = static_cast<const float*>(returns);
  a.old_values = static_cast<const float*>(old_values);
  a.valid = static_cast<const float*>(valid);
  a.M = M;
  a.A = A;
  a.G_stats = G_stats;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(logits) |
                         reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(dlogits);
  a.vec = (bits & 15u) == 0 ? 1 : 0;
  a.eps = eps;
  a.lo = lo;
  a.hi = hi;
  a.clip_value = clip_value;
  a.value_coef = value_coef;
  a.ent_coef = static_cast<const float*>(ent_coef);
  a.stats = stats;
  a.sums = sums;
  a.done_count = done_count;
  a.out = static_cast<float*>(out);
  a.dlogits = static_cast<float*>(dlogits);
  a.dvalues = static_cast<float*>(dvalues);
  a.book_sums = static_cast<float*>(book_sums);
  a.book_count = static_cast<float*>(book_count);
  a.book_stop = static_cast<int*>(book_stop);
  a.book_run = static_cast<int*>(book_run);
  a.can_be_empty = can_be_empty;
  a.target_kl = target_kl;
  a.pa_mean = static_cast<const float*>(pa_mean);
  a.pa_m2 = static_cast<const float*>(pa_m2);
  a.pa_count = static_cast<const float*>(pa_count);
  a.ent_cur = static_cast<float*>(ent_cur);
  a.ent_last = static_cast<float*>(ent_last);
  a.ent_has = static_cast<bool*>(ent_has);
  a.ent_step = ent_step;
  a.ent_min = ent_min;
  a.ent_max = ent_max;
  a.ent_delta = ent_delta;
  // Lanes per row: 2 for rows up to 8 wide (16 rows a pass), else 8;
  // entries per lane: the row's width over its lanes, rounded up.
  switch (A <= 8 ? (A + 1) / 2 : 4 + (A + 7) / 8) {
    case 1: err = launch_rows<2, 1>(a, s); break;
    case 2: err = launch_rows<2, 2>(a, s); break;
    case 3: err = launch_rows<2, 3>(a, s); break;
    case 4: err = launch_rows<2, 4>(a, s); break;
    case 6: err = launch_rows<8, 2>(a, s); break;
    case 7: err = launch_rows<8, 3>(a, s); break;
    case 8: err = launch_rows<8, 4>(a, s); break;
    case 9: err = launch_rows<8, 5>(a, s); break;
    case 10: err = launch_rows<8, 6>(a, s); break;
    case 11: err = launch_rows<8, 7>(a, s); break;
    default: err = launch_rows<8, 8>(a, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

