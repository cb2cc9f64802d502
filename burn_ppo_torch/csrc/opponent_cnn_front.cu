// K20 opponent_cnn_front — the CNN opponents' conv front, redesigned for
// Hopper: each pool row's normalisation and whole conv stack under its own
// slot's weights, in one launch.
//
// Replaces the part of the XLA fusion of burn_ppo_tpu/ppo/pool_rollout.py
// opponent_logits (126-139) that comes before K7's feature front: under
// jax.vmap over the K stacked opponents (134-137), each slot's
// obs_norm_apply of the raw obs (129-132), models/network.py
// _cnn_features' reshape of the spatial slice to NHWC (187-191) and its
// conv stack with relu between the layers (192-194), each conv
// models/core.py conv2d_same (54-72: stride 1, SAME padding, f32 output,
// the bias added in f32; with the bf16 compute dtype bf16 operands, the
// products f32). Where JAX runs every slot's stack over every row and
// selects a row's slot afterwards, a row here runs its own slot's stack
// only (ROADMAP queue B, item B22). Plain PyTorch twin:
// burn_ppo_torch/ppo/pool_rollout.py opponent_cnn_front_plain.
//
// out[r] = conv_L(relu(... relu(conv_1(norm_k(x[r]))))) for k = slot[r],
// [C', H, W] f32 in NCHW order (the last conv before its relu, the order
// K7's packed first layer reads); zeros where slot[r] is outside [0, K).
// norm_k is the identity while slot k's count < 2, otherwise
// clip((x - mean) / max(sqrt(m2 / max(count, 1)), 1e-8), -clip, clip) in
// the order of K6 and of the plain version (correctly rounded f32 division
// and square root). With bf16 set, every conv's input is rounded to bf16
// (to nearest even): the normalised obs, and each relu's output; the
// weights already hold bf16 values, so a product is exact in f32 and only
// the order of the f32 sums differs from cuDNN's.
//
// What bounds it on an H100: operations. At Connect Four's pool block (Ep
// = 1024, K = 8, 6 x 7 x 2, the default [8, 8] stack of 3 x 3 kernels) a
// row's stack is 42 (2 x 9 x 8 + 8 x 9 x 8) = 30,240 multiply-adds, 62
// MFLOP a step: 0.00093 ms at 67 TFLOP/s f32; its bytes (the spatial obs
// 0.34 MB, the output 1.38 MB, 23 KB of weights) 0.00052 ms at 3.35 TB/s.
// The work is small and latency-bound, so the design is one short launch
// in which nothing but the output goes through device memory:
//   * Tiles of R rows of one slot (csrc/slot_tiles.cuh, K7's prologue: a
//     pass over the slot ids, each block naming its own tile). R is set by
//     the widest layer, so that a layer's (row, position, group of eight
//     output channels) items fill half the 256 threads: 3 rows at the
//     default stack, at most 350 blocks at Ep = 1024, all resident at
//     once (3 rows timed fastest of 2 to 6; PERF.md row B22).
//   * The slot's conv weights and biases brought into shared memory by
//     4-byte cp.async, a layer at a time, transposed on the way to [c_in]
//     [kh][kw][c_out rounded up to 8] (2.9 KB a slot at the default
//     stack), so that a tap's eight output channels are two 16-byte
//     broadcast loads: layer 0's as soon as the tile is named, while the
//     block collects its row ids and normalises its rows, each later
//     layer's after the layer before it.
//   * Two activation buffers of [channels][H + KS - 1][W + KS - 1] a row,
//     zero-haloed, so the taps need no bounds checks; the normalised rows
//     go into buffer 0, each layer reads one buffer and writes the other
//     (the relu, and for bf16 the rounding, applied as it stores).
//   * Products as f32 FFMA: a thread an item, each tap one shared load of
//     the input and eight fused multiply-adds. mma.sync would pay only if
//     these set the time: at the default stack the slot scan, naming and
//     row ids take about as much of the launch as the two layers (PERF.md
//     row B22).
//   * The last layer stages its output in shared memory in the output's
//     layout, then the rows go out with 16-byte stores (1,344 B a row at
//     C' = 8).
//
// Limits: 1-4 conv layers, 1-32 channels each, square kernels of one size
// 1-5, a padded plane (H + KS - 1)(W + KS - 1) of at most 256 cells, 1-128
// slots. opp_cnn_front and opp_cnn_front_layout refuse the rest; train.py
// cnn_opponent_problems refuses it at config time from ppo/pool_rollout.py's
// copy of the MAX_ constants below (tests/test_torch_cnn_front.py holds the
// copy to them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "slot_tiles.cuh"

namespace {

constexpr int THREADS = slot_tiles::WARPS * 32;
constexpr int MAX_LAYERS = 4;
constexpr int MAX_CHANNELS = 32;
constexpr int MAX_KS = 5;
constexpr int MAX_PLANE = 256;
constexpr int MAX_ROWS = 64;
constexpr int CO = 8;                 // output channels of an item
constexpr int SMEM_CAP = 220 * 1024;  // dynamic shared memory of a block, at most

struct Params {
  const float* x;  // [rows, D] raw obs; the spatial slice its first H W C0 columns, NHWC
  const int* slot;  // [rows]
  const float* norm_mean;  // [K, D], nullable
  const float* norm_m2;
  const float* norm_count;  // [K]
  float clip;
  const float* w[MAX_LAYERS];  // [K * ch[l + 1], ch[l], KS, KS]: slot k's OIHW block at k
  const float* b[MAX_LAYERS];  // [K * ch[l + 1]]
  int ch[MAX_LAYERS + 1];      // ch[0] the obs channels, ch[l + 1] layer l's outputs
  int depth;
  float* out;  // [rows, ch[depth], H, W]
  int rows, K, D, H, W;
  // The layout (layout()): rows a tile; floats a row of an activation
  // buffer; the buffers' offsets in floats (a layer's weights at 0).
  int R, pitch, act_off[2];
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Floats of layer l's weights and bias in shared memory.
__host__ __device__ __forceinline__ int weight_floats(const Params& p, int l, int ks) {
  return round_up((p.ch[l] * ks * ks + 1) * round_up(p.ch[l + 1], CO), 4);
}

// Slot k's weights and bias of layer l into shared memory at dst by
// 4-byte cp.async (one commit group), transposed from OIHW to [c_in][kh]
// [kw][c_out8] with the bias row after them; the padding channels zeroed.
template <int KS>
__device__ __forceinline__ void load_weights(const Params& p, int k, int l, float* dst, int tid) {
  const int cin = p.ch[l], cout = p.ch[l + 1], co8 = round_up(cout, CO), per = cin * KS * KS;
  const float* src = p.w[l] + static_cast<size_t>(k) * cout * per;
  for (int i = tid; i < cout * per; i += THREADS) {
    const int co = i / per;
    copy_unit<false>(dst + (i - co * per) * co8 + co, src + i);
  }
  for (int i = tid; i < cout; i += THREADS) {
    copy_unit<false>(dst + per * co8 + i, p.b[l] + static_cast<size_t>(k) * cout + i);
  }
  const int pad = co8 - cout;
  for (int i = tid; i < (per + 1) * pad; i += THREADS) {
    dst[(i / pad) * co8 + cout + i % pad] = 0.0f;
  }
  cp_async_commit();
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int KS, bool BF16>
__global__ void __launch_bounds__(THREADS) opponent_cnn_front_kernel(const __grid_constant__ Params p) {
  constexpr int PAD = (KS - 1) / 2;  // SAME: (KS - 1) / 2 before, KS / 2 after
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) int s_cnt[slot_tiles::WARPS][slot_tiles::MAX_SLOTS];
  __shared__ int s_rows[MAX_ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, W = p.W, HW = H * W, Wp = W + KS - 1, plane = (H + KS - 1) * Wp;
  const int F = p.ch[p.depth] * HW;

  // 1. The tile: the slots' counts, rows of a slot outside [0, K) zeroed
  // (each by one block), the block's (slot, ranks), its row ids.
  const slot_tiles::Scan scan =
      slot_tiles::count_slots(p.slot, p.rows, p.K, warp, lane, s_cnt, [&](int i) {
        for (int j = 0; j < F; ++j) p.out[static_cast<size_t>(i) * F + j] = 0.0f;
      });
  __syncthreads();
  int k, rank0, seg;
  if (!slot_tiles::name_tile(s_cnt, p.K, p.R, static_cast<int>(blockIdx.x), lane, k, rank0, seg)) {
    return;
  }
  load_weights<KS>(p, k, 0, smem, tid);
  slot_tiles::collect_rows(p.slot, scan, s_cnt, k, rank0, seg, warp, lane, s_rows);
  // Both buffers zeroed (the halos; the interiors are written before they
  // are read).
  {
    float4* a = reinterpret_cast<float4*>(smem + p.act_off[0]);
    const int n4 = (p.act_off[1] - p.act_off[0] + seg * p.pitch) / 4;
    for (int i = tid; i < n4; i += THREADS) a[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // 2. The tile's rows, each normalised by slot k, into buffer 0's
  // interiors: every load of a round issued before any is used.
  {
    const int C0 = p.ch[0], row_in = HW * C0, n = seg * row_in;
    const bool normed = p.norm_mean != nullptr && __ldg(p.norm_count + k) >= 2.0f;
    const float cnt = normed ? fmaxf(__ldg(p.norm_count + k), 1.0f) : 1.0f;
    const float* mean_k = normed ? p.norm_mean + static_cast<size_t>(k) * p.D : nullptr;
    const float* m2_k = normed ? p.norm_m2 + static_cast<size_t>(k) * p.D : nullptr;
    float* a0 = smem + p.act_off[0];
    constexpr int U = 4;
    for (int i0 = tid; i0 < n; i0 += U * THREADS) {
      float v[U], mu[U], sq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = 0.0f, mu[u] = 0.0f, sq[u] = 0.0f;
        if (i < n) {
          const int r = i / row_in, c = i - r * row_in;
          v[u] = __ldg(p.x + static_cast<size_t>(s_rows[r]) * p.D + c);
          if (normed) {
            mu[u] = __ldg(mean_k + c);
            sq[u] = __ldg(m2_k + c);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * THREADS;
        if (i >= n) continue;
        const int r = i / row_in, c = i - r * row_in;
        float x = v[u];
        if (normed) {
          const float sd = fmaxf(sqrtf(sq[u] / cnt), 1e-8f);
          const float z = (x - mu[u]) / sd;
          x = z < -p.clip ? -p.clip : (z > p.clip ? p.clip : z);
        }
        if constexpr (BF16) x = round_bf16(x);
        const int pos = c / C0, ci = c - pos * C0, h = pos / W, w = pos - h * W;
        a0[r * p.pitch + ci * plane + (h + PAD) * Wp + w + PAD] = x;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. The layers: an item is (group of eight output channels, row,
  // position), the group slowest so a warp's weight loads are broadcasts.
  for (int l = 0; l < p.depth; ++l) {
    if (l > 0) {
      load_weights<KS>(p, k, l, smem, tid);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int cin = p.ch[l], cout = p.ch[l + 1], co8 = round_up(cout, CO);
    const float* in = smem + p.act_off[l & 1];
    float* outb = smem + p.act_off[(l + 1) & 1];
    const float* wl = smem;
    const float* bias = wl + cin * KS * KS * co8;
    const bool last = l == p.depth - 1;
    const int n = seg * (co8 / CO) * HW;
    for (int i = tid; i < n; i += THREADS) {
      const int pos = i % HW, rest = i / HW, r = rest % seg, g = rest / seg;
      const int h = pos / W, w = pos - h * W;
      float acc[CO];
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[j] = 0.0f;
      const float* src = in + r * p.pitch + h * Wp + w;
      const float* wg = wl + g * CO;
      for (int ci = 0; ci < cin; ++ci) {
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
          for (int kw = 0; kw < KS; ++kw) {
            const float xv = src[ci * plane + kh * Wp + kw];
            const float* wt = wg + ((ci * KS + kh) * KS + kw) * co8;
            const float4 w0 = *reinterpret_cast<const float4*>(wt);
            const float4 w1 = *reinterpret_cast<const float4*>(wt + 4);
            acc[0] = fmaf(xv, w0.x, acc[0]);
            acc[1] = fmaf(xv, w0.y, acc[1]);
            acc[2] = fmaf(xv, w0.z, acc[2]);
            acc[3] = fmaf(xv, w0.w, acc[3]);
            acc[4] = fmaf(xv, w1.x, acc[4]);
            acc[5] = fmaf(xv, w1.y, acc[5]);
            acc[6] = fmaf(xv, w1.z, acc[6]);
            acc[7] = fmaf(xv, w1.w, acc[7]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CO; ++j) {
        const int co = g * CO + j;
        if (co >= cout) break;
        const float v = acc[j] + bias[co];
        if (last) {
          outb[r * p.pitch + co * HW + pos] = v;  // the output's layout
        } else {
          float a = v > 0.0f ? v : 0.0f;
          if constexpr (BF16) a = round_bf16(a);
          outb[r * p.pitch + co * plane + (h + PAD) * Wp + w + PAD] = a;
        }
      }
    }
    __syncthreads();
  }

  // 4. The staged rows out, 16 bytes a store where the rows allow.
  const float* st = smem + p.act_off[p.depth & 1];
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0) {
    const int f4 = F / 4;
    for (int i = tid; i < seg * f4; i += THREADS) {
      const int r = i / f4, c = i - r * f4;
      reinterpret_cast<float4*>(p.out + static_cast<size_t>(s_rows[r]) * F)[c] =
          *reinterpret_cast<const float4*>(st + r * p.pitch + 4 * c);
    }
  } else {
    for (int i = tid; i < seg * F; i += THREADS) {
      const int r = i / F, c = i - r * F;
      p.out[static_cast<size_t>(s_rows[r]) * F + c] = st[r * p.pitch + c];
    }
  }
}

using KernelFn = void (*)(Params);

template <bool BF16>
KernelFn kernel_of(int ks) {
  switch (ks) {
    case 1: return opponent_cnn_front_kernel<1, BF16>;
    case 2: return opponent_cnn_front_kernel<2, BF16>;
    case 3: return opponent_cnn_front_kernel<3, BF16>;
    case 4: return opponent_cnn_front_kernel<4, BF16>;
    default: return opponent_cnn_front_kernel<5, BF16>;
  }
}

// Checks the stack's shape and fills p's layout: room for the largest
// layer's weights, then the two activation buffers of R rows. R's items fill
// half the threads at the widest layer (at least one row, at most
// MAX_ROWS and what shared memory holds): more, smaller blocks spread
// the rows over more SMs. Returns the dynamic shared memory in bytes, or
// -1.
int layout(Params& p, int ks) {
  if (p.depth < 1 || p.depth > MAX_LAYERS || ks < 1 || ks > MAX_KS || p.H < 1 || p.W < 1 ||
      (p.H + ks - 1) * (p.W + ks - 1) > MAX_PLANE) {
    return -1;
  }
  int cmax = 0, groups = 0, wfloats = 0;
  for (int l = 0; l <= p.depth; ++l) {
    if (p.ch[l] < 1 || p.ch[l] > MAX_CHANNELS) return -1;
    cmax = p.ch[l] > cmax ? p.ch[l] : cmax;
  }
  for (int l = 0; l < p.depth; ++l) {
    const int f = weight_floats(p, l, ks), g = round_up(p.ch[l + 1], CO) / CO;
    wfloats = f > wfloats ? f : wfloats;
    groups = g > groups ? g : groups;
  }
  p.pitch = round_up(cmax * (p.H + ks - 1) * (p.W + ks - 1), 4);
  int R = THREADS / (2 * p.H * p.W * groups);
  R = R < 1 ? 1 : (R > MAX_ROWS ? MAX_ROWS : R);
  const int fit = (SMEM_CAP / 4 - wfloats) / (2 * p.pitch);
  R = R < fit ? R : fit;
  if (R < 1) return -1;
  p.R = R;
  p.act_off[0] = wfloats;
  p.act_off[1] = wfloats + R * p.pitch;
  return (wfloats + 2 * R * p.pitch) * 4;
}

Params stack_params(const int* channels, int depth, int H, int W) {
  Params p = {};
  p.depth = depth;
  for (int l = 0; l <= depth && l <= MAX_LAYERS; ++l) p.ch[l] = channels[l];
  p.H = H;
  p.W = W;
  return p;
}

}  // namespace

// The layout of a stack (channels [depth + 1], kernel size ks) on an H x W
// board: out[0] the rows a tile, out[1] the floats a row of an activation
// buffer. Returns
// the dynamic shared memory in bytes, or -1 where the kernel does not take
// the stack.
extern "C" int opp_cnn_front_layout(const int* channels, int depth, int ks, int H, int W,
                                    int* out) {
  if (depth < 1 || depth > MAX_LAYERS) return -1;
  Params p = stack_params(channels, depth, H, W);
  const int smem = layout(p, ks);
  if (smem > 0) {
    out[0] = p.R;
    out[1] = p.pitch;
  }
  return smem;
}

// x: [rows, D] f32 raw obs; slot: [rows] i32; norm_mean, norm_m2 [K, D] and
// norm_count [K] (all null: no normalisation); w, b: depth host pointers to
// each conv layer's stacked weights [K * channels[l + 1], channels[l], ks,
// ks] and biases [K * channels[l + 1]] (f32; bf16 values with bf16 set);
// out: [rows, channels[depth], H, W] f32. One launch of ceil(rows / R) + K
// blocks (those past the last tile exit at once).
extern "C" int opp_cnn_front(const void* x, const void* slot, const void* norm_mean,
                             const void* norm_m2, const void* norm_count, float clip,
                             const void* const* w, const void* const* b, const int* channels,
                             int depth, int ks, int H, int W, int D, void* out, int rows, int K,
                             int bf16, void* stream) {
  if (depth < 1 || depth > MAX_LAYERS || rows < 0 || K < 1 || K > slot_tiles::MAX_SLOTS ||
      (rows > 0 && (x == nullptr || slot == nullptr || out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((norm_mean == nullptr) != (norm_m2 == nullptr) ||
      (norm_mean == nullptr) != (norm_count == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = stack_params(channels, depth, H, W);
  const int smem = layout(p, ks);
  if (smem < 0 || H * W * channels[0] > D) return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < depth; ++l) {
    if (w[l] == nullptr || b[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.w[l] = static_cast<const float*>(w[l]);
    p.b[l] = static_cast<const float*>(b[l]);
  }
  p.x = static_cast<const float*>(x);
  p.slot = static_cast<const int*>(slot);
  p.norm_mean = static_cast<const float*>(norm_mean);
  p.norm_m2 = static_cast<const float*>(norm_m2);
  p.norm_count = static_cast<const float*>(norm_count);
  p.clip = clip;
  p.out = static_cast<float*>(out);
  p.rows = rows;
  p.K = K;
  p.D = D;
  const KernelFn kernel = bf16 ? kernel_of<true>(ks) : kernel_of<false>(ks);
  // The largest dynamic shared memory each instance was allowed so far.
  static int smem_set[2][MAX_KS + 1] = {};
  int& set = smem_set[bf16 ? 1 : 0][ks];
  if (smem > 48 * 1024 && smem > set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = smem;
  }
  const int blocks = (rows + p.R - 1) / p.R + K;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                           dim3(THREADS), args, smem,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
