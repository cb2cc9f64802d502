// The packed-row format of the env step kernels K4, K11 and K13
// (connect_four_step.cu, skull_step.cu, liars_dice_step.cu): an env's
// state is one row of W i32 (W a multiple of 4, so every row starts 16
// bytes after the last), and a block of EB envs stages its rows in shared
// memory at the odd stride W + 1, which spreads the per-env threads' column
// reads over the banks. The outputs are carved from one i32 and one f32
// buffer in blocks of E x columns, each rounded up to 64 elements
// (burn_ppo_torch/envs/base.py arena_size / carve_arena).

#pragma once

#include <cuda_runtime.h>

namespace packed_rows {

constexpr long ALIGN = 64;

// Elements of one output block of num_envs x cols.
__host__ __device__ inline long block_len(long num_envs, int cols) {
  return (num_envs * cols + ALIGN - 1) / ALIGN * ALIGN;
}

template <int W, int EB, int NT>
struct Rows {
  static_assert(W % 4 == 0, "rows must be whole 16-byte groups");
  static constexpr int W4 = W / 4;  // 16-byte groups per row
  static constexpr int WS = W + 1;  // shared-memory row stride, odd
  static constexpr int ITERS = (EB * W4 + NT - 1) / NT;

  // The block's first `count` rows of `src` (one contiguous span) into
  // `rows`, by every thread: all of a thread's 16-byte loads are in flight
  // before its first shared-memory store. The caller syncs after.
  static __device__ __forceinline__ void stage(int* rows, const int* src, int count, int t) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4 v[ITERS];
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (i < count * W4) v[k] = src4[i];
    }
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (i < count * W4) {
        const int ee = i / W4, c = 4 * (i - ee * W4);
        int* r = rows + ee * WS + c;
        r[0] = v[k].x;
        r[1] = v[k].y;
        r[2] = v[k].z;
        r[3] = v[k].w;
      }
    }
  }

  // The staged rows back out to `dst` with 16-byte stores, by every thread.
  static __device__ __forceinline__ void store(int* dst, const int* rows, int count, int t) {
    int4* dst4 = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = t + k * NT;
      if (i < count * W4) {
        const int ee = i / W4, c = 4 * (i - ee * W4);
        const int* r = rows + ee * WS + c;
        dst4[i] = make_int4(r[0], r[1], r[2], r[3]);
      }
    }
  }
};

}  // namespace packed_rows
