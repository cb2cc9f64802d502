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
// 86 -> 512 -> 512 -> 7 is 309,760 MACs a row. On the tensor cores an
// f32-accurate product costs three TF32 products (the 3xTF32 split below),
// 1.9 GFLOP a call at 495 TFLOP/s, ~3.8 us; the K = 8 stacked weights (9.9
// MB) stay in the 50 MB L2 between calls.
//
// The design: ONE launch. A cluster of C blocks takes 32 rows of one slot
// and runs them through every layer:
//   * Rows by slot without a sort launch: every block copies the Ep slot
//     ids into shared memory and reads them once (per warp a contiguous
//     range, __match_any_sync counts per slot), so it knows each slot's
//     row count; its cluster index then
//     names a (slot, tile) pair, and the warps whose range holds the
//     tile's ranks collect its row ids with a ballot scan. Rows of a slot
//     outside [0, K) are zeroed, each by one block.
//   * The tile's obs rows are gathered and normalised once into shared
//     memory (the identity while the slot's count < 2, otherwise
//     clip((x - mean) / max(sqrt(m2 / max(count, 1)), 1e-8), -clip, clip),
//     the order of K6 and of the plain version), zero-padded to 32 columns,
//     every load of a lane issued before any is used.
//   * Activations stay on chip: one R-row buffer in dynamic shared memory
//     holds a layer's input; its outputs wait in the accumulators until
//     every block of the cluster has read the input, then overwrite it.
//     Only the logits are written to device memory.
//   * The slot's weights stream through a ring of S stages of 32 rows with
//     cp.async, so the next stages' loads are in flight during the math;
//     the loads of layer l + 1 start while layer l computes.
//   * Products on the tensor cores, mma.sync m16n8k8 TF32, with the 3xTF32
//     split: x = big + small, both TF32, and a * b = a_small * b_big +
//     a_big * b_small + a_big * b_big summed in f32 (a_small * b_small,
//     ~2^-22 of the product, is dropped). This keeps f32 accuracy; TF32
//     stays off everywhere else.
//   * Filling the card: at Ep ~ 1024 and K = 8 there are ~36-40 tiles of
//     32 rows. The blocks of a cluster split each layer's columns, and each
//     writes its slice into every block's input buffer (distributed shared
//     memory), two cluster barriers per layer. The tilings (R, C) offered:
//     32 x 2 and 32 x 3 (16- and 64-row tiles measured slower). A
//     cluster's blocks must share a GPC, so not every SM can hold one: by default the kernel takes 32 x 3 when the
//     card holds every expected tile's cluster at once
//     (cudaOccupancyMaxActiveClusters) with a block per SM, else 32 x 2,
//     so that no cluster waits for a second wave. Every tile streams its slot's weights from
//     L2: ~45 MB a call at 32 rows (Connect Four's MLP).
//   * Activations are split into TF32 (big, small) pairs once, when they
//     are stored, in an order that makes an mma fragment's pairs one
//     16-byte load.
//   * Each warp's three products of a tile run as three sweeps over its
//     column tiles, so that consecutive mma.sync write different
//     accumulators and do not wait on each other.
// Hidden widths must be multiples of 32 and at most 512, the obs width at
// most 512, the head at most 64 wide, K at most 128 (the wrapper refuses
// the rest). Sums run in another order than cuBLAS's: the logits agree
// with the plain version to f32 rounding of 512-term dot products.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KC = 32;  // weight rows per pipeline stage
constexpr int MAX_LAYERS = 4;
constexpr int MAX_SLOTS = 128;
constexpr int MAX_WIDTH = 512;
constexpr int MAX_HEAD = 64;
constexpr int MAX_ROWS = 32;

struct Params {
  const float* x;  // [Ep, D] raw obs
  const int* slot;  // [Ep]
  const float* norm_mean;  // [K, D], nullable
  const float* norm_m2;  // [K, D]
  const float* norm_count;  // [K]
  float clip;
  const float* w[MAX_LAYERS];  // [K, n_in, n_out]
  const float* b[MAX_LAYERS];  // [K, n_out]
  int n_in[MAX_LAYERS], n_out[MAX_LAYERS];
  int depth, act;
  float* out;  // [Ep, A]
  int rows, K;
  int act_pitch;  // floats per activation row (big and small parts): = 16 (mod 32)
  int w_pitch;  // floats per staged weight row: = 8 (mod 32)
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v > 0.0f ? v : 0.0f;
  if (act == 2) return tanhf(v);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// Where column c of an activation row keeps its (big, small) pair: in
// each group of 8 columns the order is 0, 4, 1, 5, 2, 6, 3, 7, so that an
// mma fragment's columns t and t + 4 (big and small each) are one 16-byte
// load.
__device__ __forceinline__ int act_pos(int c) {
  const int w = c & 7;
  return (c & ~7) * 2 + ((w & 3) * 2 + (w >> 2)) * 2;
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t big, small;
  split(x, big, small);
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 8-column tiles of a layer's n_out that cluster rank ``rank`` of C
// computes: columns [lo, lo + 8 * tiles).
__device__ __forceinline__ void column_slice(int n_out, int rank, int C, int& lo, int& tiles) {
  const int all = (n_out + 7) / 8, per = (all + C - 1) / C;
  const int t0 = min(all, rank * per), t1 = min(all, t0 + per);
  lo = t0 * 8;
  tiles = t1 - t0;
}

// Issue the cp.async copies of weight chunk ``c`` (KC rows of the block's
// column slice of one layer, for slot k) into stage ``dst``. A thread takes
// one 16-byte column unit (4 bytes for a head whose width is not a multiple
// of 4) in every rows_per_pass-th row.
__device__ __forceinline__ void load_chunk(const Params& p, const int* chunk_start, int c, int k,
                                           int rank, int C, float* dst) {
  int l = 0;
  while (c >= chunk_start[l + 1]) ++l;
  const int n_in = p.n_in[l], n_out = p.n_out[l];
  int lo, tiles;
  column_slice(n_out, rank, C, lo, tiles);
  const int k0 = (c - chunk_start[l]) * KC;
  const float* w = p.w[l] + static_cast<long>(k) * n_in * n_out;
  const bool vec = (n_out & 3) == 0;
  const int unit = vec ? 4 : 1, per_row = tiles * 8 / unit;
  if (per_row == 0) return;
  const int rows_per_pass = THREADS / per_row;
  const int r0 = threadIdx.x / per_row, col = lo + unit * (threadIdx.x - r0 * per_row);
  if (r0 >= rows_per_pass) return;
  for (int r = r0; r < KC; r += rows_per_pass) {
    const int kk = k0 + r;
    const bool ok = kk < n_in && col < n_out;
    const float* src = ok ? w + static_cast<long>(kk) * n_out + col : w;
    float* d = dst + r * p.w_pitch + (col - lo);
    if (vec) {
      cp_async16(d, src, ok ? 16 : 0);
    } else {
      cp_async4(d, src, ok ? 4 : 0);
    }
  }
}

// R rows per cluster tile, C blocks per cluster, S pipeline stages; NTW
// 8-column tiles per warp at most (a 512-wide layer split C ways).
template <int R, int C, int S>
__global__ void __launch_bounds__(THREADS, 1) opponent_mlp_kernel(const Params p) {
  constexpr int MT = R / 16;
  constexpr int NTW = (MAX_WIDTH / 8 / WARPS + C - 1) / C;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_cnt[WARPS][MAX_SLOTS];
  __shared__ int s_rows[MAX_ROWS];
  __shared__ int s_tile[4];  // slot, first rank, rows, live

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(blockIdx.x % C);
  const int tile = blockIdx.x / C;
  const int K = p.K, rows = p.rows, A = p.n_out[p.depth - 1];
  float* act = smem;
  const int ap = p.act_pitch;

  // 0. The slot ids into shared memory (the activation buffer, free until
  // the gather), when they fit: both passes below read them twice.
  const int* slots = p.slot;
  if (rows <= R * ap) {
    int* s_slot = reinterpret_cast<int*>(act);
    for (int i = tid; i < rows; i += THREADS) cp_async4(s_slot + i, p.slot + i, 4);
    cp_async_commit();
    cp_async_wait<0>();
    slots = s_slot;
  }
  // 1. Each warp counts the slots of its contiguous range of rows.
  for (int i = tid; i < WARPS * MAX_SLOTS; i += THREADS) (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const int span = (rows + WARPS * 32 - 1) / (WARPS * 32) * 32;
  const int r_lo = min(rows, warp * span), r_hi = min(rows, r_lo + span);
  for (int i0 = r_lo; i0 < r_hi; i0 += 32) {
    const int i = i0 + lane;
    const int s = i < r_hi ? slots[i] : -1;
    const bool inside = s >= 0 && s < K;
    if (i < r_hi && !inside && i % gridDim.x == blockIdx.x) {
      for (int a = 0; a < A; ++a) p.out[static_cast<long>(i) * A + a] = 0.0f;
    }
    const unsigned same = __match_any_sync(0xffffffffu, inside ? s : -1);
    if (inside && lane == __ffs(same) - 1) s_cnt[warp][s] += __popc(same);
  }
  __syncthreads();
  // 2. Warp 0 names this cluster's (slot, tile): lane q owns slots 4q..4q+3.
  if (warp == 0) {
    int tot[4], tiles_q = 0;
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * lane + j;
      tot[j] = 0;
      if (k < K) {
        for (int w = 0; w < WARPS; ++w) tot[j] += s_cnt[w][k];
      }
      tiles_q += (tot[j] + R - 1) / R;
    }
    int incl = tiles_q;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    int first = incl - tiles_q;
    if (lane == 0) s_tile[3] = 0;
    __syncwarp();
    for (int j = 0; j < 4; ++j) {
      const int n = (tot[j] + R - 1) / R;
      if (tile >= first && tile < first + n) {
        const int t = tile - first;
        s_tile[0] = 4 * lane + j;
        s_tile[1] = t * R;
        s_tile[2] = min(R, tot[j] - t * R);
        s_tile[3] = 1;
      }
      first += n;
    }
  }
  __syncthreads();
  if (!s_tile[3]) return;  // the whole cluster: past the last tile
  const int k = s_tile[0], rank0 = s_tile[1], seg_rows = s_tile[2];
  // 3. The tile's row ids: ranks [rank0, rank0 + seg_rows) of slot k.
  {
    int base = 0;
    for (int w = 0; w < warp; ++w) base += s_cnt[w][k];
    if (base < rank0 + seg_rows && base + s_cnt[warp][k] > rank0) {
      for (int i0 = r_lo; i0 < r_hi; i0 += 32) {
        const int i = i0 + lane;
        const bool mine = i < r_hi && slots[i] == k;
        const unsigned bal = __ballot_sync(0xffffffffu, mine);
        const int rk = base + __popc(bal & ((1u << lane) - 1u));
        if (mine && rk >= rank0 && rk < rank0 + seg_rows) s_rows[rk - rank0] = i;
        base += __popc(bal);
      }
    }
  }
  __syncthreads();

  float* stages = smem + R * ap;
  const int stage_len = KC * p.w_pitch;

  // Weight chunks of every layer in one sequence; start the ring now.
  int chunk_start[MAX_LAYERS + 1];
  chunk_start[0] = 0;
  for (int l = 0; l < MAX_LAYERS; ++l) {
    chunk_start[l + 1] = chunk_start[l] + (l < p.depth ? (p.n_in[l] + KC - 1) / KC : 0);
  }
  const int total = chunk_start[p.depth];
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load_chunk(p, chunk_start, s, k, rank, C, stages + s * stage_len);
    cp_async_commit();
  }

  // 4. Gather and normalise the tile's obs rows once (zeros past the tile
  // and in the padding columns): a warp takes R / WARPS rows, a lane every
  // 32nd column, all of its loads issued before any is used.
  {
    constexpr int RPW = R / WARPS, CPL = MAX_WIDTH / 32;
    const int D = p.n_in[0], Dp = (D + KC - 1) / KC * KC;
    const bool normed = p.norm_mean != nullptr && p.norm_count[k] >= 2.0f;
    float mean[CPL], sd[CPL], v[RPW][CPL];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = warp * RPW + q;
      const float* xr = p.x + static_cast<long>(r < seg_rows ? s_rows[r] : 0) * D;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        v[q][i] = r < seg_rows && c < D ? xr[c] : 0.0f;
      }
    }
    if (normed) {
      const float cnt = p.norm_count[k];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        const long d = static_cast<long>(k) * D + c;
        mean[i] = c < D ? p.norm_mean[d] : 0.0f;
        sd[i] = c < D ? fmaxf(sqrtf(p.norm_m2[d] / fmaxf(cnt, 1.0f)), 1e-8f) : 1.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      const int r = warp * RPW + q;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < Dp) {
          float x = v[q][i];
          if (normed && r < seg_rows && c < D) {
            const float z = (x - mean[i]) / sd[i];
            x = z < -p.clip ? -p.clip : (z > p.clip ? p.clip : z);
          }
          *reinterpret_cast<float2*>(act + r * ap + act_pos(c)) = split2(x);
        }
      }
    }
  }
  // No cluster barrier here: the first remote store comes after the
  // barrier that precedes every layer's epilogue, which all peers reach.

  const int grp = lane >> 2, tig = lane & 3;
  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

  int l = 0, lo, tiles;
  column_slice(p.n_out[0], rank, C, lo, tiles);
  for (int c = 0; c < total; ++c) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (c + S - 1 < total) {
      load_chunk(p, chunk_start, c + S - 1, k, rank, C, stages + ((c + S - 1) % S) * stage_len);
    }
    cp_async_commit();

    const float* in = act;
    const float* ws = stages + (c % S) * stage_len;
    const int kbase = (c - chunk_start[l]) * KC;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      uint32_t ab[MT][4], as[MT][4], bb[NTW][2], bs[NTW][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        // (big, small) of columns t and t + 4, rows g and g + 8: split once
        // when the activation was stored.
        const float* a = in + (m * 16 + grp) * ap + (kbase + ks) * 2 + 4 * tig;
        const float4 lo4 = *reinterpret_cast<const float4*>(a);
        const float4 hi4 = *reinterpret_cast<const float4*>(a + 8 * ap);
        ab[m][0] = __float_as_uint(lo4.x), as[m][0] = __float_as_uint(lo4.y);
        ab[m][2] = __float_as_uint(lo4.z), as[m][2] = __float_as_uint(lo4.w);
        ab[m][1] = __float_as_uint(hi4.x), as[m][1] = __float_as_uint(hi4.y);
        ab[m][3] = __float_as_uint(hi4.z), as[m][3] = __float_as_uint(hi4.w);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (warp + j * WARPS < tiles) {
          const float* b = ws + (ks + tig) * p.w_pitch + (warp + j * WARPS) * 8 + grp;
          split(b[0], bb[j][0], bs[j][0]);
          split(b[4 * p.w_pitch], bb[j][1], bs[j][1]);
        }
      }
      // The three products of each tile in three sweeps over the tiles,
      // so that consecutive mma.sync write different accumulators.
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (warp + j * WARPS < tiles) {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], as[m], bb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (warp + j * WARPS < tiles) {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], ab[m], bs[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (warp + j * WARPS < tiles) {
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], ab[m], bb[j]);
        }
      }
    }

    if (c + 1 < chunk_start[l + 1]) continue;
    // The layer's last chunk: bias, activation, and the next input (or the
    // logits). The next input overwrites this one once every block of the
    // cluster has read it.
    const int n_out = p.n_out[l];
    const float* bias = p.b[l] + static_cast<long>(k) * n_out;
    const bool head = l == p.depth - 1;
    if (!head) cg::this_cluster().sync();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = warp + j * WARPS;
        if (nt >= tiles) continue;
        const int col = lo + nt * 8 + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m * 16 + grp + 8 * h;
          float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
          if (head) {
            if (r < seg_rows) {
              float* o = p.out + static_cast<long>(s_rows[r]) * n_out;
              if (col < n_out) o[col] = v0 + bias[col];
              if (col + 1 < n_out) o[col + 1] = v1 + bias[col + 1];
            }
          } else {
            const float2 x0 = split2(activate(v0 + bias[col], p.act));
            const float2 x1 = split2(activate(v1 + bias[col + 1], p.act));
            float* d0 = act + r * ap + act_pos(col);
            float* d1 = act + r * ap + act_pos(col + 1);
            *reinterpret_cast<float2*>(d0) = x0;
            *reinterpret_cast<float2*>(d1) = x1;
            cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
            for (int q = 1; q < C; ++q) {
              *reinterpret_cast<float2*>(cluster.map_shared_rank(d0, (rank + q) % C)) = x0;
              *reinterpret_cast<float2*>(cluster.map_shared_rank(d1, (rank + q) % C)) = x1;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
      }
    }
    if (head) break;
    // The next input is complete in every block of the cluster.
    cg::this_cluster().sync();
    ++l;
    column_slice(p.n_out[l], rank, C, lo, tiles);
  }
  cp_async_wait<0>();
}

// The launch of one tiling: a cluster of C blocks per tile, the grid one
// cluster per possible tile (some exit at once).
template <int R, int C, int S>
struct Tiling {
  static cudaLaunchConfig_t config(const Params& p, int smem, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((p.rows + R - 1) / R + p.K) * C);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  static cudaError_t allow(int smem) {
    static int smem_set = 0;
    if (smem <= smem_set) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        opponent_mlp_kernel<R, C, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) smem_set = smem;
    return err;
  }

  // How many clusters the card runs at once at this shared memory (a
  // cluster's blocks must share a GPC), or -1 on error.
  static int resident_clusters(const Params& p, int smem) {
    static int cached_smem = -1, cached = -1;
    if (smem != cached_smem) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = config(p, smem, nullptr, &attr);
      int n = -1;
      if (allow(smem) != cudaSuccess ||
          cudaOccupancyMaxActiveClusters(&n, opponent_mlp_kernel<R, C, S>, &cfg) !=
              cudaSuccess) {
        return -1;
      }
      cached_smem = smem;
      cached = n;
    }
    return cached;
  }

  static int launch(const Params& p, int smem, cudaStream_t stream) {
    cudaError_t err = allow(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(p, smem, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, opponent_mlp_kernel<R, C, S>, p);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
};

using Tiling32x2 = Tiling<32, 2, 2>;
using Tiling32x3 = Tiling<32, 3, 3>;

// (R, C, S) of each tiling the entry point offers, in the order above.
constexpr int TILINGS[][3] = {{32, 2, 2}, {32, 3, 3}};
constexpr int NUM_TILINGS = sizeof(TILINGS) / sizeof(TILINGS[0]);

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The activation and weight-stage pitches of a tiling, and its shared
// memory in bytes.
int layout(Params& p, const int* widths, int depth, int tiling) {
  const int R = TILINGS[tiling][0], C = TILINGS[tiling][1], S = TILINGS[tiling][2];
  int widest = round_up(widths[0], KC), slice = 0;
  for (int l = 0; l < depth; ++l) {
    if (l > 0) widest = widths[l] > widest ? widths[l] : widest;
    const int all = (widths[l + 1] + 7) / 8, per = (all + C - 1) / C;
    slice = per * 8 > slice ? per * 8 : slice;
  }
  p.act_pitch = 2 * round_up(widest, 32) + 16;
  p.w_pitch = round_up(slice, 32) + 8;
  return static_cast<int>(sizeof(float)) * (R * p.act_pitch + S * KC * p.w_pitch);
}

// The default tiling: 3-block clusters when each expected tile (Ep / 32,
// and half a tile more per slot) gets its cluster at once and its blocks an
// SM each (a cluster that waits for a free GPC doubles the call; blocks
// that share an SM run at half speed: 3 x tiles within 90% of the SMs),
// else 2-block clusters. -1 on error.
int choose_tiling(Params& p, const int* widths, int depth, int* resident = nullptr) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return -1;
    }
  }
  const int n = Tiling32x3::resident_clusters(p, layout(p, widths, depth, 1));
  if (resident != nullptr) *resident = n;
  if (n < 0) return -1;
  const int tiles = (p.rows + 31) / 32 + (p.K + 1) / 2;
  return tiles <= n && 3 * tiles <= sms - sms / 10 ? 1 : 0;
}

}  // namespace

// The tiling opp_mlp_forward takes by default for these widths, rows and
// slots, and in *resident the 3-block clusters the card holds at once.
extern "C" int opp_mlp_default_tiling(const int* widths, int depth, int rows, int K,
                                      int* resident) {
  Params p = {};
  p.rows = rows;
  p.K = K;
  return choose_tiling(p, widths, depth, resident);
}

// widths: depth + 1 entries (obs, hidden..., head); w, b: depth pointers
// each (host arrays); act: 0 = none, 1 = relu, 2 = tanh. norm_mean,
// norm_m2, norm_count: all null for no normalisation. tiling: an index of
// TILINGS, or -1 for choose_tiling's. out: [rows, head].
extern "C" int opp_mlp_forward(const void* x, const void* slot, const void* norm_mean,
                               const void* norm_m2, const void* norm_count, float clip,
                               const void* const* w, const void* const* b, const int* widths,
                               int depth, int act, void* out, int rows, int K, int tiling,
                               void* stream) {
  if (depth < 1 || depth > MAX_LAYERS || K < 1 || K > MAX_SLOTS || rows < 0 || act < 0 ||
      act > 2 || tiling < -1 || tiling >= NUM_TILINGS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (widths[0] < 1 || widths[0] > MAX_WIDTH || widths[depth] < 1 || widths[depth] > MAX_HEAD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 1; l < depth; ++l) {
    if (widths[l] < 32 || widths[l] > MAX_WIDTH || widths[l] % 32 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rows == 0) return 0;
  Params p = {};
  p.x = static_cast<const float*>(x);
  p.slot = static_cast<const int*>(slot);
  p.norm_mean = static_cast<const float*>(norm_mean);
  p.norm_m2 = static_cast<const float*>(norm_m2);
  p.norm_count = static_cast<const float*>(norm_count);
  p.clip = clip;
  for (int l = 0; l < depth; ++l) {
    p.w[l] = static_cast<const float*>(w[l]);
    p.b[l] = static_cast<const float*>(b[l]);
    p.n_in[l] = widths[l];
    p.n_out[l] = widths[l + 1];
  }
  p.depth = depth;
  p.act = act;
  p.out = static_cast<float*>(out);
  p.rows = rows;
  p.K = K;
  if (tiling < 0) {
    tiling = choose_tiling(p, widths, depth);
    if (tiling < 0) return static_cast<int>(cudaGetLastError());
  }
  const int smem = layout(p, widths, depth, tiling);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tiling == 0 ? Tiling32x2::launch(p, smem, s) : Tiling32x3::launch(p, smem, s);
}
