// K7's bf16 tower and its feature front, redesigned for Hopper: the body
// both share (csrc/opponent_tower.cu instantiates the bf16 tower over the
// raw obs, csrc/opponent_features.cu the feature front in f32 and bf16).
//
// What they compute (ROADMAP queue B, items B11b and B11c):
//   * the bf16 tower: the counterpart of the bf16 XLA fusion of
//     burn_ppo_tpu/ppo/pool_rollout.py opponent_logits (126-139) under the
//     slot selection (170-186), where the learner's network runs with
//     compute_dtype bfloat16 (models/core.py:37-43 dense: bf16 operands,
//     an f32 product, the f32 bias). Each row runs its own acting slot
//     only: the slot's obs normalisation in f32 (the identity while its
//     count < 2), rounded to bf16; each hidden layer's bias and activation
//     in f32, rounded to bf16 as the next layer's operand; f32 logits.
//     Plain twin: pool_rollout.py opponent_actor_forward_plain on a bf16
//     stack.
//   * the feature front: the tail of the CNN opponents' XLA fusion,
//     models/network.py _cnn_features' last relu, flatten and concat
//     (187-198) and the FC tower and policy head (216-219) under the same
//     vmap, f32 (3xTF32 products) or bf16. Plain twin: pool_rollout.py
//     opponent_features_forward_plain.
//
// What bounds them on an H100: the bf16 tower's products at the tensor
// cores' bf16 rate and its slot's weights, which every tile of rows reads
// from L2; the feature front's gathered features and its small tower.
// The parent design (csrc/opponent_actor.cu before this file) ran at 29x
// the bound: a chain of latencies, not work. Each point below answers one
// link of that chain. What remains (scripts/opponent_tower_trace.py, PERF.md
// rows B11b, B11c): the delivery of each block's weight slice from L2,
// ~45 GB/s an SM while ~80 SMs pull (a row pair sharing each copy by
// multicast delivered no faster), and the prologue before the first
// products, the slot scan and the gather.
//   * Weights packed at the rotation (ppo/opponent_pack.py): each layer
//     of each slot as [k-block][8-column tile][lane][16 bytes], the order
//     in which a warp's mma.sync B fragments sit in registers (bf16: two
//     m16n8k16 steps of 16 rows; f32: two m16n8k8 steps of 8 rows), the
//     head padded to 8 columns and the inputs to a whole k-block with
//     zeros. A lane's fragments of two k-steps are one conflict-free
//     16-byte shared load, no ldmatrix, no padding in shared memory. The
//     feature front's first layer is permuted into the conv output's NCHW
//     order there, so that a row's features are one contiguous range.
//   * Weights by the Tensor Memory Accelerator: one producer warp walks
//     the block's chunks (a chunk: as many k-blocks of one layer's column
//     slice as fit a stage, whole layers where they fit) and moves each
//     by cp.async.bulk into a ring of up to 16 stages of up to 32 KB (a
//     copy of 16 KB or less delivered at half the rate), each completing
//     on an mbarrier with its expected bytes; the eight consumer warps wait
//     on a stage's "full" barrier and release it through its "empty"
//     barrier, one arrive a warp. No block barrier a chunk. The ring
//     takes what shared memory the activations leave (up to 222 KB in
//     all), so most towers sit in it whole and the rest stream with many
//     stages in flight; the head's slice is one copy.
//   * A short prologue (csrc/slot_tiles.cuh, shared with K20): one pass
//     over the slot ids (each warp a contiguous range, a lane four rows,
//     __match_any_sync counts per slot), one block barrier, then every
//     warp names the block's (slot, tile) by itself; the producer starts
//     the tile's first copies at once, while the consumers collect its row
//     ids (a shuffle scan) and gather its rows.
//   * Clusters only for the bf16 tower, whose wide layers the C blocks of
//     a cluster split by columns: each block stores its slice of a layer's
//     output into its own next input buffer, then warp 0's lanes push its
//     rows to every other block by bulk copies (shared memory to shared
//     memory), each completing on the receiver's "ready" mbarrier, which
//     the receiver's own arrive, with the bytes it expects, completes; the
//     input buffers alternate, so one wait a layer orders both the copies
//     and the reuse. The feature front runs without a cluster: one block
//     holds its slot's whole tower (f32: 44 KB a slot at Connect Four's
//     shape), FEATURE_ROWS rows a block so that the blocks fill the card.
//   * Every warp works on every layer: a slice narrower than the warps'
//     share (a head, the feature front's 32-wide layer) splits its
//     k-blocks into parts over the warps, several tiles a warp, and the
//     parts are summed through shared memory in a fixed order.
//   * The gather issues every load of a round (four column groups of a
//     warp's rows, each lane's columns' normaliser loaded once) before any
//     is used; the feature front reads a row's features as one contiguous
//     range of the conv output with 16-byte loads, relu'd as they are
//     stored. A layer's bias is loaded while its stages land.
// Products stay on mma.sync (bf16 m16n8k16 with f32 sums; the f32 front's
// 3xTF32 split on m16n8k8: x = big + small, a * b = a_small * b_big +
// a_big * b_small + a_big * b_big in f32).
//
// Widths: hidden layers multiples of 32 up to 512, the input up to 512,
// the head up to 64, at most 4 layers and 128 slots (the wrapper refuses
// the rest).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "slot_tiles.cuh"

namespace opp_tower {

constexpr int CWARPS = 8;  // consumer warps
constexpr int CTHREADS = CWARPS * 32;
static_assert(CWARPS == slot_tiles::WARPS, "the consumer warps scan the slots");
constexpr int THREADS = CTHREADS + 32;  // and one producer warp
constexpr int MAX_LAYERS = 4;
constexpr int MAX_SLOTS = slot_tiles::MAX_SLOTS;
constexpr int MAX_WIDTH = 512;
constexpr int MAX_HEAD = 64;
constexpr int MAX_ROWS = 32;
// Rows a tile of the feature front (32 was slower at the pool block and
// spilled in bf16; PERF.md, B11c).
constexpr int FEATURE_ROWS = 16;
constexpr int MAX_STAGES = 16;
constexpr int UNIT = 512;  // bytes of one (k-block, 8-column tile): 32 lanes x 16
constexpr int STAGE_CAP = 32768;
// Dynamic shared memory of a block, at most: the 227 KB a block may use,
// less the static arrays (~4.6 KB).
constexpr int SMEM_CAP = 222 * 1024;

struct Params {
  const float* x;  // [rows, obs_stride] raw obs
  const int* slot;  // [rows]
  const float* norm_mean;  // [K, obs_stride], nullable
  const float* norm_m2;
  const float* norm_count;  // [K]
  float clip;
  const void* w[MAX_LAYERS];  // packed (ppo/opponent_pack.py): [K, kb, nt, 32, 16 bytes]
  const float* b[MAX_LAYERS];  // [K, n_out]
  int n_in[MAX_LAYERS], n_out[MAX_LAYERS];
  int depth, act;
  float* out;  // [rows, head]
  int rows, K;
  int obs_stride, obs_off;  // the tower's first obs column reads obs column obs_off
  // The feature front: the last conv's output of each row's own slot
  // (K20's), contiguous [rows, feat_len] in NCHW order, before its relu.
  const float* feat;
  int feat_len;
  // Dynamic shared memory: the two input buffers (byte offsets; elements
  // a row: bf16 values, or floats of (big, small) pairs), the k-parts'
  // scratch (the head's: the buffer it does not read, where that holds
  // it), the ring.
  int act_off[2], act_pitch[2];
  int scratch_off, head_scratch_off, ring_off, stage_bytes, stages;
#ifdef OPP_TOWER_TRACE
  // Nullable: [blocks, TRACE_SLOTS] %globaltimer marks of each block's
  // phases (trace_buffer()).
  unsigned long long* trace;
#endif
};

// A build with OPP_TOWER_TRACE defined (scripts/opponent_tower_trace.py
// builds one into a library of its own) records the phase marks of a
// launch, a block: 0 start, 1 the slot
// count, 2 the tile named, 3 its rows collected, 4 its rows gathered, 5
// the cluster running; for layer l at 6 + 4 l: its input ready, its first
// stage landed, its last stage used, its epilogue done; 22 the end; 23 the
// producer's first copy, 24 its last; 25 the SM, 26 the slot, 27 the
// tile's rows.
constexpr int TRACE_SLOTS = 32;

#ifdef OPP_TOWER_TRACE
// The trace buffer the next launches record into (null: none), set by
// opp_tower_trace.
inline unsigned long long*& trace_buffer() {
  static unsigned long long* buffer = nullptr;
  return buffer;
}

__device__ __forceinline__ void mark(const Params& p, int slot) {
  if (p.trace != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    p.trace[blockIdx.x * TRACE_SLOTS + slot] = t;
  }
}

__device__ __forceinline__ void mark_tile(const Params& p, int k, int seg) {
  if (p.trace != nullptr) {
    mark(p, 2);
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(sm));
    p.trace[blockIdx.x * TRACE_SLOTS + 25] = sm;
    p.trace[blockIdx.x * TRACE_SLOTS + 26] = k;
    p.trace[blockIdx.x * TRACE_SLOTS + 27] = seg;
  }
}
#else
__device__ __forceinline__ void mark(const Params&, int) {}
__device__ __forceinline__ void mark_tile(const Params&, int, int) {}
#endif

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v > 0.0f ? v : 0.0f;
  if (act == 2) return tanhf(v);
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, bulk copies, cluster barriers ---------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The wait that acquires what other blocks of the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The cluster barrier for one thread of a warp (no .aligned).
__device__ __forceinline__ void cluster_wait_one() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_one() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The consumer warps alone (the producer never joins).
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CTHREADS) : "memory");
}

// ---- tensor-core products -------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t big, small;
  split(x, big, small);
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}

// Where column c of an f32 input row keeps its (big, small) pair: in each
// group of 8 columns the order 0, 4, 1, 5, 2, 6, 3, 7, so that an mma
// fragment's columns t and t + 4 are one 16-byte load.
__device__ __forceinline__ int act_pos(int c) {
  const int w = c & 7;
  return (c & ~7) * 2 + ((w & 3) * 2 + (w >> 2)) * 2;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of a 16 x 16 bf16 tile (row-major): lane l gives the
// address of row l % 16, columns 8 (l / 16) on.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// ---- the plan of a layer ----------------------------------------------------
// A layer of a cluster block: its k-blocks, its 8-column tiles, the block's
// slice [t0, t0 + ntr) of them, k-blocks a chunk (cb) and chunks, and how
// the eight consumer warps share it: G warps a k-part (the slice's tiles
// dealt round-robin, nw <= NTW a warp), P = 8 / G k-parts, each taking
// every P-th k-block. A slice of 8 tiles or more is one part; a narrower
// one (a head, a 32-wide layer) is split into parts so that every warp
// works, and the parts are summed through shared memory in a fixed order.
struct Plan {
  int kb, nt, t0, ntr, cb, chunks, G, P, nw;
};

__device__ __host__ __forceinline__ Plan plan_of(const int* n_in, const int* n_out, int stage_bytes,
                                                 int l, int rank, int C, int KB, int NTW) {
  Plan q;
  q.kb = (n_in[l] + KB - 1) / KB;
  q.nt = (n_out[l] + 7) / 8;
  const int per = (q.nt + C - 1) / C;
  q.t0 = q.nt < rank * per ? q.nt : rank * per;
  q.ntr = (q.nt < q.t0 + per ? q.nt : q.t0 + per) - q.t0;
  const int fit = q.ntr > 0 ? stage_bytes / (q.ntr * UNIT) : 0;
  q.cb = q.ntr > 0 ? (fit < 1 ? 1 : (fit < q.kb ? fit : q.kb)) : 0;
  q.chunks = q.ntr > 0 ? (q.kb + q.cb - 1) / q.cb : 0;
  q.G = CWARPS;
  if (q.ntr < CWARPS) {
    q.G = 1;
    while (q.G * NTW < q.ntr) q.G *= 2;
  }
  q.P = CWARPS / q.G;
  q.nw = (q.ntr + q.G - 1) / q.G;
  return q;
}

// ---- one k-block of products ------------------------------------------------
// The warp's tiles nt = gw, gw + G, ... of the block's slice, over k-block
// kb of the input ``act`` (pitch ``ap``); ``st`` the k-block's packed tiles
// in the stage. Every fragment is loaded first, then the products of the
// first k-step on every tile, then the second's.
template <int MT, int NTW>
__device__ __forceinline__ void kblock_bf16(float (&acc)[MT][NTW][4], const __nv_bfloat16* act,
                                            int ap, int kb, const unsigned char* st, int ntr,
                                            int gw, int G, int lane) {
  uint32_t a[2][MT][4], b[NTW][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldmatrix_x4(a[s][m], act + (m * 16 + (lane & 15)) * ap + kb * 32 + s * 16 + (lane >> 4) * 8);
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (gw + j * G < ntr) {
      const uint4 v = *reinterpret_cast<const uint4*>(st + ((gw + j * G) * 32 + lane) * 16);
      b[j][0] = v.x, b[j][1] = v.y, b[j][2] = v.z, b[j][3] = v.w;
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (gw + j * G < ntr) {
        const uint32_t bs[2] = {b[j][2 * s], b[j][2 * s + 1]};
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], a[s][m], bs);
      }
    }
  }
}

template <int MT, int NTW>
__device__ __forceinline__ void kblock_tf32(float (&acc)[MT][NTW][4], const float* act, int ap,
                                            int kb, const unsigned char* st, int ntr, int gw,
                                            int G, int lane) {
  const int grp = lane >> 2, tig = lane & 3;
  uint32_t ab[2][MT][4], as[2][MT][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      // (big, small) of columns t and t + 4, rows g and g + 8: split once
      // when the input was stored.
      const float* a = act + (m * 16 + grp) * ap + (kb * 16 + s * 8) * 2 + 4 * tig;
      const float4 lo = *reinterpret_cast<const float4*>(a);
      const float4 hi = *reinterpret_cast<const float4*>(a + 8 * ap);
      ab[s][m][0] = __float_as_uint(lo.x), as[s][m][0] = __float_as_uint(lo.y);
      ab[s][m][2] = __float_as_uint(lo.z), as[s][m][2] = __float_as_uint(lo.w);
      ab[s][m][1] = __float_as_uint(hi.x), as[s][m][1] = __float_as_uint(hi.y);
      ab[s][m][3] = __float_as_uint(hi.z), as[s][m][3] = __float_as_uint(hi.w);
    }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = gw + j * G;
    if (nt < ntr) {
      const float4 b = *reinterpret_cast<const float4*>(st + (nt * 32 + lane) * 16);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t bb[2], bs[2];
        split(bv[2 * s], bb[0], bs[0]);
        split(bv[2 * s + 1], bb[1], bs[1]);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], as[s][m], bb);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], ab[s][m], bs);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], ab[s][m], bb);
      }
    }
  }
}

// ---- the producer -----------------------------------------------------------
// One lane: every chunk of every layer of slot k's slice for column rank
// cr, in order, each into the next stage once the consumers released it.
__device__ __forceinline__ void produce(const Params& p, int k, int cr, int C, int KB, int NTW,
                                       uint64_t* full, uint64_t* empty, unsigned char* ring) {
  const int S = p.stages;
  int c = 0;
  for (int l = 0; l < p.depth; ++l) {
    const Plan q = plan_of(p.n_in, p.n_out, p.stage_bytes, l, cr, C, KB, NTW);
    const unsigned char* wl =
        static_cast<const unsigned char*>(p.w[l]) + static_cast<size_t>(k) * q.kb * q.nt * UNIT;
    for (int ch = 0; ch < q.chunks; ++ch, ++c) {
      const int s = c % S, kb0 = ch * q.cb, nkb = min(q.cb, q.kb - kb0);
      if (c >= S) mbar_wait(&empty[s], ((c / S) - 1) & 1);
      const unsigned bytes = static_cast<unsigned>(nkb * q.ntr * UNIT);
      mbar_expect_tx(&full[s], bytes);
      unsigned char* dst = ring + static_cast<size_t>(s) * p.stage_bytes;
      if (q.ntr == q.nt) {
        bulk_copy(dst, wl + static_cast<size_t>(kb0) * q.nt * UNIT, bytes, &full[s]);
      } else {
        for (int i = 0; i < nkb; ++i) {
          bulk_copy(dst + i * q.ntr * UNIT,
                    wl + (static_cast<size_t>(kb0 + i) * q.nt + q.t0) * UNIT, q.ntr * UNIT,
                    &full[s]);
        }
      }
    }
  }
}

// ---- the input rows ---------------------------------------------------------
template <bool BF16>
__device__ __forceinline__ void store_in(void* act, int ap, int r, int c, float x) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(act)[r * ap + c] = __float2bfloat16_rn(x);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(act) + r * ap + act_pos(c)) = split2(x);
  }
}

// Input buffer 0: the tile's rows (warp w its rows w R / 8 on, a lane every
// 32nd column), zero past the tile and in the padding columns, every load
// of a round of four column groups issued before any is used. The feature
// front's first feat_len columns are the row's conv features, one
// contiguous range a row read 16 bytes a lane where aligned, relu'd; the
// remaining columns obs columns, normalised by slot k (each lane's
// columns' mean and deviation loaded once).
template <int R, bool BF16, bool FEAT>
__device__ __forceinline__ void gather(const Params& p, int k, int seg, int Dp, const int* rows,
                                       void* act, int ap, int warp, int lane) {
  constexpr int RPW = R / CWARPS, GROUPS = 4;
  int rid[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int r = warp * RPW + q;
    rid[q] = r < seg ? rows[r] : -1;
  }
  const int D = p.n_in[0];
  const int hw = FEAT ? p.feat_len : 0;
  if constexpr (FEAT) {
    const bool vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(p.feat) % 16 == 0;
    const int unit = vec ? 4 : 1, n = hw / unit;
    for (int g0 = 0; g0 < n; g0 += 32 * GROUPS) {
      float4 v[RPW][GROUPS];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const float* src = p.feat + static_cast<size_t>(rid[q] < 0 ? 0 : rid[q]) * hw;
#pragma unroll
        for (int i = 0; i < GROUPS; ++i) {
          const int c = g0 + lane + 32 * i;
          v[q][i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (rid[q] >= 0 && c < n) {
            if (vec) {
              v[q][i] = __ldg(reinterpret_cast<const float4*>(src) + c);
            } else {
              v[q][i].x = __ldg(src + c);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
#pragma unroll
        for (int i = 0; i < GROUPS; ++i) {
          const int c = g0 + lane + 32 * i, r = warp * RPW + q;
          if (c < n) {
            store_in<BF16>(act, ap, r, unit * c, fmaxf(v[q][i].x, 0.0f));
            if (vec) {
              store_in<BF16>(act, ap, r, 4 * c + 1, fmaxf(v[q][i].y, 0.0f));
              store_in<BF16>(act, ap, r, 4 * c + 2, fmaxf(v[q][i].z, 0.0f));
              store_in<BF16>(act, ap, r, 4 * c + 3, fmaxf(v[q][i].w, 0.0f));
            }
          }
        }
      }
    }
  }
  const bool normed = p.norm_mean != nullptr && __ldg(p.norm_count + k) >= 2.0f;
  const float cnt = normed ? fmaxf(__ldg(p.norm_count + k), 1.0f) : 1.0f;
  const size_t norm_off = static_cast<size_t>(k) * p.obs_stride + p.obs_off;
  const float* mean_k = normed ? p.norm_mean + norm_off : nullptr;
  const float* m2_k = normed ? p.norm_m2 + norm_off : nullptr;
  for (int g0 = hw; g0 < Dp; g0 += 32 * GROUPS) {
    float v[RPW][GROUPS], mean[GROUPS], m2[GROUPS];
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const int c = g0 + lane + 32 * i;
      mean[i] = 0.0f, m2[i] = 0.0f;
      if (normed && c < D) {
        mean[i] = __ldg(mean_k + c - hw);
        m2[i] = __ldg(m2_k + c - hw);
      }
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        v[q][i] = rid[q] >= 0 && c < D
                      ? __ldg(p.x + static_cast<size_t>(rid[q]) * p.obs_stride + p.obs_off + c - hw)
                      : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const int c = g0 + lane + 32 * i;
      if (c >= Dp) continue;
      // the order of K6 and of the plain version
      const float sd = fmaxf(sqrtf(m2[i] / cnt), 1e-8f);
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        float x = v[q][i];
        if (normed && rid[q] >= 0 && c < D) {
          const float z = (x - mean[i]) / sd;
          x = z < -p.clip ? -p.clip : (z > p.clip ? p.clip : z);
        }
        store_in<BF16>(act, ap, warp * RPW + q, c, x);
      }
    }
  }
}

// ---- the body -----------------------------------------------------------------
// The bulk copy of ``bytes`` of this block's shared memory at ``src`` to the
// same address in cluster block ``rank``, completing on that block's
// barrier at the address of ``bar``.
__device__ __forceinline__ void push_to(const void* src, unsigned bytes, uint64_t* bar,
                                        unsigned rank) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_addr(src)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// R rows a tile, C blocks a cluster (each a column slice of every layer),
// BF16: the bf16 tower (else 3xTF32), FEAT: the feature front.
template <int R, int C, bool BF16, bool FEAT>
__device__ __forceinline__ void tower(const Params& p) {
  using T = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int MT = R / 16;
  constexpr int NTW = (MAX_WIDTH / 8 / CWARPS + C - 1) / C;
  constexpr int KB = BF16 ? 32 : 16;  // input rows of a packed k-block
  static_assert(C == 1 || BF16, "a cluster exchanges bf16 inputs only");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) int s_cnt[CWARPS][MAX_SLOTS];
  __shared__ int s_rows[MAX_ROWS];
  __shared__ __align__(8) uint64_t s_full[MAX_STAGES], s_empty[MAX_STAGES], s_ready[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cr = C > 1 ? static_cast<int>(blockIdx.x % C) : 0;  // the column slice
  const int tile = static_cast<int>(blockIdx.x / C);
  const int K = p.K, rows = p.rows, A = p.n_out[p.depth - 1];
  const int S = p.stages;

  if (tid == 0) {
    mark(p, 0);
    for (int s = 0; s < S; ++s) {
      mbar_init(&s_full[s], 1);
      mbar_init(&s_empty[s], CWARPS);
    }
    // A layer's next input in a cluster: this block's arrive (its own
    // slice stored, its expected bytes set) and the peers' bulk copies.
    mbar_init(&s_ready[0], 1);
    mbar_init(&s_ready[1], 1);
    fence_mbar_init();
  }
  if constexpr (C > 1) cluster_arrive_relaxed();

  // 1. The slots' counts (csrc/slot_tiles.cuh); rows of a slot outside
  // [0, K) are zeroed, each by one block.
  slot_tiles::Scan scan = {};
  if (warp < CWARPS) {
    scan = slot_tiles::count_slots(p.slot, rows, K, warp, lane, s_cnt, [&](int i) {
      for (int a = 0; a < A; ++a) p.out[static_cast<size_t>(i) * A + a] = 0.0f;
    });
  }
  __syncthreads();
  if (tid == 0) mark(p, 1);

  // 2. Every warp names the block's (slot, tile).
  int k, rank0, seg;
  if (!slot_tiles::name_tile(s_cnt, K, R, tile, lane, k, rank0, seg)) {
    return;  // past the last tile: the whole cluster
  }

  if (warp == CWARPS) {
    if (lane == 0) {
      mark(p, 23);
      produce(p, k, cr, C, KB, NTW, s_full, s_empty, smem + p.ring_off);
      // This lane's arrive on the cluster's last barrier (after its wait on
      // the first), so that the other blocks never wait on it.
      if constexpr (C > 1) {
        cluster_wait_one();
        cluster_arrive_one();
      }
      mark(p, 24);
    }
    return;
  }
  if (tid == 0) mark_tile(p, k, seg);

  // 3. The tile's row ids: ranks [rank0, rank0 + seg) of slot k, in row
  // order.
  slot_tiles::collect_rows(p.slot, scan, s_cnt, k, rank0, seg, warp, lane, s_rows);
  bar_consumers();
  if (tid == 0) mark(p, 3);

  // 4. The tile's input rows into buffer 0.
  gather<R, BF16, FEAT>(p, k, seg, (p.n_in[0] + KB - 1) / KB * KB, s_rows,
                        smem + p.act_off[0], p.act_pitch[0], warp, lane);
  bar_consumers();
  if (tid == 0) mark(p, 4);
  // Every block of the cluster runs, its barriers initialised, before the
  // first copy into it.
  if constexpr (C > 1) cluster_wait();
  if (tid == 0) mark(p, 5);

  // 5. The layers.
  const int grp = lane >> 2, tig = lane & 3;
  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;

  unsigned ready_phase = 0;  // bit b: the parity of buffer b's next wait
  int c = 0;
  for (int l = 0; l < p.depth; ++l) {
    const Plan q = plan_of(p.n_in, p.n_out, p.stage_bytes, l, cr, C, KB, NTW);
    const int ib = l & 1, ob = ib ^ 1;
    if constexpr (C > 1) {
      if (l > 0) {
        mbar_wait_cluster(&s_ready[ib], (ready_phase >> ib) & 1);
        ready_phase ^= 1u << ib;
      }
    }
    if (tid == 0) mark(p, 6 + 4 * l);
    const T* in = reinterpret_cast<const T*>(smem + p.act_off[ib]);
    const int ap = p.act_pitch[ib];
    const int kp = warp / q.G, gw = warp - kp * q.G;
    // The bias of the warp's output columns, loaded while the stages land.
    const int n_out = p.n_out[l];
    const float* bias = p.b[l] + static_cast<size_t>(k) * n_out;
    float b0[NTW], b1[NTW];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = (q.t0 + gw + j * q.G) * 8 + 2 * tig;
      const bool mine = gw + j * q.G < q.ntr;
      b0[j] = mine && col < n_out ? __ldg(bias + col) : 0.0f;
      b1[j] = mine && col + 1 < n_out ? __ldg(bias + col + 1) : 0.0f;
    }
    for (int ch = 0; ch < q.chunks; ++ch, ++c) {
      const int s = c % S, kb0 = ch * q.cb, nkb = min(q.cb, q.kb - kb0);
      mbar_wait(&s_full[s], (c / S) & 1);
      if (tid == 0 && ch == 0) mark(p, 7 + 4 * l);
      const unsigned char* st = smem + p.ring_off + static_cast<size_t>(s) * p.stage_bytes;
      for (int i = (kp - kb0 % q.P + q.P) % q.P; i < nkb; i += q.P) {
        if constexpr (BF16) {
          kblock_bf16<MT, NTW>(acc, in, ap, kb0 + i, st + i * q.ntr * UNIT, q.ntr, gw, q.G, lane);
        } else {
          kblock_tf32<MT, NTW>(acc, in, ap, kb0 + i, st + i * q.ntr * UNIT, q.ntr, gw, q.G, lane);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s_empty[s]);
    }
    if (tid == 0) mark(p, 8 + 4 * l);
    // Bias, activation, and this block's slice of the next input (or the
    // logits).
    const bool head = l == p.depth - 1;
    T* outb = reinterpret_cast<T*>(smem + p.act_off[ob]);
    const int op = p.act_pitch[ob];
    if (q.P == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int nt = gw + j * q.G;
          if (nt >= q.ntr) continue;
          const int col = (q.t0 + nt) * 8 + 2 * tig;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m * 16 + grp + 8 * h;
            const float v0 = acc[m][j][2 * h] + b0[j], v1 = acc[m][j][2 * h + 1] + b1[j];
            if (head) {
              if (r < seg) {
                float* o = p.out + static_cast<size_t>(s_rows[r]) * n_out;
                if (col < n_out) o[col] = v0;
                if (col + 1 < n_out) o[col + 1] = v1;
              }
            } else if constexpr (BF16) {
              *reinterpret_cast<__nv_bfloat162*>(outb + r * op + col) =
                  __floats2bfloat162_rn(activate(v0, p.act), activate(v1, p.act));
            } else {
              *reinterpret_cast<float2*>(outb + r * op + act_pos(col)) = split2(activate(v0, p.act));
              *reinterpret_cast<float2*>(outb + r * op + act_pos(col + 1)) =
                  split2(activate(v1, p.act));
            }
          }
        }
      }
    } else if (q.ntr > 0) {
      // The k-parts through shared memory: every part's accumulators
      // stored, then each thread sums an element's parts in order and
      // finishes it.
      float* scr = reinterpret_cast<float*>(smem + (head ? p.head_scratch_off : p.scratch_off));
      const int E = q.G * MT * q.nw * 128;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j < q.nw) {
              scr[kp * E + (((gw * MT + m) * q.nw + j) * 4 + e) * 32 + lane] = acc[m][j][e];
            }
          }
      bar_consumers();
      for (int idx = tid; idx < E; idx += CTHREADS) {
        float v = 0.0f;
        for (int pp = 0; pp < q.P; ++pp) v += scr[pp * E + idx];
        const int ln = idx & 31, e = (idx >> 5) & 3, rest = idx >> 7;
        const int j = rest % q.nw, m = rest / q.nw % MT, g = rest / (q.nw * MT);
        const int nt = g + j * q.G;
        const int r = m * 16 + (ln >> 2) + 8 * (e >> 1);
        const int col = (q.t0 + nt) * 8 + 2 * (ln & 3) + (e & 1);
        if (nt >= q.ntr || col >= n_out) continue;
        v += __ldg(bias + col);
        if (head) {
          if (r < seg) p.out[static_cast<size_t>(s_rows[r]) * n_out + col] = v;
        } else if constexpr (BF16) {
          outb[r * op + col] = __float2bfloat16_rn(activate(v, p.act));
        } else {
          *reinterpret_cast<float2*>(outb + r * op + act_pos(col)) = split2(activate(v, p.act));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
    if (tid == 0) mark(p, 9 + 4 * l);
    if (head) break;
    if constexpr (C > 1) {
      // The slice into every other block of the cluster: its rows' bytes
      // by bulk copies from warp 0's lanes, each completing on that
      // block's barrier of the buffer, which this block's arrive (with the
      // bytes it expects from the others) completes.
      fence_proxy_async();
      bar_consumers();
      if (warp == 0) {
        const unsigned bytes = static_cast<unsigned>(q.ntr * 16);
        for (int o = 1; o < C; ++o) {
          const unsigned to = static_cast<unsigned>((cr + o) % C);
          for (int r = lane; r < seg && bytes > 0; r += 32) {
            push_to(outb + r * op + q.t0 * 8, bytes, &s_ready[ob], to);
          }
        }
        if (lane == 0) {
          unsigned expect = 0;
          for (int o = 1; o < C; ++o) {
            const Plan peer = plan_of(p.n_in, p.n_out, p.stage_bytes, l, (cr + o) % C, C, KB,
                                      NTW);
            expect += static_cast<unsigned>(seg * peer.ntr * 16);
          }
          mbar_expect_tx(&s_ready[ob], expect);
        }
      }
    } else {
      bar_consumers();
    }
  }
  if (tid == 0) mark(p, 22);
  // No block leaves while a copy out of its shared memory may be pending.
  if constexpr (C > 1) cluster_sync_all();
}

// ---- the host side ------------------------------------------------------------
inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Fills p's shared-memory layout for R rows, C blocks a cluster: the two
// input buffers (buffer 0 the input and the odd layers' outputs, buffer 1
// the even layers'), the k-parts' scratch, and the ring (stages of up to
// STAGE_CAP bytes, at least one k-block of the widest slice; as many as
// the rest of SMEM_CAP holds, at most MAX_STAGES). Returns the dynamic
// shared memory in bytes, or -1 where not two stages fit.
inline int layout(Params& p, const int* widths, int depth, int R, int C, bool bf16) {
  const int KB = bf16 ? 32 : 16;
  int wb[2] = {round_up(widths[0], KB), 8};
  for (int l = 0; l + 1 < depth; ++l) {
    const int b = (l + 1) & 1;
    wb[b] = widths[l + 1] > wb[b] ? widths[l + 1] : wb[b];
  }
  int off = 0;
  for (int b = 0; b < 2; ++b) {
    int bytes;
    if (bf16) {
      // 8 (mod 64) bf16 a row: ldmatrix's 8 rows of 16 bytes fall in 8
      // different bank groups.
      p.act_pitch[b] = round_up(wb[b], 64) + 8;
      bytes = R * p.act_pitch[b] * 2;
    } else {
      // 16 (mod 32) floats a row: a fragment's 16-byte loads of rows g
      // and g + 1 fall in the two halves of the banks.
      p.act_pitch[b] = 2 * round_up(wb[b], 32) + 16;
      bytes = R * p.act_pitch[b] * 4;
    }
    p.act_off[b] = off;
    off += round_up(bytes, 128);
  }
  // The k-parts' scratch: every part of a split layer's slice in any block
  // of the cluster (plan_of's split); the head's in the buffer it does not
  // read where that holds it.
  const int NTW = (MAX_WIDTH / 8 / CWARPS + C - 1) / C;
  int scratch = 0, head_need = 0, unit = 0, layer = 0;
  for (int l = 0; l < depth; ++l) {
    for (int rank = 0; rank < C; ++rank) {
      const Plan q = plan_of(widths, widths + 1, STAGE_CAP, l, rank, C, KB, NTW);
      const int need = q.P > 1 && q.ntr > 0 ? q.P * q.G * (R / 16) * q.nw * UNIT : 0;
      if (l == depth - 1) {
        head_need = need > head_need ? need : head_need;
      } else {
        scratch = need > scratch ? need : scratch;
      }
      unit = q.ntr * UNIT > unit ? q.ntr * UNIT : unit;
      layer = q.ntr * UNIT * q.kb > layer ? q.ntr * UNIT * q.kb : layer;
    }
  }
  const int head_out = depth & 1;  // the buffer the head does not read
  const int head_room = (head_out == 0 ? p.act_off[1] : off) - p.act_off[head_out];
  p.scratch_off = off;
  p.head_scratch_off = head_need <= head_room ? p.act_off[head_out] : off;
  if (head_need > head_room) scratch = head_need > scratch ? head_need : scratch;
  off += scratch;
  int stage = layer < STAGE_CAP ? layer : STAGE_CAP;
  stage = stage > unit ? stage : unit;
  p.ring_off = round_up(off, 128);
  int S = (SMEM_CAP - p.ring_off) / stage;
  S = S > MAX_STAGES ? MAX_STAGES : S;
  if (S < 2) return -1;
  p.stage_bytes = stage;
  p.stages = S;
  return p.ring_off + S * stage;
}

// Checks a tower and fills p's tower fields (the caller sets the rest).
inline int fill_tower(Params& p, const void* const* w, const void* const* b, const int* widths,
                      int depth, int act, int K) {
  if (depth < 1 || depth > MAX_LAYERS || K < 1 || K > MAX_SLOTS || p.rows < 0 || act < 0 ||
      act > 2) {
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
  for (int l = 0; l < depth; ++l) {
    if (w[l] == nullptr || reinterpret_cast<uintptr_t>(w[l]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.w[l] = w[l];
    p.b[l] = static_cast<const float*>(b[l]);
    p.n_in[l] = widths[l];
    p.n_out[l] = widths[l + 1];
  }
  p.depth = depth;
  p.act = act;
  p.K = K;
  return 0;
}

inline Params front(const void* x, const void* slot, const void* norm_mean, const void* norm_m2,
                    const void* norm_count, float clip, void* out, int rows) {
  Params p = {};
  p.x = static_cast<const float*>(x);
  p.slot = static_cast<const int*>(slot);
  p.norm_mean = static_cast<const float*>(norm_mean);
  p.norm_m2 = static_cast<const float*>(norm_m2);
  p.norm_count = static_cast<const float*>(norm_count);
  p.clip = clip;
  p.out = static_cast<float*>(out);
  p.rows = rows;
#ifdef OPP_TOWER_TRACE
  p.trace = trace_buffer();
#endif
  return p;
}

using KernelFn = void (*)(Params);

// One launch of ``kernel`` at R rows a tile and C blocks a cluster: the
// grid one cluster per possible tile (some exit at once).
template <int R, int C>
int launch(KernelFn kernel, const Params& p, int smem, cudaStream_t stream, int* smem_set) {
  if (smem > *smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.rows + R - 1) / R + p.K) * C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  if (C > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace opp_tower
