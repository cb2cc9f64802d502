// K9 clip_adam — optax chain(clip_by_global_norm, scale_by_adam) and the
// step p -= lr * u, over every parameter of the network at once.
//
// Replaces the XLA fusion of burn_ppo_tpu/ppo/update.py make_optimizer
// (82-89) and the step at 358-361 (ROADMAP queue B, item B7). Plain
// PyTorch twin: burn_ppo_torch/ppo/update.py clip_adam_plain.
//
// What bounds it on an H100: bytes. The parameters, gradients and both
// moments live in four flat f32 buffers (the network's parameters are
// views of one buffer); the step reads four and writes three: at the
// 873,778 parameters of the Liar's Dice CTDE network, ~24.5 MB, ~7.3 us
// of HBM time. The four buffers (14 MB) fit in the 50 MB L2, so the
// gradients read twice cost L2 bandwidth, not HBM's.
//
// One cooperative launch of a grid that is resident all at once (SMs x
// the blocks an SM holds, computed once per device, fewer where the
// buffers need fewer), in two phases:
//   1. the sum of g^2 in double: per thread over a grid stride of float4
//      loads, per block by warp shuffles then the block's warps in order;
//      each block writes its partial;
//   then a grid barrier (cooperative_groups::this_grid().sync());
//   2. each block's first warp reads all G partials lane by lane and adds
//      them by a fixed butterfly of shuffles: every block, and every run,
//      gets the same norm bits. Then per element, with float4 loads and
//      stores of p, g, mu and nu, as optax writes it:
//        g' = norm < max_norm ? g : (g / norm) * max_norm
//        mu = (1 - b1) * g' + b1 * mu,  nu = (1 - b2) * g'^2 + b2 * nu
//        u  = (mu / bc1) / (sqrt(nu / bc2) + eps),  p = p - lr * u
//      each operation rounded on its own (__fmul_rn, __fadd_rn, ...): no
//      product is contracted into an FMA, so the step's bits are the plain
//      version's wherever the norm is under the clip, and do not move with
//      the code around it (left to nvcc, which products it contracted
//      changed with the surrounding code).
//      Not torch's clip_grad_norm_, which scales by max / (norm + 1e-6).
// Everything that changes from step to step is read on the device, so one
// captured launch serves every step of a CUDA graph of the update:
//   * lr, an f32 scalar;
//   * the Adam count, an i32 scalar: the step uses count + 1 and block 0
//     writes it back after the grid barrier (every block has read it);
//   * the bias corrections bc = 1 - b^count, looked up in the caller's
//     f32 table [2, bias_len] at min(count, bias_len - 1) (the host forms
//     the table as it formed the values before, so they are the same
//     bits; past the last entry both round to 1.0f);
//   * run, an i32 flag that K8's finalize writes:
//     where it is 0 every block returns before the grid barrier, all
//     alike (after the norm's pass, whose partials are scratch), and
//     parameters, moments and count stay as they were.
// The launch allocates nothing and sets no function attribute, so it can
// be captured into a CUDA graph; the partials' scratch is the caller's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct AdamArgs {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  double* partial;
  long n;
  const float* lr;
  int* count;
  const int* run;
  const float* bias;
  int bias_len;
  float max_norm, eps, b1, b2, one_minus_b1, one_minus_b2;
};

// The step's scalars, read on the device before the grid barrier.
struct Step {
  float lr, bc1, bc2;
};

// Every lane ends with the same bits: a + b == b + a at each level.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void adam_one(const AdamArgs& a, const Step& st, float gi, float& p,
                                         float& mu, float& nu, bool keep, float gn) {
  const float gc = keep ? gi : __fmul_rn(__fdiv_rn(gi, gn), a.max_norm);
  const float m = __fadd_rn(__fmul_rn(a.one_minus_b1, gc), __fmul_rn(a.b1, mu));
  const float v = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(gc, gc)), __fmul_rn(a.b2, nu));
  mu = m;
  nu = v;
  const float u =
      __fdiv_rn(__fdiv_rn(m, st.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, st.bc2)), a.eps));
  p = __fsub_rn(p, __fmul_rn(st.lr, u));
}

// All four buffers 16-byte aligned (the wrapper checks); n % 4 tail
// elements go to the last threads of block 0.
__global__ void __launch_bounds__(THREADS) clip_adam_kernel(AdamArgs a) {
  __shared__ double warp_part[WARPS];
  __shared__ float norm_s;
  const long nvec = a.n / 4;
  const long tail_at = 4 * nvec;
  const long stride = static_cast<long>(gridDim.x) * THREADS;
  const long first = blockIdx.x * static_cast<long>(THREADS) + threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool tail_thread = blockIdx.x == 0 && threadIdx.x >= THREADS - 4 &&
                           tail_at + (threadIdx.x - (THREADS - 4)) < a.n;
  const long tail_i = tail_at + (threadIdx.x - (THREADS - 4));
  // The step's scalars are loaded first and used after the norm's pass,
  // so their latency hides behind it. A volatile load stays before the
  // barrier, after which block 0 writes the count back.
  const int go = __ldcg(a.run);
  const int count = *reinterpret_cast<const volatile int*>(a.count) + 1;
  const float lr = __ldcg(a.lr);

  double acc = 0.0;
  for (long v = first; v < nvec; v += stride) {
    const float4 g4 = reinterpret_cast<const float4*>(a.g)[v];
    acc += static_cast<double>(g4.x) * g4.x;
    acc += static_cast<double>(g4.y) * g4.y;
    acc += static_cast<double>(g4.z) * g4.z;
    acc += static_cast<double>(g4.w) * g4.w;
  }
  if (tail_thread) {
    const double x = a.g[tail_i];
    acc += x * x;
  }
  const int ci = count < a.bias_len ? count : a.bias_len - 1;
  const Step st{lr, __ldcg(a.bias + ci), __ldcg(a.bias + a.bias_len + ci)};
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    double b = warp_sum(lane < WARPS ? warp_part[lane] : 0.0);
    if (lane == 0) a.partial[blockIdx.x] = b;
  }
  // Every block read the same flag: all return here, before the barrier,
  // or none does. The partials written are scratch.
  if (!go) return;

  cg::this_grid().sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count = count;

  if (warp == 0) {
    double ss = 0.0;
    for (int b = lane; b < static_cast<int>(gridDim.x); b += 32) ss += __ldcg(a.partial + b);
    ss = warp_sum(ss);
    if (lane == 0) norm_s = static_cast<float>(sqrt(ss));
  }
  __syncthreads();
  const float gn = norm_s;
  const bool keep = gn < a.max_norm;
  for (long v = first; v < nvec; v += stride) {
    float4 p4 = reinterpret_cast<const float4*>(a.p)[v];
    float4 m4 = reinterpret_cast<const float4*>(a.mu)[v];
    float4 n4 = reinterpret_cast<const float4*>(a.nu)[v];
    const float4 g4 = reinterpret_cast<const float4*>(a.g)[v];
    adam_one(a, st, g4.x, p4.x, m4.x, n4.x, keep, gn);
    adam_one(a, st, g4.y, p4.y, m4.y, n4.y, keep, gn);
    adam_one(a, st, g4.z, p4.z, m4.z, n4.z, keep, gn);
    adam_one(a, st, g4.w, p4.w, m4.w, n4.w, keep, gn);
    reinterpret_cast<float4*>(a.p)[v] = p4;
    reinterpret_cast<float4*>(a.mu)[v] = m4;
    reinterpret_cast<float4*>(a.nu)[v] = n4;
  }
  if (tail_thread) adam_one(a, st, a.g[tail_i], a.p[tail_i], a.mu[tail_i], a.nu[tail_i], keep, gn);
}

// The blocks the whole grid may hold at once on the current device.
int resident_blocks() {
  static int resident[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, clip_adam_kernel, THREADS, 0) !=
            cudaSuccess)
      return 0;
    resident[dev] = sms * per_sm;
  }
  return resident[dev];
}

}  // namespace

// Doubles of partial scratch a launch on the current device may use.
extern "C" int clip_adam_scratch_len() { return resident_blocks(); }

// partial: [scratch_len] doubles of the caller's. All buffers flat, n
// elements, 16-byte aligned. lr: f32 scalar; count: i32 scalar; run: i32
// scalar; bias: f32 [2, bias_len].
extern "C" int clip_adam(void* params, const void* grads, void* mu, void* nu, void* partial,
                         long n, int scratch_len, const void* lr, void* count, const void* run,
                         const void* bias, int bias_len, float max_norm, float eps, float b1,
                         float b2, float one_minus_b1, float one_minus_b2, void* stream) {
  const int resident = resident_blocks();
  if (n <= 0 || resident < 1 || scratch_len < resident || bias_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto addr = [](const void* b) { return reinterpret_cast<std::uintptr_t>(b); };
  if ((addr(params) | addr(grads) | addr(mu) | addr(nu)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  long blocks = (n / 4 + THREADS - 1) / THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  AdamArgs a{static_cast<float*>(params), static_cast<const float*>(grads),
             static_cast<float*>(mu),         static_cast<float*>(nu),
             static_cast<double*>(partial),   n,
             static_cast<const float*>(lr),   static_cast<int*>(count),
             static_cast<const int*>(run),    static_cast<const float*>(bias),
             bias_len, max_norm, eps, b1, b2, one_minus_b1, one_minus_b2};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, clip_adam_kernel, a));
}
