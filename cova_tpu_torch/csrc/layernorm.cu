// K11: LayerNorm over the 96 channels of a Swin-T token map, with the
// residual add before it folded in, for Hopper (sm_90a).
//
// Replaces no TPU kernel: neither package had a LayerNorm trunk. In the Swin
// trunk (models/swin.py) every residual add `x + branch` is followed at once
// by a LayerNorm (block 1's attention add by its norm2, its MLP add by block
// 2's norm1, block 2's by its norm2 and by norm0), and PyTorch ran each add
// as a pass of its own and each LayerNorm as vectorized_layer_norm_kernel,
// one block a 192-byte row: about 10% of the bytes bound. Per token of x
// [T, 96] bf16 (ops/layernorm.py layernorm_plain is the same function):
//
//   s  = res ? bf16(float(x) + float(res)) : x   (`x + res` as PyTorch
//                                                 rounds it: bit for bit)
//   mu = sum(s) / 96,  var = sum((s - mu)^2) / 96          (f32)
//   y  = bf16((s - mu) * rsqrt(var + eps) * g + b)
//
// with g and b the module's f32 weight and bias rounded to bf16 at load, as
// its `.to(x.dtype)` rounds them. y is written, and s too where the
// residual stream carries on (`sum`). y differs from F.layer_norm's (Welford
// in f32) only by the order of the f32 sums: at most one bf16 step.
//
// What bounds it on the H100: HBM bytes. With U the bytes of one map, a
// plain LayerNorm reads and writes 2 U, one with a residual 3 U, and with
// the sum written 4 U; at ~10 f32 operations an element the arithmetic is
// far below the card's rate. At B = 10 and 1280^2 (T = 1,024,000 tokens,
// U = 196.6 MB, four times the L2) the trunk's six a batch move 19 U = 3.735
// GB: 1.115 ms at 3.35 TB/s.
//
// Design: four lanes a token, 24 channels each, eight tokens a warp. Lane q
// holds the token's 16-byte vectors q, q + 4 and q + 8, so each of a warp's
// three load (and store) instructions covers eight whole runs of 64 bytes of
// the warp's contiguous 1,536 bytes. A token's two sums are two
// __shfl_xor_sync steps within its four lanes; the statistics stay in
// registers (mean first, then the centred squares, from the same registers).
// g and b are read once, rounded to bf16 and held in registers for the whole
// walk. The warps walk the map with the grid's stride, and each issues the
// next group's loads before the current group's arithmetic, so every warp
// keeps a group in flight: with two blocks of 256 threads an SM (at most 128
// registers a thread), 16 warps with 1.5 KB each without a residual and 3 KB
// with one, 25 and 49 KB an SM, about what Little's law asks at ~1 us of
// latency and 25 GB/s an SM. At three blocks an SM (85 registers) ptxas
// spilled the plain variant (its g and b, unpacked, are 48 registers) and,
// with g and b forced to stay packed, the residual ones, and none ran faster;
// at two, all three reach 83-84% of the bound at the trunk's serving map,
// with no spills. A token past the end computes on zeros, so its lanes take
// part in the shuffles, and stores nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kC = 96;                  // channels a token
constexpr int kLanes = 4;               // lanes a token
constexpr int kVecs = kC / 8 / kLanes;  // 16-byte vectors a lane: 3
constexpr int kWords = 4 * kVecs;       // bf16 pairs a lane: 12
constexpr int kTokWarp = 32 / kLanes;   // tokens a warp: 8
constexpr int kThreads = 256, kMinBlocks = 2;
constexpr int kTokBlock = kThreads / 32 * kTokWarp;  // 64
constexpr int kMaxTokens = 1 << 30;     // int token indices stay in range
constexpr unsigned kFull = 0xffffffffu;

// A lane's 24 channels of one token as 12 bf16 pairs, low half first.
struct Part {
  uint32_t w[kWords];
};

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// Vector k of lane q of token t is 16-byte vector t * 12 + 4 k + q of the
// map. `ok` false: zeros, nothing read.
__device__ __forceinline__ void load(Part& p, const __nv_bfloat16* map, int t,
                                     int q, bool ok) {
  const uint4* v =
      reinterpret_cast<const uint4*>(map) + static_cast<long long>(t) *
      (kC / 8) + q;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint4 u = ok ? __ldcs(v + kLanes * k) : make_uint4(0u, 0u, 0u, 0u);
    p.w[4 * k] = u.x, p.w[4 * k + 1] = u.y;
    p.w[4 * k + 2] = u.z, p.w[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* map, int t, int q,
                                      const Part& p) {
  uint4* v = reinterpret_cast<uint4*>(map) + static_cast<long long>(t) *
             (kC / 8) + q;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    v[kLanes * k] = make_uint4(p.w[4 * k], p.w[4 * k + 1], p.w[4 * k + 2],
                               p.w[4 * k + 3]);
}

// The sum over a token's four lanes, the same bits in each.
__device__ __forceinline__ float token_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// kRes: x + res is normed; kSum: the sum is written to `sum` (kRes only).
template <bool kRes, bool kSum>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
swin_layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ res,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      __nv_bfloat16* __restrict__ y,
                      __nv_bfloat16* __restrict__ sum, int n, float eps) {
  const int lane = threadIdx.x & 31, q = lane & (kLanes - 1);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int step = gridDim.x * kTokBlock;
  // Word i of a lane is channels c, c + 1 with c = 8 (4 (i / 4) + q) +
  // 2 (i % 4).
  Part g, b;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int c = 8 * (kLanes * (i / 4) + q) + 2 * (i % 4);
    g.w[i] = pack(__ldg(gamma + c), __ldg(gamma + c + 1));
    b.w[i] = pack(__ldg(beta + c), __ldg(beta + c + 1));
  }
  int t = warp * kTokWarp + lane / kLanes;
  Part xs, rs;
  load(xs, x, t, q, t < n);
  if constexpr (kRes) load(rs, res, t, q, t < n);
  // t0, the warp's first token, is the same in all its lanes: the loop and
  // the shuffles in it never diverge.
  for (int t0 = warp * kTokWarp; t0 < n; t0 += step, t += step) {
    const int tn = t + step;
    Part xn, rn;
    load(xn, x, tn, q, tn < n);
    if constexpr (kRes) {
      load(rn, res, tn, q, tn < n);
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        xs.w[i] = pack(__fadd_rn(lo(xs.w[i]), lo(rs.w[i])),
                       __fadd_rn(hi(xs.w[i]), hi(rs.w[i])));
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWords; ++i) s += lo(xs.w[i]) + hi(xs.w[i]);
    const float mean = token_sum(s) / kC;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const float d0 = lo(xs.w[i]) - mean, d1 = hi(xs.w[i]) - mean;
      m2 = fmaf(d0, d0, m2);
      m2 = fmaf(d1, d1, m2);
    }
    const float rstd = rsqrtf(token_sum(m2) / kC + eps);
    if (t < n) {
      Part out;
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        out.w[i] = pack(
            fmaf((lo(xs.w[i]) - mean) * rstd, lo(g.w[i]), lo(b.w[i])),
            fmaf((hi(xs.w[i]) - mean) * rstd, hi(g.w[i]), hi(b.w[i])));
      store(y, t, q, out);
      if constexpr (kSum) store(sum, t, q, xs);
    }
    xs = xn;
    if constexpr (kRes) rs = rn;
  }
}

template <bool kRes, bool kSum>
int launch(const void* x, const void* res, const void* gamma,
           const void* beta, void* y, void* sum, int n, float eps,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int want = (n + kTokBlock - 1) / kTokBlock;
  const int most = kMinBlocks * sms;
  swin_layernorm_kernel<kRes, kSum>
      <<<want < most ? want : most, kThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(res),
          static_cast<const float*>(gamma), static_cast<const float*>(beta),
          static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(sum),
          n, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res (or null), y, sum (or null; only with res): [n, 96] bf16,
// contiguous, 16-byte aligned; gamma, beta: f32 [96]; 0 < n <= 2^30.
// Returns the cudaError_t of the launch.
extern "C" int swin_layernorm_bf16(const void* x, const void* res,
                                   const void* gamma, const void* beta,
                                   void* y, void* sum, long long n, float eps,
                                   void* stream) {
  if (n <= 0 || n > kMaxTokens || !x || !gamma || !beta || !y ||
      (sum && !res))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(n);
  if (!res) return launch<false, false>(x, res, gamma, beta, y, sum, t, eps, s);
  if (sum) return launch<true, true>(x, res, gamma, beta, y, sum, t, eps, s);
  return launch<true, false>(x, res, gamma, beta, y, sum, t, eps, s);
}
