// K9: eval-mode BatchNorm affine + optional residual (itself optionally
// BatchNorm'd) + optional ReLU in one pass over an NHWC map, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses these elementwise ops
// into the convs' neighbours. In the port, PyTorch runs each op as its own
// pass through an f32 copy of the map (models/layers.py MaskedBatchNorm's
// `(x.float() * scale + shift).to(x.dtype)`, then F.relu and the residual
// add in models/resnet.py): about seven passes where one would do. Per
// element of channel c of x [..., C]:
//
//   y = cast(fadd(fmul(float(x), scale[c]), shift[c]))
//   if res:  r = res                                         (identity)
//            r = cast(fadd(fmul(float(res), rscale[c]), rshift[c]))  (BN)
//            y = cast(fadd(float(y), float(r)))
//   if relu: y = isnan(y) ? y : max(y, 0)
//
// Each cast rounds to nearest even into x's dtype where the plain version
// rounds (ops/bn_act.py bn_act_plain), and the multiply and the add stay
// two rounded steps (__fmul_rn, __fadd_rn: nvcc would otherwise contract
// them into one FMA), so the output equals the plain version bit for bit,
// NaNs and signed zeros included. The ReLU is PyTorch's clamp_min(x, 0):
// NaN passes, else fmaxf.
//
// What bounds it on the H100: HBM bytes. Each input element is read once
// and each output written once, at about 3 f32 operations per element
// (6 with a BN'd residual): far below the card's rate. At ResNet-50's
// layer1 with B = 10 at 1280^2 (x and res [10, 320, 320, 256] bf16) the
// pass moves 1.57 GB, 0.47 ms at 3.35 TB/s.
//
// Design: a grid of a few blocks per SM, each thread owning one vector of
// VEC channels (8: one 16-byte access in bf16, two in f32) and walking the
// map with a stride of the number of walking threads, which is a multiple
// of C / VEC, so the thread's channel vector never changes and its scale
// and shift (and the residual's) stay in registers for the whole walk.
// Neighbouring threads read neighbouring vectors. A thread issues UNROLL
// vector loads of x (and of res) before it computes any, so several
// independent loads are in flight, with the streaming cache hint (each
// byte is read once). VEC = 1 is the scalar walk the wrapper picks where C
// is not a multiple of 8 or a pointer is not 16-byte aligned.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

// Threads a block; blocks an SM must hold (caps the registers at 128).
constexpr int kThreads = 256, kMinBlocks = 2;

// VEC elements of T, held as raw registers between their load and use.
template <typename T, int VEC> struct Raw;

template <> struct Raw<__nv_bfloat16, 8> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  }
  __device__ __forceinline__ float get(int k) const {
    const uint32_t v = w[k >> 1];
    return __uint_as_float((k & 1) ? (v & 0xffff0000u) : (v << 16));
  }
};

template <> struct Raw<__nv_bfloat16, 1> {
  unsigned short w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ float get(int) const {
    return __uint_as_float(static_cast<uint32_t>(w) << 16);
  }
};

template <> struct Raw<float, 8> {
  float f[8];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  __device__ __forceinline__ float get(int k) const { return f[k]; }
};

template <> struct Raw<float, 1> {
  float f;
  __device__ __forceinline__ void load(const float* p) { f = __ldcs(p); }
  __device__ __forceinline__ float get(int) const { return f; }
};

// v rounded to T and back (exact for f32).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&y)[VEC]) {
  if constexpr (sizeof(T) == 2 && VEC == 8) {
    uint4 u;
    u.x = bf16_bits(y[0]) | (static_cast<uint32_t>(bf16_bits(y[1])) << 16);
    u.y = bf16_bits(y[2]) | (static_cast<uint32_t>(bf16_bits(y[3])) << 16);
    u.z = bf16_bits(y[4]) | (static_cast<uint32_t>(bf16_bits(y[5])) << 16);
    u.w = bf16_bits(y[6]) | (static_cast<uint32_t>(bf16_bits(y[7])) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<unsigned short*>(p) = bf16_bits(y[0]);
  } else if constexpr (VEC == 8) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(y[0], y[1], y[2], y[3]);
    q[1] = make_float4(y[4], y[5], y[6], y[7]);
  } else {
    *p = y[0];
  }
}

// Vector loads in flight per thread: 64 bytes of x (and of res) either way.
template <typename T, int VEC> struct Unroll {
  static constexpr int value = VEC == 1 ? 4 : (sizeof(T) == 2 ? 4 : 2);
};

// res_mode: 0 none, 1 identity, 2 BatchNorm'd; relu: 0 or 1. Both are the
// same for every thread, so their branches do not diverge, and they are
// arguments rather than template parameters, so the source builds 4
// instantiations, not 24 (the build counts against the first run's set-up).
// n_vec: vectors of VEC elements in x; groups: C / VEC, the vectors of one
// pixel.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bn_act_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, const T* __restrict__ res,
              const float* __restrict__ rscale,
              const float* __restrict__ rshift, T* __restrict__ out,
              long long n_vec, int groups, int res_mode, int relu) {
  constexpr int U = Unroll<T, VEC>::value;
  const int walkers = gridDim.x * kThreads / groups * groups;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= walkers) return;
  const int c0 = (t % groups) * VEC;
  float s[VEC], h[VEC], rs[VEC], rh[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s[k] = __ldg(scale + c0 + k);
    h[k] = __ldg(shift + c0 + k);
    rs[k] = res_mode == 2 ? __ldg(rscale + c0 + k) : 0.f;
    rh[k] = res_mode == 2 ? __ldg(rshift + c0 + k) : 0.f;
  }
  const long long step = static_cast<long long>(walkers);
  for (long long i = t; i < n_vec; i += step * U) {
    Raw<T, VEC> xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = i + u * step;
      if (j < n_vec) {
        xv[u].load(x + j * VEC);
        if (res_mode != 0) rv[u].load(res + j * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = i + u * step;
      if (j >= n_vec) break;
      float y[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float v = round_to<T>(__fadd_rn(__fmul_rn(xv[u].get(k), s[k]), h[k]));
        if (res_mode != 0) {
          float r = rv[u].get(k);
          if (res_mode == 2)
            r = round_to<T>(__fadd_rn(__fmul_rn(r, rs[k]), rh[k]));
          v = round_to<T>(__fadd_rn(v, r));
        }
        if (relu) v = isnan(v) ? v : fmaxf(v, 0.f);
        y[k] = v;
      }
      store<T, VEC>(out + j * VEC, y);
    }
  }
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* shift,
             const void* res, const void* rscale, const void* rshift,
             void* out, long long n, int c, int vec, int res_mode, int relu,
             int blocks, void* stream) {
  if (c <= 0 || n % c != 0 || c % vec != 0 || blocks <= 0 ||
      static_cast<long long>(blocks) * kThreads < c / vec ||
      res_mode < 0 || res_mode > 2 || (relu != 0 && relu != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const float* f[4] = {static_cast<const float*>(scale),
                       static_cast<const float*>(shift),
                       static_cast<const float*>(rscale),
                       static_cast<const float*>(rshift)};
  T* o = static_cast<T*>(out);
  if (vec == 8)
    bn_act_kernel<T, 8><<<blocks, kThreads, 0, s>>>(
        xt, f[0], f[1], rt, f[2], f[3], o, n / 8, c / 8, res_mode, relu);
  else if (vec == 1)
    bn_act_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
        xt, f[0], f[1], rt, f[2], f[3], o, n, c, res_mode, relu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res (res_mode 1 or 2), out: [n / c, c] contiguous, of one dtype;
// scale, shift (and rscale, rshift with res_mode 2): f32 [c]. vec: 8 where
// c % 8 == 0 and every map pointer is 16-byte aligned, else 1. blocks: the
// grid (ops/bn_act.py launch_plan), with blocks * 256 >= c / vec. relu: 0
// or 1. Returns the cudaError_t of the launch.
extern "C" int bn_act_bf16(const void* x, const void* scale,
                           const void* shift, const void* res,
                           const void* rscale, const void* rshift, void* out,
                           long long n, int c, int vec, int res_mode,
                           int relu, int blocks, void* stream) {
  return dispatch<__nv_bfloat16>(x, scale, shift, res, rscale, rshift, out, n,
                                 c, vec, res_mode, relu, blocks, stream);
}

extern "C" int bn_act_f32(const void* x, const void* scale, const void* shift,
                          const void* res, const void* rscale,
                          const void* rshift, void* out, long long n, int c,
                          int vec, int res_mode, int relu, int blocks,
                          void* stream) {
  return dispatch<float>(x, scale, shift, res, rscale, rshift, out, n, c, vec,
                         res_mode, relu, blocks, stream);
}
