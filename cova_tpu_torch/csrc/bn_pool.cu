// Fused BatchNorm-normalize + ReLU + 3x3/2 max-pool, forward and backward,
// for Hopper (sm_90a), on the stem conv's space-to-depth(2) output. The
// backward's note is further down, above its kernel.
//
// Replaces the TPU kernel cova_tpu/ops/bn_pool.py::_fwd_kernel:
//
//   out[b, i, j, f] = relu( max over the nine pool taps of
//                           ys[b, i + du, j + dv, (ey*2 + ex)*O + f]
//                           * scale[f] + shift[f] )
//
// with (du, ey) and (dv, ex) each in {(-1, 1), (0, 0), (0, 1)}: output row
// i of the stride-4 map pools rows 2i-1, 2i, 2i+1 of the stride-2 map,
// which live in s2d row block i-1 (phase 1) and block i (phases 0 and 1);
// the same holds for columns (cova_tpu/ops/conv_stem.py::stem_pool_s2d).
// A tap above row 0 or left of column 0 is the pool's padding: -inf before
// the ReLU. ReLU and the bf16 rounding are monotone, so the max of the
// affine values followed by one ReLU and one rounding equals the plain
// version's ReLU, rounding, then max: the result is bit-exact.
//
// The affine is computed as __fmul_rn then __fadd_rn, never as a fused
// multiply-add, because the plain PyTorch version runs the multiply and the
// add as two rounded steps; nvcc would otherwise contract them.
//
// What bounds it on the H100: HBM bytes. It reads ys once (B x 320 x 320 x
// 256 bf16, 524 MB at B = 10) and writes a quarter of that; about 28 f32
// operations per output are far below the card's rate.
//
// Design: one thread per output (b, i, j, pair of channels f, f+1), with
// the channel pair fastest, so a warp reads 128 contiguous bytes of one
// phase group for each tap and writes 128 contiguous bytes. Each input is
// read by up to four outputs' taps (the rows and columns shared between
// neighbouring windows); those repeats hit L1/L2, so HBM sees each byte of
// ys about once. The TPU kernel's roll-based three-stage factorization and
// row tiles with a halo fit the TPU's vector layout and are not carried
// over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

template <typename T> struct Pair;

template <> struct Pair<float> {
  __device__ static void load(const float* p, float& a, float& b) {
    float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Pair<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float& a, float& b) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(v);
    b = __high2float(v);
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// ys: [B, U, V, 4*O]; scale, shift: f32 [O]; out: [B, U, V, O].
template <typename T>
__global__ void bn_relu_pool_fwd_kernel(const T* __restrict__ ys,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        T* __restrict__ out, long long total,
                                        int U, int V, int O) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int half = O / 2;
  const int f = 2 * (int)(t % half);
  long long rest = t / half;
  const int j = (int)(rest % V);
  rest /= V;
  const int i = (int)(rest % U);
  const long long b = rest / U;

  const float s0 = __ldg(scale + f), s1 = __ldg(scale + f + 1);
  const float h0 = __ldg(shift + f), h1 = __ldg(shift + f + 1);
  const int c4 = 4 * O;
  const T* img = ys + b * U * V * c4;

  // (block shift, phase) of the three taps along one axis.
  const int dsh[3] = {-1, 0, 0};
  const int ph[3] = {1, 0, 1};
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int u = i + dsh[r];
    if (u < 0) continue;  // top padding
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int v = j + dsh[q];
      if (v < 0) continue;  // left padding
      const int c = (ph[r] * 2 + ph[q]) * O + f;
      float a, e;
      Pair<T>::load(img + ((long long)u * V + v) * c4 + c, a, e);
      m0 = fmaxf(m0, __fadd_rn(__fmul_rn(a, s0), h0));
      m1 = fmaxf(m1, __fadd_rn(__fmul_rn(e, s1), h1));
    }
  }
  Pair<T>::store(out + t * 2, fmaxf(m0, 0.f), fmaxf(m1, 0.f));
}

template <typename T>
int launch(const void* ys, const void* scale, const void* shift, void* out,
           int B, int U, int V, int O, void* stream) {
  const long long total = (long long)B * U * V * (O / 2);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bn_relu_pool_fwd_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const T*>(ys), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), total, U, V, O);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernel cova_tpu/ops/bn_pool.py::_bwd_kernel. For the
// cotangent g [B, U, V, O] of the pooled map it recomputes which tap won
// each output, with the TPU kernel's tie rule:
//   * column stage, ex = 1 groups: block column j-1 against j, and j-1 wins
//     ties (>=);
//   * row stage, ey = 1 groups: block row i-1 against i (after the column
//     stage), and i-1 wins ties;
//   * phase stage: the lowest group index (ey*2 + ex) attaining the max;
//   * gradient flows only where that max (before the ReLU) is > 0.
// The winner gets g; then dpre = the routed sum at each input,
//   dys = dpre * scale (rounded once to ys.dtype),
//   d(scale) = sum dpre * ys and d(shift) = sum dpre over the map, per
//   channel of the 4*O (the wrapper folds the four groups to O, which is
//   what the jnp.tile VJP does in the JAX package).
//
// Design: a gather, so no atomics and no scratch map. One thread per work
// item (b, u, v, channel pair f, f+1) owns the four phase-group elements of
// s2d block (u, v). They lie in the windows of at most four outputs,
// (u, v), (u+1, v), (u, v+1) and (u+1, v+1); the thread recomputes the
// winner of each (nine taps, with the forward's unfused affine, so the
// winners are the forward's) and adds g where the winning tap is its own
// element. The contributions are added in the plain version's order,
//   dpre = (c(u, v) + c(u+1, v)) + (c(u, v+1) + c(u+1, v+1)),
// so dys equals the plain version bit for bit. Each thread keeps its
// channels' d(scale)/d(shift) sums over a grid-stride loop; a block sums
// its threads in shared memory, in a fixed order, into one row of partials
// [n_blocks, 2, 4*O] that the wrapper sums. Those sums are exact up to f32
// rounding in another order than the plain version's.
//
// What bounds it on the H100: HBM bytes, as the forward: ys and dys
// (B x 320 x 320 x 256, 262 MB each in bf16 at B = 5) and g once. The
// thread re-reads the taps it shares with its neighbours (36 pair loads for
// four outputs); those repeats hit L1/L2.

// The affine of one pair of taps, -inf where the tap is padding.
template <typename T>
__device__ __forceinline__ void tap(const T* img, int r, int c, int V, int c4,
                                    int ch, const float s[2], const float h[2],
                                    float z[2]) {
  if (r < 0 || c < 0) {
    z[0] = z[1] = -CUDART_INF_F;
    return;
  }
  float a, e;
  Pair<T>::load(img + ((long long)r * V + c) * c4 + ch, a, e);
  z[0] = __fadd_rn(__fmul_rn(a, s[0]), h[0]);
  z[1] = __fadd_rn(__fmul_rn(e, s[1]), h[1]);
}

// Column stage of group (., ex) at block row r for output column j: the
// value and whether column j-1 won.
template <typename T>
__device__ __forceinline__ void col_stage(const T* img, int r, int j, int ex,
                                          int V, int c4, int ch,
                                          const float s[2], const float h[2],
                                          float zc[2], bool cs[2]) {
  tap<T>(img, r, j, V, c4, ch, s, h, zc);
  cs[0] = cs[1] = false;
  if (ex) {
    float zl[2];
    tap<T>(img, r, j - 1, V, c4, ch, s, h, zl);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      cs[k] = zl[k] >= zc[k];
      if (cs[k]) zc[k] = zl[k];
    }
  }
}

// For output (i, j) and channels f, f+1: the winning group w[k] (-1 where
// the pooled max is <= 0 and no gradient flows) and the block (wr, wc) of
// its winning tap.
template <typename T>
__device__ __forceinline__ void route(const T* img, int i, int j, int V, int O, int f,
                      const float s[2], const float h[2], int w[2], int wr[2],
                      int wc[2]) {
  const int c4 = 4 * O;
  float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
  w[0] = w[1] = -1;
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
    const int ey = gi >> 1, ex = gi & 1;
    const int ch = gi * O + f;
    float zi[2], zr[2];
    bool ci[2], cu[2] = {false, false}, rs[2] = {false, false};
    col_stage<T>(img, i, j, ex, V, c4, ch, s, h, zi, ci);
    zr[0] = zi[0];
    zr[1] = zi[1];
    if (ey) {
      float zu[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (i > 0) col_stage<T>(img, i - 1, j, ex, V, c4, ch, s, h, zu, cu);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs[k] = zu[k] >= zi[k];
        if (rs[k]) zr[k] = zu[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (zr[k] > best[k]) {  // strict: the first group at the max wins
        best[k] = zr[k];
        w[k] = gi;
        wr[k] = rs[k] ? i - 1 : i;
        wc[k] = (rs[k] ? cu[k] : ci[k]) ? j - 1 : j;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (!(best[k] > 0.f)) w[k] = -1;
}

// grid: n_blocks; block: threads (a multiple of O/2). partial: f32
// [n_blocks, 2, 4*O], the block's d(scale) then d(shift) sums.
template <typename T>
__global__ void bn_relu_pool_bwd_kernel(const T* __restrict__ ys,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        const T* __restrict__ g,
                                        T* __restrict__ dys,
                                        float* __restrict__ partial,
                                        long long total, int U, int V, int O) {
  extern __shared__ float red[];  // [blockDim.x][16]
  const int half = O / 2;
  const int c4 = 4 * O;
  const int f = 2 * (int)(threadIdx.x % half);  // fixed across the stride
  const float s[2] = {__ldg(scale + f), __ldg(scale + f + 1)};
  const float h[2] = {__ldg(shift + f), __ldg(shift + f + 1)};
  float dsc[4][2] = {}, dsh[4][2] = {};
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    long long rest = t / half;
    const int v = (int)(rest % V);
    rest /= V;
    const int u = (int)(rest % U);
    const long long b = rest / U;
    const T* img = ys + b * U * V * c4;
    const T* gimg = g + b * U * V * O;
    // acc[dj][group][k]: contributions of output column v + dj, rows u then
    // u + 1, in the plain version's order.
    float acc[2][4][2] = {};
#pragma unroll
    for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const int i = u + di, j = v + dj;
        if (i >= U || j >= V) continue;
        int w[2], wr[2], wc[2];
        route<T>(img, i, j, V, O, f, s, h, w, wr, wc);
        if ((w[0] < 0 || wr[0] != u || wc[0] != v) &&
            (w[1] < 0 || wr[1] != u || wc[1] != v))
          continue;
        float g0, g1;
        Pair<T>::load(gimg + ((long long)i * V + j) * O + f, g0, g1);
        if (w[0] >= 0 && wr[0] == u && wc[0] == v) acc[dj][w[0]][0] += g0;
        if (w[1] >= 0 && wr[1] == u && wc[1] == v) acc[dj][w[1]][1] += g1;
      }
    }
    const long long base = (((long long)b * U + u) * V + v) * c4;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const float d0 = acc[0][gi][0] + acc[1][gi][0];
      const float d1 = acc[0][gi][1] + acc[1][gi][1];
      const int ch = gi * O + f;
      Pair<T>::store(dys + base + ch, __fmul_rn(d0, s[0]),
                     __fmul_rn(d1, s[1]));
      float x0, x1;
      Pair<T>::load(ys + base + ch, x0, x1);
      dsc[gi][0] += d0 * x0;
      dsc[gi][1] += d1 * x1;
      dsh[gi][0] += d0;
      dsh[gi][1] += d1;
    }
  }
  float* mine = red + threadIdx.x * 16;
#pragma unroll
  for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      mine[gi * 2 + k] = dsc[gi][k];
      mine[8 + gi * 2 + k] = dsh[gi][k];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < half) {
    float sc[8] = {}, sh[8] = {};
    for (int r = threadIdx.x; r < (int)blockDim.x; r += half) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        sc[q] += red[r * 16 + q];
        sh[q] += red[r * 16 + 8 + q];
      }
    }
    float* row = partial + (long long)blockIdx.x * 2 * c4;
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        row[gi * O + f + k] = sc[gi * 2 + k];
        row[c4 + gi * O + f + k] = sh[gi * 2 + k];
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* ys, const void* scale, const void* shift,
               const void* g, void* dys, void* partial, int B, int U, int V,
               int O, int n_blocks, void* stream) {
  const int half = O / 2;
  if (half < 1 || half > 256 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * U * V * half;
  const int threads = half * (256 / half);
  const size_t smem = (size_t)threads * 16 * sizeof(float);
  bn_relu_pool_bwd_kernel<T><<<n_blocks, threads, smem,
                               (cudaStream_t)stream>>>(
      static_cast<const T*>(ys), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(g),
      static_cast<T*>(dys), static_cast<float*>(partial), total, U, V, O);
  return (int)cudaGetLastError();
}

}  // namespace

// ys: [B, U, V, 4*O] contiguous (O even, O <= 512); scale, shift: f32 [O];
// g: [B, U, V, O]; dys: [B, U, V, 4*O]; partial: f32 [n_blocks, 2, 4*O].
// Returns the cudaError_t of the launch.
extern "C" int bn_relu_pool_bwd_f32(const void* ys, const void* scale,
                                    const void* shift, const void* g,
                                    void* dys, void* partial, int B, int U,
                                    int V, int O, int n_blocks, void* stream) {
  return launch_bwd<float>(ys, scale, shift, g, dys, partial, B, U, V, O,
                           n_blocks, stream);
}

extern "C" int bn_relu_pool_bwd_bf16(const void* ys, const void* scale,
                                     const void* shift, const void* g,
                                     void* dys, void* partial, int B, int U,
                                     int V, int O, int n_blocks,
                                     void* stream) {
  return launch_bwd<__nv_bfloat16>(ys, scale, shift, g, dys, partial, B, U,
                                   V, O, n_blocks, stream);
}

// ys: [B, U, V, 4*O] contiguous (O even); scale, shift: f32 [O];
// out: [B, U, V, O]. Returns the cudaError_t of the launch.
extern "C" int bn_relu_pool_fwd_f32(const void* ys, const void* scale,
                                    const void* shift, void* out, int B, int U,
                                    int V, int O, void* stream) {
  return launch<float>(ys, scale, shift, out, B, U, V, O, stream);
}

extern "C" int bn_relu_pool_fwd_bf16(const void* ys, const void* scale,
                                     const void* shift, void* out, int B,
                                     int U, int V, int O, void* stream) {
  return launch<__nv_bfloat16>(ys, scale, shift, out, B, U, V, O, stream);
}
