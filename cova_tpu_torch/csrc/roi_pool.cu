// RoIPool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel cova_tpu/ops/roi_pool_pallas.py::_fwd_kernel_ranged
// (the default forward) and its plain-walk variant ::_fwd_kernel, which
// compute the same function:
//
//   out[b, p, i, j, c] = max over the rows [ylo_i, yhi_i) and the columns
//                        [xlo_j, xhi_j) of fm[b, y, x, c];
//   an empty bin (hi <= lo) gives 0, and a masked box has all-zero bounds,
//   so every one of its bins is empty and gives 0.
//
// The bin bounds are computed by the wrapper in PyTorch on the device, with
// the integer rules of roi_pool_pallas.py::_bounds (roundf quantization,
// inclusive-end roi, floor/ceil bins clipped to the map), and passed here as
// int32 [B, P, 2*out_h + 2*out_w]: ylo[out_h], yhi[out_h], xlo[out_w],
// xhi[out_w].
//
// What bounds it on the H100: the work depends on the boxes. Every pixel of
// a box is read once per bin that holds it, and the feature map of one image
// (320 x 320 x 64 bf16 = 13 MB at the flagship shape) stays in the 50 MB L2,
// so the least time is that of reading the union of the boxes' pixels from
// HBM once; the maxes themselves are cheap.
//
// Design: one block per (image, box), one warp per bin, and each thread of
// the warp owns two neighbouring channels, so a warp reads one pixel's 64
// channels as one 128-byte (bf16) or 256-byte (f32) contiguous row of the
// NHWC map. The warp walks its bin's pixels in order. The max is taken in
// f32 and cast back, which is exact: a max selects one of its inputs. The
// TPU kernel's chunk-max pyramid, 128-lane windows and channel-in-sublane
// folding are not carried over: they fit VMEM and vector tiles, not this
// card. Balancing large and small bins across warps is work for a later
// change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

template <typename T> struct Pair;

template <> struct Pair<float> {
  using V = float2;
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void split(float2 v, float& a, float& b) { a = v.x; b = v.y; }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static __nv_bfloat162 load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static void split(__nv_bfloat162 v, float& a, float& b) {
    a = __low2float(v);
    b = __high2float(v);
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// grid: B * P blocks; block: (32, out_h * out_w) threads.
template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ fm,
                                    const int* __restrict__ bounds,
                                    T* __restrict__ out, int P, int H, int W,
                                    int C, int out_h, int out_w) {
  const int bp = blockIdx.x;  // b * P + p
  const int b = bp / P;
  const int bin = threadIdx.y;
  const int i = bin / out_w;
  const int j = bin % out_w;
  const int* bd = bounds + (size_t)bp * (2 * out_h + 2 * out_w);
  const int y0 = bd[i], y1 = bd[out_h + i];
  const int x0 = bd[2 * out_h + j], x1 = bd[2 * out_h + out_w + j];
  const bool empty = (y1 <= y0) || (x1 <= x0);

  const T* img = fm + (size_t)b * H * W * C;
  T* dst = out + ((size_t)bp * out_h * out_w + bin) * C;
  for (int c = 2 * threadIdx.x; c < C; c += 2 * blockDim.x) {
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
    if (!empty) {
      for (int y = y0; y < y1; ++y) {
        const T* row = img + (size_t)y * W * C + c;
#pragma unroll 4
        for (int x = x0; x < x1; ++x) {
          float a, v;
          Pair<T>::split(Pair<T>::load(row + (size_t)x * C), a, v);
          m0 = fmaxf(m0, a);
          m1 = fmaxf(m1, v);
        }
      }
    } else {
      m0 = 0.f;
      m1 = 0.f;
    }
    Pair<T>::store(dst + c, m0, m1);
  }
}

template <typename T>
int launch(const void* fm, const void* bounds, void* out, int B, int P, int H,
           int W, int C, int out_h, int out_w, void* stream) {
  if (B * P == 0) return 0;
  dim3 block(32, out_h * out_w);
  roi_pool_fwd_kernel<T><<<B * P, block, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(fm), static_cast<const int*>(bounds),
      static_cast<T*>(out), P, H, W, C, out_h, out_w);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the TPU kernels cova_tpu/ops/roi_pool_pallas.py::
// _bwd_kernel_pyramid (the default backward) and its plain-walk variant
// ::_bwd_kernel (COVA_ROI_BWD=walk), which compute the same function:
//
//   dfm[b, y, x, c] = sum of g[b, p, i, j, c] over the bins (p, i, j) that
//                     hold (y, x) and where fm[b, y, x, c] == pooled[b, p,
//                     i, j, c];
//
// every tied maximum gets the full cotangent, empty bins and masked boxes
// (all-zero bounds) add nothing.
//
// Design: a gather, deterministic and free of atomics. A block owns a tile
// of TILE_Y x TILE_X pixels of one image. Its threads first build, in shared
// memory and in ascending box order, the list of boxes whose outer range
// meets the tile (a ballot and a prefix count per chunk of boxes). Then each
// warp takes one row of the tile, two channels per thread (a pixel's 64
// channels are one 128-byte bf16 row of the NHWC map), keeps the tile row's
// fm values and f32 sums in registers, and walks the list: for each bin
// holding the pixel, it compares and adds. Each pixel's contributions are
// added in f32 in (box, bin row, bin column) order, the order of the plain
// version's loop, and written once in fm.dtype: the result equals the plain
// version bit for bit, and every pixel of the map is written, so dfm needs
// no zero fill.
//
// What bounds it on the H100: HBM bytes, the map read where boxes cover it,
// pooled and g read, and dfm written whole (13 MB per bf16 image at the
// flagship shape). The list keeps the per-pixel work to the boxes that meet
// the tile; each warp still re-reads a box's bounds and its bins' pooled and
// g rows from L1/L2.

constexpr int TILE_X = 8;  // pixels per warp (one row of the tile)

// grid: (ceil(W / TILE_X), ceil(H / rows), B); block: (32, rows) threads;
// dynamic shared memory: P ints.
template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ fm,
                                    const int* __restrict__ bounds,
                                    const T* __restrict__ pooled,
                                    const T* __restrict__ g,
                                    T* __restrict__ dfm, int P, int H, int W,
                                    int C, int out_h, int out_w) {
  extern __shared__ int list[];
  __shared__ int wcount[32];
  const int b = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int n_warps = blockDim.y;
  const int ty0 = blockIdx.y * n_warps, tx0 = blockIdx.x * TILE_X;
  const int nb = 2 * out_h + 2 * out_w;
  const int* bd_img = bounds + (size_t)b * P * nb;

  // 1. The boxes whose outer range meets the tile, in ascending order.
  int n = 0;
  for (int base = 0; base < P; base += 32 * n_warps) {
    const int p = base + warp * 32 + lane;
    bool hit = false;
    if (p < P) {
      const int* bd = bd_img + (size_t)p * nb;
      const int y0 = bd[0], y1 = bd[2 * out_h - 1];
      const int x0 = bd[2 * out_h], x1 = bd[nb - 1];
      hit = y0 < y1 && x0 < x1 && y0 < ty0 + n_warps && y1 > ty0 &&
            x0 < tx0 + TILE_X && x1 > tx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int off = n, chunk = 0;
    for (int q = 0; q < n_warps; ++q) {
      if (q < warp) off += wcount[q];
      chunk += wcount[q];
    }
    if (hit) list[off + __popc(ballot & ((1u << lane) - 1u))] = p;
    n += chunk;
    __syncthreads();
  }

  // 2. One warp per tile row, two channels per thread.
  const int y = ty0 + warp;
  if (y >= H) return;
  const T* row = fm + ((size_t)b * H + y) * W * C;
  T* drow = dfm + ((size_t)b * H + y) * W * C;
  const size_t bins = (size_t)out_h * out_w;
  for (int c = 2 * lane; c < C; c += 64) {
    float f[TILE_X][2], acc[TILE_X][2];
#pragma unroll
    for (int t = 0; t < TILE_X; ++t) {
      acc[t][0] = acc[t][1] = 0.f;
      f[t][0] = f[t][1] = 0.f;
      if (tx0 + t < W)
        Pair<T>::split(Pair<T>::load(row + (size_t)(tx0 + t) * C + c),
                       f[t][0], f[t][1]);
    }
    for (int q = 0; q < n; ++q) {
      const int p = list[q];
      const int* bd = bd_img + (size_t)p * nb;
      if (y < bd[0] || y >= bd[2 * out_h - 1]) continue;
      const size_t cell0 = ((size_t)b * P + p) * bins;
      for (int i = 0; i < out_h; ++i) {
        if (y < bd[i] || y >= bd[out_h + i]) continue;
        for (int j = 0; j < out_w; ++j) {
          const int xl = bd[2 * out_h + j], xh = bd[2 * out_h + out_w + j];
          if (xh <= xl || xl >= tx0 + TILE_X || xh <= tx0) continue;
          const size_t at = (cell0 + i * out_w + j) * C + c;
          float p0, p1, g0, g1;
          Pair<T>::split(Pair<T>::load(pooled + at), p0, p1);
          Pair<T>::split(Pair<T>::load(g + at), g0, g1);
#pragma unroll
          for (int t = 0; t < TILE_X; ++t) {
            const int x = tx0 + t;
            if (x < xl || x >= xh) continue;
            if (f[t][0] == p0) acc[t][0] += g0;
            if (f[t][1] == p1) acc[t][1] += g1;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < TILE_X; ++t)
      if (tx0 + t < W)
        Pair<T>::store(drow + (size_t)(tx0 + t) * C + c, acc[t][0],
                       acc[t][1]);
  }
}

template <typename T>
int launch_bwd(const void* fm, const void* bounds, const void* pooled,
               const void* g, void* dfm, int B, int P, int H, int W, int C,
               int out_h, int out_w, void* stream) {
  if ((long long)B * H * W == 0) return 0;
  const int rows = 8;  // warps per block = tile rows
  dim3 grid((W + TILE_X - 1) / TILE_X, (H + rows - 1) / rows, B);
  dim3 block(32, rows);
  const size_t smem = (size_t)(P > 0 ? P : 1) * sizeof(int);
  roi_pool_bwd_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(fm), static_cast<const int*>(bounds),
      static_cast<const T*>(pooled), static_cast<const T*>(g),
      static_cast<T*>(dfm), P, H, W, C, out_h, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

// fm: [B, H, W, C] contiguous (C even); bounds: int32 [B, P, 2*oh + 2*ow];
// pooled, g: [B, P, oh, ow, C]; dfm: [B, H, W, C]; P <= 8192 (the tile's
// box list lives in shared memory). Returns the cudaError_t of the launch.
extern "C" int roi_pool_bwd_f32(const void* fm, const void* bounds,
                                const void* pooled, const void* g, void* dfm,
                                int B, int P, int H, int W, int C, int out_h,
                                int out_w, void* stream) {
  return launch_bwd<float>(fm, bounds, pooled, g, dfm, B, P, H, W, C, out_h,
                           out_w, stream);
}

extern "C" int roi_pool_bwd_bf16(const void* fm, const void* bounds,
                                 const void* pooled, const void* g, void* dfm,
                                 int B, int P, int H, int W, int C, int out_h,
                                 int out_w, void* stream) {
  return launch_bwd<__nv_bfloat16>(fm, bounds, pooled, g, dfm, B, P, H, W, C,
                                   out_h, out_w, stream);
}

// fm: [B, H, W, C] contiguous (C even); bounds: int32 [B, P, 2*oh + 2*ow];
// out: [B, P, oh, ow, C]. Returns the cudaError_t of the launch.
extern "C" int roi_pool_fwd_f32(const void* fm, const void* bounds, void* out,
                                int B, int P, int H, int W, int C, int out_h,
                                int out_w, void* stream) {
  return launch<float>(fm, bounds, out, B, P, H, W, C, out_h, out_w, stream);
}

extern "C" int roi_pool_fwd_bf16(const void* fm, const void* bounds, void* out,
                                 int B, int P, int H, int W, int C, int out_h,
                                 int out_w, void* stream) {
  return launch<__nv_bfloat16>(fm, bounds, out, B, P, H, W, C, out_h, out_w,
                               stream);
}
