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
// The bin bounds follow one rule, box_roi and bin_range below, in both
// directions: the forward's bins kernel applies it to its own bin, and the
// backward first launches roi_pool_bounds_kernel, which writes every box's
// bounds as int32 [B, P, 2*out_h + 2*out_w] (ylo[out_h], yhi[out_h],
// xlo[out_w], xhi[out_w]) for the backward kernel to read. (A bins kernel
// that read that table, in place of computing its bounds, compiled to more
// registers and ran slower in bf16 on the H100; see PERF.md.)
//
// What bounds it on the H100: the work depends on the boxes. The least time
// is that of reading the union of the boxes' pixels from HBM once. The
// synthetic flagship pages hold large, overlapping boxes: the bins' pixel
// counts add up to about ten times that union, and one bin can span 100 x
// 100 map pixels, so a kernel that walks every bin pixel by pixel re-reads
// over a gigabyte from L2 per serving batch and waits on its largest bin.
//
// Design, two launches:
//   1. Pyramid: m1[b, k, x, c] = max of fm over the rows [kR, min(H,
//      (k+1)R)) with R = kChunk (the TPU kernel's m1, in fm's dtype). One
//      pass reads the map once; the last chunk may be partial, nothing is
//      padded. Each thread reduces one 16-byte vector over the chunk's rows.
//   2. Bins: one block per (image, box, bin), images in descending order so
//      the first blocks find the last images' rows still in L2. A bin's
//      rows are its top edge rows (fm), the chunks that lie wholly inside
//      it (m1; the last, partial chunk counts when the bin reaches the
//      bottom of the map) and its bottom edge rows (fm): for a 100-row bin
//      about 20 row reads instead of 100. The block's 128 threads split the
//      bin's columns into pixel slots, each thread owning one 16-byte vector
//      of channels (8 bf16 or 4 f32; one pair where C does not allow it),
//      so a warp reads 4 pixels x 64 bf16 channels per load, and every
//      thread keeps 8 loads in flight. The slots' maxima meet in shared
//      memory and the block stores whole 16-byte vectors.
// A max selects one of its inputs, so every decomposition is exact: the
// result equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 8;         // pyramid rows per chunk (ops/roi_pool.py)
constexpr int kBinThreads = 128;  // threads of one bin's block
constexpr int kInFlight = 8;      // loads a thread issues before its maxes
constexpr int kPyrThreads = 256;

template <int N>
__device__ __forceinline__ void vmax(Vec<float, N>& a, const Vec<float, N>& b) {
#pragma unroll
  for (int k = 0; k < N; ++k) a.v[k] = fmaxf(a.v[k], b.v[k]);
}

template <int N>
__device__ __forceinline__ void vmax(Vec<__nv_bfloat16, N>& a,
                                     const Vec<__nv_bfloat16, N>& b) {
  auto* x = reinterpret_cast<__nv_bfloat162*>(a.v);
  const auto* y = reinterpret_cast<const __nv_bfloat162*>(b.v);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) x[k] = __hmax2(x[k], y[k]);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> vfill(float x) {
  Vec<T, N> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.v[k] = from_float<T>(x);
  return r;
}

// ------------------------------------------------------------------ bounds
//
// The rule of roi_pool_pallas.py::_bounds, as ops/roi_pool.py::roi_bounds
// (the plain version) computes it: roundf quantization of box * scale (an
// unfused multiply and add, as PyTorch computes it), an inclusive-end roi
// of at least one pixel, floor/ceil bins offset by the roi start and
// clipped to the map. A masked box has all-zero bounds.

// roundf of v * scale in f32.
__device__ __forceinline__ int quantize(float v, float scale) {
  const float vs = __fmul_rn(v, scale);
  return (int)truncf(__fadd_rn(vs, vs >= 0.f ? 0.5f : -0.5f));
}

// A box's roi: its quantized first row and column and its height and width.
struct Roi {
  int y0, h, x0, w;
};
__device__ __forceinline__ Roi box_roi(const float* bx, float scale) {
  const int x1 = quantize(bx[0], scale), y1 = quantize(bx[1], scale);
  const int x2 = quantize(bx[2], scale), y2 = quantize(bx[3], scale);
  return {y1, max(y2 - y1 + 1, 1), x1, max(x2 - x1 + 1, 1)};
}

// Map rows (columns) [lo, hi) of bin k of n over a roi starting at s of
// length len >= 1, clipped to [0, limit].
__device__ __forceinline__ void bin_range(int s, int len, int k, int n,
                                          int limit, int& lo, int& hi) {
  lo = min(max(k * len / n + s, 0), limit);
  hi = min(max(((k + 1) * len + n - 1) / n + s, 0), limit);
}

// The bounds of every box, one thread per (image, box).
// grid: ceil(n_boxes / 128) blocks of 128; n_boxes = B * P.
__global__ void roi_pool_bounds_kernel(const float* __restrict__ boxes,
                                       const unsigned char* __restrict__ mask,
                                       int* __restrict__ bounds, int n_boxes,
                                       int H, int W, int out_h, int out_w,
                                       float scale) {
  const int bp = blockIdx.x * blockDim.x + threadIdx.x;
  if (bp >= n_boxes) return;
  const int nb = 2 * out_h + 2 * out_w;
  int* bd = bounds + (long long)bp * nb;
  if (mask != nullptr && !mask[bp]) {
    for (int k = 0; k < nb; ++k) bd[k] = 0;
    return;
  }
  const Roi r = box_roi(boxes + (long long)bp * 4, scale);
  for (int k = 0; k < out_h; ++k)
    bin_range(r.y0, r.h, k, out_h, H, bd[k], bd[out_h + k]);
  for (int k = 0; k < out_w; ++k)
    bin_range(r.x0, r.w, k, out_w, W, bd[2 * out_h + k],
              bd[2 * out_h + out_w + k]);
}

int launch_roi_bounds(const void* boxes, const void* mask, void* bounds,
                      int B, int P, int H, int W, int out_h, int out_w,
                      float scale, void* stream) {
  const long long n = (long long)B * P;
  if (n == 0) return 0;
  if (n > 2147483647LL) return (int)cudaErrorInvalidValue;
  roi_pool_bounds_kernel<<<(unsigned)((n + 127) / 128), 128, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(mask), static_cast<int*>(bounds),
      (int)n, H, W, out_h, out_w, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- forward

// grid: (ceil(W * C / N / kPyrThreads), min(B * K, 65535)); K = ceil(H / R).
template <typename T, int N>
__global__ void __launch_bounds__(kPyrThreads)
roi_pool_pyramid_kernel(const T* __restrict__ fm, T* __restrict__ pyr, int B,
                        int H, int W, int C) {
  using V = Vec<T, N>;
  const int K = (H + kChunk - 1) / kChunk;
  const long long row_vecs = (long long)W * C / N;  // vectors per map row
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= row_vecs) return;
  for (long long bk = blockIdx.y; bk < (long long)B * K; bk += gridDim.y) {
    const long long b = bk / K;
    const int k = (int)(bk % K);
    const int y0 = k * kChunk;
    const V* src =
        reinterpret_cast<const V*>(fm + (b * H + y0) * (long long)W * C) + t;
    V acc;
    if (H - y0 >= kChunk) {
      V r[kChunk];
#pragma unroll
      for (int y = 0; y < kChunk; ++y) r[y] = src[y * row_vecs];
      acc = r[0];
#pragma unroll
      for (int y = 1; y < kChunk; ++y) vmax(acc, r[y]);
    } else {  // the last, partial chunk
      acc = src[0];
      for (int y = 1; y < H - y0; ++y) vmax(acc, src[y * row_vecs]);
    }
    reinterpret_cast<V*>(pyr + bk * W * (long long)C)[t] = acc;
  }
}

// grid: min(n_items, 2^31 - 1) blocks of kBinThreads; item = (b, p, bin),
// walked from the last image to the first.
template <typename T, int N>
__global__ void __launch_bounds__(kBinThreads)
roi_pool_bins_kernel(const T* __restrict__ fm, const T* __restrict__ pyr,
                     const float* __restrict__ boxes,
                     const unsigned char* __restrict__ mask,
                     T* __restrict__ out, long long n_items, int P, int H,
                     int W, int C, int out_h, int out_w, float scale) {
  using V = Vec<T, N>;
  __shared__ V red[kBinThreads];
  const int G = C / N;                               // vectors per pixel
  const int Gc = G < kBinThreads ? G : kBinThreads;  // vectors per pass
  const int S = kBinThreads / Gc;                    // pixel slots
  const int slot = threadIdx.x / Gc, lane = threadIdx.x % Gc;
  const int K = (H + kChunk - 1) / kChunk;
  const int bins = out_h * out_w;
  const long long plane = (long long)W * C;
  for (long long it = blockIdx.x; it < n_items; it += gridDim.x) {
    const long long item = n_items - 1 - it;
    const long long bp = item / bins;
    const int bin = (int)(item % bins);
    const int i = bin / out_w, j = bin % out_w;
    const long long b = bp / P;
    int ylo = 0, yhi = 0, xlo = 0, xhi = 0;
    if (mask == nullptr || mask[bp]) {
      const Roi r = box_roi(boxes + bp * 4, scale);
      bin_range(r.y0, r.h, i, out_h, H, ylo, yhi);
      bin_range(r.x0, r.w, j, out_w, W, xlo, xhi);
    }
    T* dst = out + item * C;
    if (yhi <= ylo || xhi <= xlo) {
      const V z = vfill<T, N>(0.f);
      for (int v = threadIdx.x; v < G; v += kBinThreads)
        *reinterpret_cast<V*>(dst + v * N) = z;
      continue;
    }
    // Top edge rows [ylo, ylo + ntop) of fm, chunks [c0, c0 + nmid) of m1,
    // bottom edge rows [bot0, yhi) of fm.
    const int c0 = (ylo + kChunk - 1) / kChunk;
    const int c1 = yhi == H ? K : yhi / kChunk;
    int ntop = yhi - ylo, nmid = 0, bot0 = yhi;
    if (c0 < c1) {
      ntop = c0 * kChunk - ylo;
      nmid = c1 - c0;
      bot0 = min(c1 * kChunk, yhi);
    }
    const int nrows = ntop + nmid + (yhi - bot0);
    const T* img = fm + b * H * plane;
    const T* pim = pyr + b * K * plane;
    auto row_at = [&](int r) -> const T* {
      if (r < ntop) return img + (ylo + r) * plane;
      if (r < ntop + nmid) return pim + (c0 + r - ntop) * plane;
      return img + (bot0 + r - ntop - nmid) * plane;
    };
    const int nxl = (xhi - xlo + S - 1) / S;  // loads per row and thread
    const int total = nrows * nxl;
    for (int cc = 0; cc < G; cc += Gc) {
      const int cv = cc + lane;
      V acc = vfill<T, N>(-CUDART_INF_F);
      if (slot < S && cv < G) {
        const long long col = (long long)(xlo + slot) * C + cv * N;
        const long long step = (long long)S * C;
        int r = 0, xl = 0;
        const T* rowp = row_at(0) + col;
        for (int t0 = 0; t0 < total; t0 += kInFlight) {
          V v[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            v[u] = vfill<T, N>(-CUDART_INF_F);
            if (t0 + u < total && xlo + slot + xl * S < xhi)
              v[u] = *reinterpret_cast<const V*>(rowp + xl * step);
            if (++xl == nxl) {
              xl = 0;
              if (++r < nrows) rowp = row_at(r) + col;
            }
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) vmax(acc, v[u]);
        }
      }
      red[threadIdx.x] = acc;
      __syncthreads();
      if (threadIdx.x < Gc && cv < G) {
        V m = red[threadIdx.x];
        for (int s = 1; s < S; ++s) vmax(m, red[s * Gc + threadIdx.x]);
        *reinterpret_cast<V*>(dst + cv * N) = m;
      }
      __syncthreads();
    }
  }
}

template <typename T, int N>
int launch_fwd(const void* fm, const void* boxes, const void* mask, void* pyr,
               void* out, int B, int P, int H, int W, int C, int out_h,
               int out_w, float scale, void* stream) {
  const long long n_items = (long long)B * P * out_h * out_w;
  if (n_items == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long row_vecs = (long long)W * C / N;
  const long long bk = (long long)B * ((H + kChunk - 1) / kChunk);
  if (row_vecs > 0 && bk > 0) {
    dim3 grid((unsigned)((row_vecs + kPyrThreads - 1) / kPyrThreads),
              (unsigned)(bk < 65535 ? bk : 65535));
    roi_pool_pyramid_kernel<T, N><<<grid, kPyrThreads, 0, st>>>(
        static_cast<const T*>(fm), static_cast<T*>(pyr), B, H, W, C);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const long long blocks = n_items < 2147483647LL ? n_items : 2147483647LL;
  roi_pool_bins_kernel<T, N><<<(unsigned)blocks, kBinThreads, 0, st>>>(
      static_cast<const T*>(fm), static_cast<const T*>(pyr),
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), n_items,
      P, H, W, C, out_h, out_w, scale);
  return (int)cudaGetLastError();
}

// One pair of channels, read and written as one access (the backward).
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

// fm: [B, H, W, C] contiguous (C even); pooled, g: [B, P, oh, ow, C]; dfm:
// [B, H, W, C]; P <= 8192 (the tile's box list lives in shared memory).
// The bin bounds first, then the kernel.
template <typename T>
int bwd(const void* fm, const void* boxes, const void* mask, void* bounds,
        const void* pooled, const void* g, void* dfm, int B, int P, int H,
        int W, int C, int out_h, int out_w, float scale, void* stream) {
  const int rc = launch_roi_bounds(boxes, mask, bounds, B, P, H, W, out_h,
                                   out_w, scale, stream);
  return rc ? rc
            : launch_bwd<T>(fm, bounds, pooled, g, dfm, B, P, H, W, C, out_h,
                            out_w, stream);
}

// fm: [B, H, W, C] contiguous (C even); pyr: [B, ceil(H / chunk), W, C],
// scratch for the pyramid; out: [B, P, oh, ow, C]. vec: channels per access
// (NV: 16 bytes' worth, where C and the pointers allow; else N2 = 2); chunk
// must be kChunk.
template <typename T, int NV, int N2>
int fwd(const void* fm, const void* boxes, const void* mask, void* pyr,
        void* out, int B, int P, int H, int W, int C, int out_h, int out_w,
        float scale, int vec, int chunk, void* stream) {
  if (chunk != kChunk || (vec != NV && vec != N2))
    return (int)cudaErrorInvalidValue;
  return vec == NV ? launch_fwd<T, NV>(fm, boxes, mask, pyr, out, B, P, H, W,
                                       C, out_h, out_w, scale, stream)
                   : launch_fwd<T, N2>(fm, boxes, mask, pyr, out, B, P, H, W,
                                       C, out_h, out_w, scale, stream);
}

}  // namespace

// Every entry point takes the boxes, f32 [B, P, 4] x1y1x2y2 in image
// coordinates, their mask, bool [B, P] or null, and `scale`; those with a
// `bounds` argument write the bin bounds, int32 [B, P, 2*oh + 2*ow], into
// it first. Each returns the cudaError_t of its launches.

extern "C" int roi_pool_bounds(const void* boxes, const void* mask,
                               void* bounds, int B, int P, int H, int W,
                               int out_h, int out_w, float scale,
                               void* stream) {
  return launch_roi_bounds(boxes, mask, bounds, B, P, H, W, out_h, out_w,
                           scale, stream);
}

extern "C" int roi_pool_fwd_f32(const void* fm, const void* boxes,
                                const void* mask, void* pyr, void* out, int B,
                                int P, int H, int W, int C, int out_h,
                                int out_w, float scale, int vec, int chunk,
                                void* stream) {
  return fwd<float, 4, 2>(fm, boxes, mask, pyr, out, B, P, H, W, C, out_h,
                          out_w, scale, vec, chunk, stream);
}

extern "C" int roi_pool_fwd_bf16(const void* fm, const void* boxes,
                                 const void* mask, void* pyr, void* out,
                                 int B, int P, int H, int W, int C, int out_h,
                                 int out_w, float scale, int vec, int chunk,
                                 void* stream) {
  return fwd<__nv_bfloat16, 8, 2>(fm, boxes, mask, pyr, out, B, P, H, W, C,
                                  out_h, out_w, scale, vec, chunk, stream);
}

extern "C" int roi_pool_bwd_f32(const void* fm, const void* boxes,
                                const void* mask, void* bounds,
                                const void* pooled, const void* g, void* dfm,
                                int B, int P, int H, int W, int C, int out_h,
                                int out_w, float scale, void* stream) {
  return bwd<float>(fm, boxes, mask, bounds, pooled, g, dfm, B, P, H, W, C,
                    out_h, out_w, scale, stream);
}

extern "C" int roi_pool_bwd_bf16(const void* fm, const void* boxes,
                                 const void* mask, void* bounds,
                                 const void* pooled, const void* g, void* dfm,
                                 int B, int P, int H, int W, int C, int out_h,
                                 int out_w, float scale, void* stream) {
  return bwd<__nv_bfloat16>(fm, boxes, mask, bounds, pooled, g, dfm, B, P, H,
                            W, C, out_h, out_w, scale, stream);
}
