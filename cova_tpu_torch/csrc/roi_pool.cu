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

// The bounds of every box, one thread per (image, box); the first thread
// also zeroes the backward kernel's tile counter where there is one.
// grid: max(ceil(n_boxes / 128), 1) blocks of 128; n_boxes = B * P.
__global__ void roi_pool_bounds_kernel(const float* __restrict__ boxes,
                                       const unsigned char* __restrict__ mask,
                                       int* __restrict__ bounds,
                                       int* __restrict__ counter, int n_boxes,
                                       int H, int W, int out_h, int out_w,
                                       float scale) {
  const int bp = blockIdx.x * blockDim.x + threadIdx.x;
  if (bp == 0 && counter != nullptr) *counter = 0;
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
                      int* counter, int B, int P, int H, int W, int out_h,
                      int out_w, float scale, void* stream) {
  const long long n = (long long)B * P;
  if (n == 0 && counter == nullptr) return 0;
  if (n > 2147483647LL) return (int)cudaErrorInvalidValue;
  roi_pool_bounds_kernel<<<(unsigned)(n > 0 ? (n + 127) / 128 : 1), 128, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(mask), static_cast<int*>(bounds),
      counter, (int)n, H, W, out_h, out_w, scale);
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
// What bounds it on the H100: HBM bytes, the map read where boxes cover it,
// pooled and g read, and dfm written whole (13 MB per bf16 image at the
// flagship shape). What held the earlier kernel (a block per 8 x 8 pixels,
// each warp walking its tile's boxes and loading every box's and bin's
// bounds and every bin's pooled and g rows from L1/L2 one after another) was
// latency: 14% of the bound, f32 no slower than bf16 (PERF.md).
//
// Design: a gather, deterministic and free of atomics on dfm. Persistent
// blocks take tiles of 8 x 8 pixels of one image from a counter (zeroed by
// the bounds kernel just before), so a tile under twenty nested boxes and an
// empty one each hold a block only as long as their work. For each tile:
//   1. the boxes whose outer range meets the tile, in ascending order, into
//      shared memory (a ballot and a prefix count per round of boxes);
//   2. the list of (box, bin) pairs that meet the tile, in ascending (box,
//      bin row, bin column) order: one thread per candidate (listed box x
//      bin) reads that bin's bounds, clips them to the tile and, where they
//      meet it, is compacted into the list as (cell, a 64-bit map of the
//      tile's pixels in the bin); where the list would overflow its
//      capacity, the pairs so far are walked and the list starts again, in
//      the same order;
//   3. the walk, in chunks of `chunk` pairs: the pooled and g rows of the
//      next chunk's bins are copied into shared memory (cp.async) while the
//      block walks this chunk's, so every bound and operand of the walk is a
//      shared-memory read. A thread owns one row of the tile (8 pixels) and
//      one pair of channels, keeps their fm values and f32 sums in
//      registers, takes its row's byte of each listed bin's pixel map, and
//      compares and adds where it is set (a whole row with no tests).
// What holds it now is measured by scripts/ablate_roi_bwd.py, which times
// copies of this kernel with one stage left out (PERF.md): reading fm and
// writing dfm whole, and the compare-and-add of the walk.
// Each pixel's contributions are added in f32 in (box, bin row, bin column)
// order, the order of the plain version's loop, and written once in
// fm.dtype: the result equals the plain version bit for bit, and every
// pixel of the map is written, so dfm needs no zero fill.

constexpr int kBwdTile = 8;           // tile rows and columns
constexpr int kBwdMaxThreads = 256;   // 32 channel-pair lanes x 8 rows
constexpr unsigned long long kRowOnes = 0x0101010101010101ull;

// A block's shared memory (ops/roi_pool.py::roi_bwd_plan mirrors it): two
// stage buffers of `chunk` slots x (pooled row, g row) x `cv` channel pairs
// (row stride rounded up to 16 bytes), the pair list as cell int[cap] and
// pixel bitmap u64[cap], the box list int[P], the warps' counts and the
// tile number.
struct BwdSmem {
  int row_bytes, stage_bytes, bits_off, cell_off, box_off, wcount_off, total;
  __host__ __device__ BwdSmem(int cv, int pair_bytes, int chunk, int cap,
                              int P) {
    row_bytes = (cv * pair_bytes + 15) & ~15;
    stage_bytes = chunk * 2 * row_bytes;
    bits_off = 2 * stage_bytes;
    cell_off = bits_off + cap * 8;
    box_off = cell_off + ((cap * 4 + 15) & ~15);
    wcount_off = box_off + ((P * 4 + 15) & ~15);
    total = wcount_off + 9 * 4;
  }
};

// This thread's position among the block's threads with `hit` set, in
// thread order; `total`: how many have it set. Two barriers.
__device__ __forceinline__ int compact(bool hit, int* wcount, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) wcount[warp] = __popc(ballot);
  __syncthreads();
  int off = 0, tot = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) {
    const int c = wcount[q];
    off += q < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  total = tot;
  return off + __popc(ballot & ((1u << lane) - 1u));
}

// grid: the plan's blocks; block: the plan's threads (cv channel-pair lanes
// x kBwdTile rows, rounded up to a warp; thread = lane tid % cv, tile row
// tid / cv, which owns that row's kBwdTile pixels); dynamic shared memory:
// BwdSmem's total. counter: the next tile to take (0 at launch). kCopy16: the stage copies move 16
// bytes (rows of 16-byte multiples on 16-byte addresses), else one pair.
// At most 64 registers a thread, so four blocks share an SM.
template <typename T, bool kCopy16>
__global__ void __launch_bounds__(kBwdMaxThreads, 4)
roi_pool_bwd_kernel(const T* __restrict__ fm, const int* __restrict__ bounds,
                    const T* __restrict__ pooled, const T* __restrict__ g,
                    T* __restrict__ dfm, int* __restrict__ counter, int B,
                    int P, int H, int W, int C, int out_h, int out_w,
                    int cv_lanes, int cap, int chunk, int round) {
  using PV = typename Pair<T>::V;
  constexpr int kUnit = kCopy16 ? 16 : (int)sizeof(PV);
  constexpr int S = kBwdTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem lay(cv_lanes, (int)sizeof(PV), chunk, cap, P);
  unsigned long long* bits_s =
      reinterpret_cast<unsigned long long*>(smem + lay.bits_off);
  int* cell_s = reinterpret_cast<int*>(smem + lay.cell_off);
  int* box_s = reinterpret_cast<int*>(smem + lay.box_off);
  int* wcount = reinterpret_cast<int*>(smem + lay.wcount_off);
  int* tile_s = wcount + 8;
  const unsigned stage_u32 = (unsigned)__cvta_generic_to_shared(smem);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int cv = tid % cv_lanes, row = tid / cv_lanes;
  const bool has_px = row < S;
  const int tiles_x = (W + S - 1) / S, tiles_y = (H + S - 1) / S;
  const int n_tiles = B * tiles_y * tiles_x;
  const int bins = out_h * out_w, nb = 2 * out_h + 2 * out_w;
  const int n_pairs = C / 2;  // channel pairs
  const int row_stride = lay.row_bytes / (int)sizeof(PV);

  while (true) {
    if (tid == 0) *tile_s = atomicAdd(counter, 1);
    __syncthreads();
    const int t = *tile_s;
    if (t >= n_tiles) break;
    const int tx = t % tiles_x, rest = t / tiles_x;
    const int y0 = (rest % tiles_y) * S, x0 = tx * S, b = rest / tiles_y;
    const int y = y0 + row;
    const int* bd_img = bounds + (size_t)b * P * nb;

    // The fm values of this thread's pixels and channels in pass pc; the
    // first pass's loads are in flight while the lists are built.
    float f[S][2];
    auto load_fm = [&](int pc) {
      const bool on = has_px && y < H && pc + cv < n_pairs;
      const T* src = fm + (((size_t)b * H + y) * W + x0) * C + 2 * (pc + cv);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        f[s][0] = f[s][1] = 0.f;
        if (on && x0 + s < W)
          Pair<T>::split(Pair<T>::load(src + s * C), f[s][0], f[s][1]);
      }
    };
    load_fm(0);

    // 1. The boxes whose outer range meets the tile, in ascending order.
    int n_box = 0;
    for (int base = 0; base < P; base += nt) {
      const int p = base + tid;
      bool hit = false;
      if (p < P) {
        const int* bd = bd_img + (size_t)p * nb;
        const int by0 = bd[0], by1 = bd[2 * out_h - 1];
        const int bx0 = bd[2 * out_h], bx1 = bd[nb - 1];
        hit = by0 < by1 && bx0 < bx1 && by0 < y0 + S && by1 > y0 &&
              bx0 < x0 + S && bx1 > x0;
      }
      int total;
      const int at = compact(hit, wcount, total);
      if (hit) box_s[n_box + at] = p;
      n_box += total;
    }
    __syncthreads();  // the box list is complete
    const int n_cand = n_box * bins;

    for (int pc = 0; pc < n_pairs; pc += cv_lanes) {  // channel passes
      const int pass = min(cv_lanes, n_pairs - pc);   // pairs in this pass
      const bool active = has_px && cv < pass;
      if (pc > 0) load_fm(pc);
      float acc[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s][0] = acc[s][1] = 0.f;
      // The pass's units of the pooled and g rows (16 bytes or one pair).
      const int units = pass * (int)sizeof(PV) / kUnit;

      // 2-3. Build the list in rounds of `round` candidates; walk it when
      // it is full or the candidates are done.
      for (int cursor = 0; cursor < n_cand;) {
        int count = 0;
        while (cursor < n_cand && count + round <= cap) {
          const int q = cursor + tid;
          bool hit = false;
          int cell = 0;
          unsigned long long bits = 0;
          if (tid < round && q < n_cand) {
            const int bi = q / bins, k = q - bi * bins;
            const int i = k / out_w, j = k - i * out_w;
            const int p = box_s[bi];
            const int* bd = bd_img + (size_t)p * nb;
            const int ly0 = max(bd[i], y0) - y0;
            const int ly1 = min(bd[out_h + i], y0 + S) - y0;
            const int lx0 = max(bd[2 * out_h + j], x0) - x0;
            const int lx1 = min(bd[2 * out_h + out_w + j], x0 + S) - x0;
            hit = ly0 < ly1 && lx0 < lx1;
            if (hit) {
              // Bit 8 r + s: tile pixel (r, s) lies in the bin.
              const unsigned cols = (0xffu >> (S - lx1)) & (0xffu << lx0);
              bits = ((kRowOnes >> (8 * (S - ly1))) & (kRowOnes << (8 * ly0))) *
                     cols;
              cell = (b * P + p) * bins + k;
            }
          }
          int total;
          const int at = compact(hit, wcount, total);
          if (hit) {
            bits_s[count + at] = bits;
            cell_s[count + at] = cell;
          }
          count += total;
          cursor += round;
        }
        __syncthreads();  // the list is complete

        // Stage the pooled and g rows of list chunk k into buffer k & 1.
        auto stage = [&](int k) {
          const int q0 = k * chunk, n = min(chunk, count - q0);
          const unsigned buf = stage_u32 + (unsigned)((k & 1) * lay.stage_bytes);
          for (int item = tid; item < n * 2 * units; item += nt) {
            const int slot = item / (2 * units), rem = item - slot * 2 * units;
            const int which = rem / units, u = rem - which * units;
            const T* src = (which ? g : pooled) + (size_t)cell_s[q0 + slot] * C +
                           2 * pc + u * (kUnit / (int)sizeof(T));
            cp_async<kUnit>(buf + (unsigned)((slot * 2 + which) *
                                             lay.row_bytes + u * kUnit),
                            src);
          }
        };
        const int n_chunks = (count + chunk - 1) / chunk;
        stage(0);
        cp_async_commit();
        for (int k = 0; k < n_chunks; ++k) {
          if (k + 1 < n_chunks) stage(k + 1);
          cp_async_commit();
          cp_async_wait<1>();  // chunk k's rows have landed
          __syncthreads();
          const PV* sb = reinterpret_cast<const PV*>(smem + (k & 1) *
                                                     lay.stage_bytes);
          const int q0 = k * chunk, q1 = min(count, q0 + chunk);
          if (active) {
            for (int q = q0; q < q1; ++q) {
              // The bin's pixels in this thread's row.
              const unsigned cols = (unsigned)(bits_s[q] >> (8 * row)) & 0xffu;
              if (cols == 0u) continue;
              const int slot = q - q0;
              float p0, p1, g0, g1;
              Pair<T>::split(sb[(2 * slot) * row_stride + cv], p0, p1);
              Pair<T>::split(sb[(2 * slot + 1) * row_stride + cv], g0, g1);
              auto eq_add = [&](int s) {
                if (f[s][0] == p0) acc[s][0] += g0;
                if (f[s][1] == p1) acc[s][1] += g1;
              };
              if (cols == 0xffu) {  // the whole row: no tests
#pragma unroll
                for (int s = 0; s < S; ++s) eq_add(s);
              } else {
#pragma unroll
                for (int s = 0; s < S; ++s)
                  if ((cols >> s) & 1u) eq_add(s);
              }
            }
          }
          __syncthreads();  // buffer k & 1 is free for chunk k + 2
        }
        cp_async_wait<0>();
      }

      if (active && y < H) {
        T* dst = dfm + (((size_t)b * H + y) * W + x0) * C + 2 * (pc + cv);
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (x0 + s < W) Pair<T>::store(dst + s * C, acc[s][0], acc[s][1]);
      }
    }
    __syncthreads();  // the tile's lists and number are free
  }
}

template <typename T>
int launch_bwd(const void* fm, const void* bounds, const void* pooled,
               const void* g, void* dfm, int* counter, int B, int P, int H,
               int W, int C, int out_h, int out_w, int tile, int cv,
               int threads, int cap, int chunk, int round, int copy16,
               int blocks, int smem_bytes, void* stream) {
  const int pair_bytes = (int)sizeof(typename Pair<T>::V);
  const BwdSmem lay(cv, pair_bytes, chunk, cap, P);
  if (tile != kBwdTile || cv < 1 || cv > 32 || threads % 32 ||
      threads > kBwdMaxThreads || threads < cv * kBwdTile || chunk < 1 ||
      round < 1 || round > threads || cap < round || blocks < 1 ||
      smem_bytes < lay.total ||
      (copy16 && (lay.row_bytes != cv * pair_bytes || C * (int)sizeof(T) % 16)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * W == 0) return 0;
  auto kernel = copy16 ? roi_pool_bwd_kernel<T, true>
                       : roi_pool_bwd_kernel<T, false>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc) return rc;
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(fm), static_cast<const int*>(bounds),
      static_cast<const T*>(pooled), static_cast<const T*>(g),
      static_cast<T*>(dfm), counter, B, P, H, W, C, out_h, out_w, cv, cap,
      chunk, round);
  return (int)cudaGetLastError();
}

// fm: [B, H, W, C] contiguous (C even); pooled, g: [B, P, oh, ow, C]; dfm:
// [B, H, W, C]; bounds: int32 [B * P * (2*oh + 2*ow) + 1], the bin bounds
// and, last, the tile counter. The bin bounds (and the counter's zero)
// first, then the kernel, with the plan's schedule.
template <typename T>
int bwd(const void* fm, const void* boxes, const void* mask, void* bounds,
        const void* pooled, const void* g, void* dfm, int B, int P, int H,
        int W, int C, int out_h, int out_w, float scale, int tile, int cv,
        int threads, int cap, int chunk, int round, int copy16, int blocks,
        int smem_bytes, void* stream) {
  int* counter =
      static_cast<int*>(bounds) + (size_t)B * P * (2 * out_h + 2 * out_w);
  const int rc = launch_roi_bounds(boxes, mask, bounds, counter, B, P, H, W,
                                   out_h, out_w, scale, stream);
  return rc ? rc
            : launch_bwd<T>(fm, bounds, pooled, g, dfm, counter, B, P, H, W,
                            C, out_h, out_w, tile, cv, threads, cap, chunk,
                            round, copy16, blocks, smem_bytes, stream);
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
  return launch_roi_bounds(boxes, mask, bounds, nullptr, B, P, H, W, out_h,
                           out_w, scale, stream);
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

// The backward's schedule (ops/roi_pool.py::roi_bwd_plan): tile (its side,
// kBwdTile), cv channel-pair lanes, threads, list capacity cap, stage chunk,
// candidates per round, copy16 (16-byte stage copies), blocks, smem_bytes;
// bounds holds one int more than the table, for the tile counter.
extern "C" int roi_pool_bwd_f32(const void* fm, const void* boxes,
                                const void* mask, void* bounds,
                                const void* pooled, const void* g, void* dfm,
                                int B, int P, int H, int W, int C, int out_h,
                                int out_w, float scale, int tile, int cv,
                                int threads, int cap, int chunk, int round,
                                int copy16, int blocks, int smem_bytes,
                                void* stream) {
  return bwd<float>(fm, boxes, mask, bounds, pooled, g, dfm, B, P, H, W, C,
                    out_h, out_w, scale, tile, cv, threads, cap, chunk, round,
                    copy16, blocks, smem_bytes, stream);
}

extern "C" int roi_pool_bwd_bf16(const void* fm, const void* boxes,
                                 const void* mask, void* bounds,
                                 const void* pooled, const void* g, void* dfm,
                                 int B, int P, int H, int W, int C, int out_h,
                                 int out_w, float scale, int tile, int cv,
                                 int threads, int cap, int chunk, int round,
                                 int copy16, int blocks, int smem_bytes,
                                 void* stream) {
  return bwd<__nv_bfloat16>(fm, boxes, mask, bounds, pooled, g, dfm, B, P, H,
                            W, C, out_h, out_w, scale, tile, cv, threads, cap,
                            chunk, round, copy16, blocks, smem_bytes, stream);
}
