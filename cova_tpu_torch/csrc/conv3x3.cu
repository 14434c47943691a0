// 3x3 stride-1 pad-1 convolution over NHWC maps for Hopper (sm_90a), as nine
// shifted matrix products with f32 accumulation, in two schedules.
//
//   out[b, y, x, o] = sum over (dy, dx, c) of
//                     x[b, y + dy - 1, x + dx - 1, c] * w[dy, dx, c, o]
//
// with zeros outside the image, all nine taps and all of C summed in f32 and
// rounded once to the output type. x: [B, H, W, C]; w: [3, 3, C, O] (HWIO);
// out: [B, H, W, O]; C and O multiples of 16.
//
// conv3x3_fwd_* replaces the TPU kernel cova_tpu/ops/conv3x3.py::_kernel
// (input-stationary). A block owns an 8 x 16 tile of output pixels of one
// image and a chunk of at most 64 output channels. Per chunk of at most 64
// input channels it copies the tile's halo (10 x 18 pixels, zeros outside
// the image) and the weight chunk [9, KC, OC] into shared memory; each of
// the nine taps is then a product whose A operand is the same shared tile
// read at a shifted base address. The TPU kernel's three dx-shifted copies
// of the padded input in device memory, its row width rounded to 8 and its
// 128-lane channel slots exist to keep its slices aligned; none of that is
// carried over: the input is read as it lies, and the shift is an address.
//
// conv3x3_roll_fwd_* replaces cova_tpu/ops/conv3x3.py::_roll_kernel
// (output-stationary, forward only). A block owns 4 output rows and a
// segment of 32 input columns. For each dy it reads the un-shifted input
// rows and accumulates the three un-shifted products P_j += A_dy * W[dy, j]
// (j = dx) in registers; the dx shift rides the f32 output: P_j[r] is added
// into an f32 panel in shared memory at pixel r - (j - 1). A segment's first
// and last pixel are a margin (their sums lack a neighbour), so it yields 30
// output columns, and each image row has its own panel row: a shifted add
// cannot wrap into the next row, as it can in the TPU kernel's flattened
// layout with its 8-row roll margin.
//
// bf16 runs on the tensor cores through nvcuda::wmma (m16n16k16, f32
// accumulators): one warp per output row of the tile (K7) or per 16-pixel
// half of a row (K8). The shared tile's channel stride is padded to a
// multiple of 16 elements, so every fragment base is 32-byte aligned, and
// kept off multiples of 64, so that rows do not all start in one bank. f32
// runs as FMAs on the CUDA cores (no TF32): each thread owns 4 pixels x 8
// output channels.
//
// What bounds it on the H100: at the model's widths (64 -> 64 channels on
// 320 x 320 maps) the bf16 product needs about as long on the tensor cores
// (75.5 GFLOP at B = 10) as its maps need on the memory bus (262 MB); the
// stem (48 -> 256) and the f32 versions are bound by operations. These
// kernels re-read the weight chunk for every tile from L2 and do not overlap
// copies with products; wgmma, TMA and a pipeline are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;      // most input or output channels per chunk
constexpr int TH = 8, TW = 16;     // K7: output tile
constexpr int RH = 4, RW = 32;     // K8: output rows, input columns
constexpr int ROUT = RW - 2;       // K8: output columns of a segment

// Channel stride of the shared input tile, in elements.
__host__ __device__ inline int chan_stride_bf16(int kc) {
  int cs = kc + 16;
  if (cs % 64 == 0) cs += 16;
  return cs;
}
__host__ __device__ inline int chan_stride_f32(int kc) { return kc + 4; }

// Copy channels [c0, c0 + kc) of a rows x cols pixel window whose corner is
// (y0, x0) into xs[pixel][cs], with zeros outside the image.
template <typename T>
__device__ void load_window(T* xs, const T* __restrict__ img, int H, int W,
                            int C, int y0, int x0, int rows, int cols,
                            int c0, int kc, int cs) {
  constexpr int V = 16 / sizeof(T);
  const int vec = kc / V;
  const int n = rows * cols * vec;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = i % vec;
    const int p = i / vec;
    const int gy = y0 + p / cols, gx = x0 + p % cols;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = *reinterpret_cast<const uint4*>(
          img + ((long long)gy * W + gx) * C + c0 + v * V);
    }
    *reinterpret_cast<uint4*>(xs + p * cs + v * V) = val;
  }
}

// Copy w[:, :, c0 : c0 + kc, o0 : o0 + oc] into ws[tap][k][wstride].
template <typename T>
__device__ void load_weights(T* ws, const T* __restrict__ w, int C, int O,
                             int c0, int kc, int o0, int oc, int wstride) {
  constexpr int V = 16 / sizeof(T);
  const int vec = oc / V;
  const int n = 9 * kc * vec;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = i % vec;
    const int k = (i / vec) % kc;
    const int t = i / (vec * kc);
    *reinterpret_cast<uint4*>(ws + (t * kc + k) * wstride + v * V) =
        *reinterpret_cast<const uint4*>(
            w + ((long long)(t * C + c0 + k)) * O + o0 + v * V);
  }
}

// Round 8 (bf16) or 4 (f32) consecutive f32 sums to T and store 16 bytes.
__device__ inline void store_vec(bf16* dst, const float* s) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    h[q] = __floats2bfloat162_rn(s[2 * q], s[2 * q + 1]);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}
__device__ inline void store_vec(float* dst, const float* s) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(s);
}

// ---------------------------------------------------------------------------
// K7, bf16: input-stationary, tensor cores.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ out, int H, int W, int C, int O,
                        int KC, int OC, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int CS = chan_stride_bf16(KC), WS = OC + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + (TH + 2) * (TW + 2) * CS;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int o0 = blockIdx.y * OC;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5;  // the tile row this warp computes
  const int NF = OC / 16;
  const bf16* img = x + b * H * W * C;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) wmma::fill_fragment(acc[nf], 0.f);

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();  // the previous chunk's products have read xs and ws
    load_window(xs, img, H, W, C, y0 - 1, x0 - 1, TH + 2, TW + 2, c0, KC, CS);
    load_weights(ws, w, C, O, c0, KC, o0, OC, WS);
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      const bf16* a_base = xs + ((warp + dy) * (TW + 2) + dx) * CS;
      const bf16* b_base = ws + t * KC * WS;
      for (int k0 = 0; k0 < KC; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_base + k0, CS);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          if (nf < NF) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
            wmma::load_matrix_sync(bm, b_base + k0 * WS + nf * 16, WS);
            wmma::mma_sync(acc[nf], a, bm, acc[nf]);
          }
        }
      }
    }
  }
  __syncthreads();

  // The sums go through shared memory, so that the ragged right and bottom
  // edges can be masked and each lane stores 16 contiguous bytes.
  const int SS = OC + 8;
  float* st = reinterpret_cast<float*>(smem) + warp * 16 * SS;
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) {
    if (nf < NF) {
      wmma::store_matrix_sync(st + nf * 16, acc[nf], SS, wmma::mem_row_major);
    }
  }
  __syncwarp();
  const int y = y0 + warp;
  if (y >= H) return;
  const int vec = OC / 8, lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * vec; i += 32) {
    const int m = i / vec, v = i % vec;
    const int gx = x0 + m;
    if (gx < W) {
      store_vec(out + ((b * H + y) * W + gx) * O + o0 + v * 8,
                st + m * SS + v * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// K7, f32: input-stationary, FMAs. Thread = 4 pixels of a row x 8 outputs.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, int H, int W, int C, int O,
                       int KC, int OC, int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int CS = chan_stride_f32(KC), WS = OC;
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + (TH + 2) * (TW + 2) * CS;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int o0 = blockIdx.y * OC;
  const long long b = blockIdx.z;
  const int pg = threadIdx.x >> 3;
  const int row = pg >> 2, col0 = (pg & 3) * 4;
  const int oo = (threadIdx.x & 7) * 8;
  const bool active = oo < OC;
  const float* img = x + b * H * W * C;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();
    load_window(xs, img, H, W, C, y0 - 1, x0 - 1, TH + 2, TW + 2, c0, KC, CS);
    load_weights(ws, w, C, O, c0, KC, o0, OC, WS);
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3, dx = t % 3;
      const float* xa = xs + ((row + dy) * (TW + 2) + col0 + dx) * CS;
      const float* wb = ws + t * KC * WS + oo;
      for (int k = 0; k < KC; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wb + k * WS);
        const float4 w1 = *reinterpret_cast<const float4*>(wb + k * WS + 4);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float xv = xa[p * CS + k];
          acc[p][0] = fmaf(xv, w0.x, acc[p][0]);
          acc[p][1] = fmaf(xv, w0.y, acc[p][1]);
          acc[p][2] = fmaf(xv, w0.z, acc[p][2]);
          acc[p][3] = fmaf(xv, w0.w, acc[p][3]);
          acc[p][4] = fmaf(xv, w1.x, acc[p][4]);
          acc[p][5] = fmaf(xv, w1.y, acc[p][5]);
          acc[p][6] = fmaf(xv, w1.z, acc[p][6]);
          acc[p][7] = fmaf(xv, w1.w, acc[p][7]);
        }
      }
    }
  }
  const int y = y0 + row;
  if (!active || y >= H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int gx = x0 + col0 + p;
    if (gx < W) {
      float* dst = out + ((b * H + y) * W + gx) * O + o0 + oo;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
  }
}

// K8's epilogue: round the panel's complete sums (slots 2 .. RW - 1 of each
// row) and store them, masked at the image's right and bottom edges.
template <typename T>
__device__ void store_panel(const float* panel, int PS, T* __restrict__ out,
                            long long b, int H, int W, int O, int y0,
                            int xo0, int o0, int OC) {
  constexpr int V = 16 / sizeof(T);
  const int vec = OC / V;
  const int n = RH * ROUT * vec;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int v = i % vec;
    const int q = (i / vec) % ROUT;
    const int r = i / (vec * ROUT);
    const int y = y0 + r, gx = xo0 + q;
    if (y < H && gx < W) {
      store_vec(out + ((b * H + y) * W + gx) * O + o0 + v * V,
                panel + (r * (RW + 2) + q + 2) * PS + v * V);
    }
  }
}

// ---------------------------------------------------------------------------
// K8, bf16: output-stationary, tensor cores. Warp = (row, 16-pixel half).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
conv3x3_roll_fwd_bf16_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ w, bf16* __restrict__ out,
                             int H, int W, int C, int O, int KC, int OC,
                             int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int CS = chan_stride_bf16(KC), WS = OC + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = xs + (RH + 2) * RW * CS;
  const int y0 = (blockIdx.x / tiles_x) * RH;
  const int xo0 = (blockIdx.x % tiles_x) * ROUT;  // first output column
  const int o0 = blockIdx.y * OC;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int row = warp >> 1, mf = warp & 1;
  const int NF = OC / 16;
  const bf16* img = x + b * H * W * C;

  // acc[j][nf]: P_j = sum over dy and c of A_dy * W[dy, j].
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) wmma::fill_fragment(acc[j][nf], 0.f);

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();
    // Segment pixel r is input column xo0 - 1 + r: un-shifted rows.
    load_window(xs, img, H, W, C, y0 - 1, xo0 - 1, RH + 2, RW, c0, KC, CS);
    load_weights(ws, w, C, O, c0, KC, o0, OC, WS);
    __syncthreads();
    for (int dy = 0; dy < 3; ++dy) {
      const bf16* a_base = xs + ((row + dy) * RW + mf * 16) * CS;
      for (int k0 = 0; k0 < KC; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_base + k0, CS);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const bf16* b_base = ws + ((dy * 3 + j) * KC + k0) * WS;
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) {
            if (nf < NF) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                  bm;
              wmma::load_matrix_sync(bm, b_base + nf * 16, WS);
              wmma::mma_sync(acc[j][nf], a, bm, acc[j][nf]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // The shift on the output side: P_j[r] belongs to segment pixel
  // r - (j - 1), panel slot r + 2 - j. Within one pass the two halves of a
  // row touch disjoint slots; passes are separated by a barrier. The first
  // pass stores, so the panel needs no zero fill.
  const int PS = OC + 8;
  float* panel = reinterpret_cast<float*>(smem);  // [RH][RW + 2][PS]
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int j = pass == 0 ? 1 : (pass == 1 ? 0 : 2);
    float* dst = panel + (row * (RW + 2) + mf * 16 + 2 - j) * PS;
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      if (nf < NF) {
        if (pass > 0) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          wmma::load_matrix_sync(c, dst + nf * 16, PS, wmma::mem_row_major);
#pragma unroll
          for (int e = 0; e < c.num_elements; ++e) acc[j][nf].x[e] += c.x[e];
        }
        wmma::store_matrix_sync(dst + nf * 16, acc[j][nf], PS,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();
  }
  store_panel(panel, PS, out, b, H, W, O, y0, xo0, o0, OC);
}

// ---------------------------------------------------------------------------
// K8, f32: output-stationary, FMAs. Thread = 4 pixels of a row x 8 outputs.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
conv3x3_roll_fwd_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w, float* __restrict__ out,
                            int H, int W, int C, int O, int KC, int OC,
                            int tiles_x) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int CS = chan_stride_f32(KC), WS = OC;
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = xs + (RH + 2) * RW * CS;
  const int y0 = (blockIdx.x / tiles_x) * RH;
  const int xo0 = (blockIdx.x % tiles_x) * ROUT;
  const int o0 = blockIdx.y * OC;
  const long long b = blockIdx.z;
  const int pg = threadIdx.x >> 3;
  const int row = pg >> 3, col0 = (pg & 7) * 4;
  const int oo = (threadIdx.x & 7) * 8;
  const bool active = oo < OC;
  const float* img = x + b * H * W * C;

  float acc[3][4][8];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][p][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();
    load_window(xs, img, H, W, C, y0 - 1, xo0 - 1, RH + 2, RW, c0, KC, CS);
    load_weights(ws, w, C, O, c0, KC, o0, OC, WS);
    __syncthreads();
    if (!active) continue;
    for (int dy = 0; dy < 3; ++dy) {
      const float* xa = xs + ((row + dy) * RW + col0) * CS;
      for (int k = 0; k < KC; ++k) {
        float xv[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) xv[p] = xa[p * CS + k];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float* wb = ws + ((dy * 3 + j) * KC + k) * WS + oo;
          const float4 w0 = *reinterpret_cast<const float4*>(wb);
          const float4 w1 = *reinterpret_cast<const float4*>(wb + 4);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[j][p][0] = fmaf(xv[p], w0.x, acc[j][p][0]);
            acc[j][p][1] = fmaf(xv[p], w0.y, acc[j][p][1]);
            acc[j][p][2] = fmaf(xv[p], w0.z, acc[j][p][2]);
            acc[j][p][3] = fmaf(xv[p], w0.w, acc[j][p][3]);
            acc[j][p][4] = fmaf(xv[p], w1.x, acc[j][p][4]);
            acc[j][p][5] = fmaf(xv[p], w1.y, acc[j][p][5]);
            acc[j][p][6] = fmaf(xv[p], w1.z, acc[j][p][6]);
            acc[j][p][7] = fmaf(xv[p], w1.w, acc[j][p][7]);
          }
        }
      }
    }
  }
  __syncthreads();

  const int PS = OC;
  float* panel = reinterpret_cast<float*>(smem);  // [RH][RW + 2][PS]
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int j = pass == 0 ? 1 : (pass == 1 ? 0 : 2);
    if (active) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float* dst = panel + (row * (RW + 2) + col0 + p + 2 - j) * PS + oo;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e] = pass == 0 ? acc[j][p][e] : dst[e] + acc[j][p][e];
        }
      }
    }
    __syncthreads();
  }
  store_panel(panel, PS, out, b, H, W, O, y0, xo0, o0, OC);
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

bool chunks_ok(int B, int H, int W, int C, int O, int KC, int OC) {
  return B >= 1 && H >= 1 && W >= 1 && KC >= 16 && KC <= kMaxChunk &&
         KC % 16 == 0 && C % KC == 0 && OC >= 16 && OC <= kMaxChunk &&
         OC % 16 == 0 && O % OC == 0 && O / OC <= 65535 && B <= 65535;
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, T*, int, int, int, int, int, int,
                          int),
           size_t smem, int tiles_x, int tiles_y, const void* x, const void* w,
           void* out, int B, int H, int W, int C, int O, int KC, int OC,
           void* stream) {
  if (!chunks_ok(B, H, W, C, O, KC, OC)) return (int)cudaErrorInvalidValue;
  // Above 48 KB a block's shared memory has to be asked for.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)(O / OC), (unsigned)B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      H, W, C, O, KC, OC, tiles_x);
  return (int)cudaGetLastError();
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// All four: x [B, H, W, C], w [3, 3, C, O], out [B, H, W, O], contiguous and
// 16-byte aligned; KC divides C, OC divides O, both multiples of 16 and at
// most 64; B and O / OC at most 65535. Offsets are 64-bit. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a refused shape).
extern "C" int conv3x3_fwd_bf16(const void* x, const void* w, void* out, int B,
                                int H, int W, int C, int O, int KC, int OC,
                                void* stream) {
  const size_t tile = (size_t)(TH + 2) * (TW + 2) * chan_stride_bf16(KC) * 2 +
                      (size_t)9 * KC * (OC + 8) * 2;
  const size_t stage = (size_t)(kThreads / 32) * 16 * (OC + 8) * 4;
  return launch<bf16>(conv3x3_fwd_bf16_kernel, max_sz(tile, stage),
                      cdiv(W, TW), cdiv(H, TH), x, w, out, B, H, W, C, O, KC,
                      OC, stream);
}

extern "C" int conv3x3_fwd_f32(const void* x, const void* w, void* out, int B,
                               int H, int W, int C, int O, int KC, int OC,
                               void* stream) {
  const size_t tile = (size_t)(TH + 2) * (TW + 2) * chan_stride_f32(KC) * 4 +
                      (size_t)9 * KC * OC * 4;
  return launch<float>(conv3x3_fwd_f32_kernel, tile, cdiv(W, TW), cdiv(H, TH),
                       x, w, out, B, H, W, C, O, KC, OC, stream);
}

extern "C" int conv3x3_roll_fwd_bf16(const void* x, const void* w, void* out,
                                     int B, int H, int W, int C, int O, int KC,
                                     int OC, void* stream) {
  const size_t tile = (size_t)(RH + 2) * RW * chan_stride_bf16(KC) * 2 +
                      (size_t)9 * KC * (OC + 8) * 2;
  const size_t panel = (size_t)RH * (RW + 2) * (OC + 8) * 4;
  return launch<bf16>(conv3x3_roll_fwd_bf16_kernel, max_sz(tile, panel),
                      cdiv(W, ROUT), cdiv(H, RH), x, w, out, B, H, W, C, O, KC,
                      OC, stream);
}

extern "C" int conv3x3_roll_fwd_f32(const void* x, const void* w, void* out,
                                    int B, int H, int W, int C, int O, int KC,
                                    int OC, void* stream) {
  const size_t tile = (size_t)(RH + 2) * RW * chan_stride_f32(KC) * 4 +
                      (size_t)9 * KC * OC * 4;
  const size_t panel = (size_t)RH * (RW + 2) * OC * 4;
  return launch<float>(conv3x3_roll_fwd_f32_kernel, max_sz(tile, panel),
                       cdiv(W, ROUT), cdiv(H, RH), x, w, out, B, H, W, C, O,
                       KC, OC, stream);
}
