// 3x3 stride-1 pad-1 convolution over NHWC maps for Hopper (sm_90a), as nine
// shifted matrix products with f32 accumulation, in two schedules.
//
//   out[b, y, x, o] = sum over (dy, dx, c) of
//                     x[b, y + dy - 1, x + dx - 1, c] * w[dy, dx, c, o]
//
// with zeros outside the image, all nine taps and all of C summed in f32 and
// rounded once to the output type. x: [B, H, W, C]; out: [B, H, W, O]; C and O
// multiples of 16. The f32 kernels take w as [3, 3, C, O] (HWIO), the bf16
// kernels take it as [3, 3, O, C]: each tap's matrix with the contraction
// innermost, which is what wgmma's shared-memory B operand wants.
//
// conv3x3_fwd_* replaces the TPU kernel cova_tpu/ops/conv3x3.py::_kernel
// (input-stationary): one tile of the input with its halo lies in fast
// memory and the nine taps read it at shifted addresses. The TPU kernel's
// three dx-shifted copies of the padded input in device memory, its row width
// rounded to 8 and its 128-lane channel slots exist to keep its slices
// aligned; none of that is carried over: the input is read as it lies.
//
// conv3x3_roll_fwd_* replaces cova_tpu/ops/conv3x3.py::_roll_kernel
// (output-stationary, forward only): the un-shifted input rows feed three
// products P_j += A_dy * W[dy, j] (j = dx), and the dx shift rides the f32
// sums: out[x] = P_0[x - 1] + P_1[x] + P_2[x + 1].
//
// What bounds them on the H100: at the model's widths (64 -> 64 channels on
// 320 x 320 maps, B = 10) the bf16 product needs about as long on the tensor
// cores (75.5 GFLOP) as its maps need on the memory bus (262 MB); the stem
// (48 -> 256) and the f32 versions are bound by operations.
//
// bf16: what the design does about it. Both kernels are persistent: about
// one block per SM walks a strided list of work items. A block is two
// consumer warpgroups and one producer warp.
//   * Weights stay. Where C fits one chunk of 64 channels, the block's
//     [9, OC, 64] weight chunk is copied into shared memory once (one TMA
//     load) and stays for all of the block's tiles; a block keeps one chunk
//     of output channels for its whole life. Where C needs several chunks
//     (resnet18's 128, 256, 512 channels) the nine taps of all chunks do not
//     fit beside the ring, and each ring stage carries its weight chunk
//     (OC = 32 then) beside its input chunk. The launcher is told which by
//     the launch plan of ops/conv3x3.py, which chooses by shape.
//   * Copies are asynchronous. The producer warp's one thread issues TMA
//     loads (cp.async.bulk.tensor, 4-D map over [B, H, W, C]) into a ring of
//     stages; each load completes on the stage's mbarrier, each consumer
//     warp frees the stage on a second one. The image's zero padding is TMA's
//     out-of-bounds fill at signed coordinates, and so are the channels
//     between C and 64 (the stem's 48): no branch, no padded copy.
//   * Products are wgmma.mma_async m64nNk16 (N = OC = 64, 32 or 16) with A
//     and B read from shared memory by descriptor, in the 128-byte swizzle
//     that TMA wrote: a pixel's 64 channels are one swizzle row.
//   * The epilogue rounds the f32 accumulators and stores from registers,
//     masked at the right and bottom edges, while the next loads fly. The
//     four lanes that share an accumulator row first exchange their channel
//     pairs, so that each stores 16 contiguous bytes: stores of 4-byte pairs
//     fill half of every 32-byte sector they touch, and on this card they
//     alone took as long as the whole kernel does now.
// K7 (conv3x3_fwd_bf16): a tile is 16 x 16 output pixels; its halo (18 x 18
// pixels x 64 channels) is one stage. A warpgroup owns 8 rows of the tile as
// two 8 x 8 sub-tiles (m64 each): the eight row groups of an A descriptor
// are the eight tile rows' 8 consecutive pixels, one halo-row pitch apart
// (the descriptor's stride), and a tap's (dy, dx) shift moves only the
// descriptor's start address. The swizzle is a function of the address bits,
// so a start inside a 1024-byte swizzle atom reads what TMA wrote there.
// K8 (conv3x3_roll_fwd_bf16): a work item is a strip of two output rows (one
// per warpgroup) over the whole width, walked in tiles of 64 columns; a stage
// holds the four input rows of a tile. An A tile is 64 consecutive pixels of
// one input row, never shifted. A tile's three f32 sums meet through an f32
// panel in shared memory: P_0 and P_1 are written one and two rows down,
// P_2 stays in registers, and the tile stores output columns x0 - 1 ..
// x0 + 62. The last two pixels' sums are carried to the next tile of the row
// in two alternating slots, so no margin column is computed twice and the
// only missing neighbours are the image's own zero columns.
//
// f32 runs as FMAs on the CUDA cores (no TF32): a block owns an 8 x 16 tile
// (K7) or 4 rows x 32 input columns (K8), copies its window and weight chunk
// into shared memory with plain loads, and each thread owns 4 pixels x 8
// output channels.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;      // most input or output channels per chunk
constexpr int TH = 8, TW = 16;     // K7: output tile
constexpr int RH = 4, RW = 32;     // K8: output rows, input columns
constexpr int ROUT = RW - 2;       // K8: output columns of a segment

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

// Store 4 consecutive f32 sums (16 bytes).
__device__ inline void store_vec(float* dst, const float* s) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(s);
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
// bf16: TMA ring -> wgmma, persistent blocks.
// ---------------------------------------------------------------------------
constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kBlock = kConsumerWarps * 32 + 32;   // and the producer warp
constexpr int kRow = 128;        // bytes of a swizzle row: 64 bf16 channels
constexpr int kMaxStages = 4;
constexpr int HT = 16, WT = 16;  // K7: output tile (rows, columns)
constexpr int SR = 2, SC = 64;   // K8: rows of a strip, columns of a tile
constexpr int kK7Tx = (HT + 2) * (WT + 2) * kRow;      // bytes of one halo
constexpr int kK7Halo = (kK7Tx + 1023) / 1024 * 1024;  // its stage slot
constexpr int kK8Rows = (SR + 2) * SC * kRow;  // bytes of a tile's input rows

// What the launcher hands the kernel by value.
struct Plan {
  int B, H, W, O;
  int kc, ks;        // channels of a chunk, and its k-steps of 16
  int n_cc, n_oc;    // chunks of C and of O
  int stationary;    // weights stay in shared memory (n_cc == 1)
  int stages;
  int tiles_x, tiles_y;  // K7: tiles of an image; K8: tiles of a row, strips
  int n_items;           // K7: tiles, K8: strips, over the batch
  int n_walkers;         // blocks that share one chunk of O
};

__host__ __device__ inline int weight_bytes(int n) { return 9 * n * kRow; }
__host__ __device__ inline int panel_bytes(int n) {
  return (68 + 66) * (n + 8) * 4;  // K8: P_0's and P_1's panel of a warpgroup
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: rows of 128
// bytes, 8-row groups `sbo` bytes apart. The leading offset is not used by
// this layout. The swizzle acts on address bits, so `addr` may lie anywhere
// on a 16-byte boundary of a region that TMA filled with the same swizzle.
__device__ __forceinline__ uint64_t mma_desc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d += A * B^T for one m64nNk16 step; d in the instruction's register layout:
// d[4 i + {0, 1}] is row 16 (warp % 4) + lane / 4, columns 8 i + 2 (lane % 4)
// + {0, 1}; d[4 i + {2, 3}] the same columns eight rows down.
#define ACC8(d, b)                                                          \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : ACC8(d, 0)
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : ACC8(d, 0), ACC8(d, 8)
        : "l"(a), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
        : "l"(a), "l"(b), "r"(1));
  }
};
#undef ACC8

// A ring position: the stage and the parity its barriers are waited with.
struct Ring {
  int stage;
  uint32_t parity;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      parity ^= 1u;
    }
  }
};

// The block's shared memory, from a 1024-byte boundary: the stationary
// weights (if any), the ring's stages (input, then the stage's weights if
// they stream), `extra` bytes (K8's panels), then the barriers.
struct Smem {
  uint32_t weights, ring, extra, full, empty, wbar;
  int stage_bytes;
};
__device__ __forceinline__ Smem carve(const unsigned char* raw, const Plan& p,
                                      int input_bytes, int n, int extra) {
  Smem s;
  s.weights = (smem_u32(raw) + 1023u) & ~1023u;
  s.ring = s.weights + (p.stationary ? weight_bytes(n) : 0);
  s.stage_bytes = input_bytes + (p.stationary ? 0 : weight_bytes(n));
  s.extra = s.ring + p.stages * s.stage_bytes;
  s.full = s.extra + extra;
  s.empty = s.full + 8 * kMaxStages;
  s.wbar = s.empty + 8 * kMaxStages;
  return s;
}
inline size_t smem_bytes(const Plan& p, int input_bytes, int n, int extra) {
  const int w = weight_bytes(n);
  return 1024 + (size_t)(p.stationary ? w : 0) +
         (size_t)p.stages * (input_bytes + (p.stationary ? 0 : w)) + extra +
         8 * (2 * kMaxStages + 1);
}
__device__ __forceinline__ void init_barriers(const Smem& s, int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(s.full + 8 * i, 1);                // the producer's expect_tx
      mbar_init(s.empty + 8 * i, kConsumerWarps);  // one arrival per warp
    }
    mbar_init(s.wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Round two f32 sums and store them as one 4-byte pair.
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The four lanes of a quad hold, for each of four 8-channel chunks, the
// channel pair 2 (lane % 4) of it (a0 .. a3). Two exchanges later lane j holds
// all 8 channels of chunk j, in order. All 32 lanes must call it.
__device__ __forceinline__ uint4 quad_transpose(uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3,
                                                int j) {
  const bool odd = j & 1, high = j & 2;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? a2 : a3, 1);
  const uint32_t b0 = odd ? r0 : a0, b1 = odd ? a1 : r0;
  const uint32_t b2 = odd ? r1 : a2, b3 = odd ? a3 : r1;
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, high ? b0 : b2, 2);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, high ? b1 : b3, 2);
  return high ? make_uint4(q0, q1, b2, b3) : make_uint4(b0, b1, q0, q1);
}

// Round and store one accumulator row: v[2 i], v[2 i + 1] are this lane's
// channel pair of chunk i of the pixel whose N output channels start at
// `row`. With 32 channels and more the quad's lanes first exchange pairs, so
// that each stores 16 contiguous bytes and a quad whole 32-byte sectors: a
// store of 4-byte pairs fills half of every sector it touches, which the
// memory then has to read, merge and write back. All 32 lanes must call it;
// `ok` masks the store.
template <int N>
__device__ __forceinline__ void store_row(bf16* row, const float (&v)[N / 4],
                                          int lane, bool ok) {
  const int j = lane & 3;
  if constexpr (N >= 32) {
#pragma unroll
    for (int g = 0; g < N / 32; ++g) {
      const uint4 chunk = quad_transpose(
          pack_pair(v[8 * g], v[8 * g + 1]), pack_pair(v[8 * g + 2], v[8 * g + 3]),
          pack_pair(v[8 * g + 4], v[8 * g + 5]),
          pack_pair(v[8 * g + 6], v[8 * g + 7]), j);
      if (ok) *reinterpret_cast<uint4*>(row + (4 * g + j) * 8) = chunk;
    }
  } else {
    if (ok) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        store_pair(row + 8 * i + 2 * j, v[2 * i], v[2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7, bf16: input-stationary. Work item: a 16 x 16 tile of one image.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_fwd_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        bf16* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kK7Halo, N, 0);
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;
  const int wbytes = weight_bytes(N);

  if (warp == kConsumerWarps) {
    // Producer: one thread keeps the ring full.
    if (lane != 0) return;
    if (p.stationary) {
      mbar_expect_tx(sm.wbar, wbytes);
      tma_load_3d(sm.weights, &wmap, sm.wbar, 0, o0, 0);
    }
    Ring r = {0, 1u};  // a fresh barrier passes a wait on parity 1
    for (int item = walker; item < p.n_items; item += p.n_walkers) {
      const int tx = item % p.tiles_x, rest = item / p.tiles_x;
      const int ty = rest % p.tiles_y, b = rest / p.tiles_y;
      for (int cc = 0; cc < p.n_cc; ++cc) {
        mbar_wait(sm.empty + 8 * r.stage, r.parity);
        const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
        const uint32_t full = sm.full + 8 * r.stage;
        mbar_expect_tx(full, kK7Tx + (p.stationary ? 0 : wbytes));
        tma_load_4d(st, &xmap, full, cc * p.kc, tx * WT - 1, ty * HT - 1, b);
        if (!p.stationary) {
          tma_load_3d(st + kK7Halo, &wmap, full, cc * p.kc, o0, 0);
        }
        r.advance(p.stages);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns tile rows 8 wg .. 8 wg + 7 as two 8 x 8
  // sub-tiles (column halves h = 0, 1); accumulator row m of a sub-tile is
  // its pixel (m / 8, m % 8).
  const int wg = warp >> 2, wq = warp & 3;
  if (p.stationary) mbar_wait(sm.wbar, 0u);
  Ring r = {0, 0u};
  for (int item = walker; item < p.n_items; item += p.n_walkers) {
    const int tx = item % p.tiles_x, rest = item / p.tiles_x;
    const int ty = rest % p.tiles_y;
    const long long b = rest / p.tiles_y;
    float acc[2][N / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[h][e] = 0.f;

    for (int cc = 0; cc < p.n_cc; ++cc) {
      mbar_wait(sm.full + 8 * r.stage, r.parity);
      const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
      const uint32_t ws = p.stationary ? sm.weights : st + kK7Halo;
      wgmma_fence();
      for (int k = 0; k < p.ks; ++k) {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int dy = t / 3, dx = t % 3;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Row groups: halo rows 8 wg + dy + (0 .. 7), from pixel 8 h + dx.
            const uint32_t a =
                st + ((8 * wg + dy) * (WT + 2) + 8 * h + dx) * kRow;
            Wgmma<N>::mma(acc[h], mma_desc(a + 32 * k, (WT + 2) * kRow),
                          mma_desc(ws + t * N * kRow + 32 * k, 8 * kRow));
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
      r.advance(p.stages);
    }

    // Epilogue from registers; the next tile's loads are in flight.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * wq + (lane >> 2) + 8 * half;
        const int y = ty * HT + 8 * wg + (m >> 3);
        const int x = tx * WT + 8 * h + (m & 7);
        float v[N / 4];
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          v[2 * i] = acc[h][4 * i + 2 * half];
          v[2 * i + 1] = acc[h][4 * i + 2 * half + 1];
        }
        store_row<N>(out + ((b * p.H + y) * p.W + x) * p.O + o0, v, lane,
                     y < p.H && x < p.W);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8, bf16: output-stationary. Work item: a strip of two output rows of one
// image, walked left to right in tiles of 64 columns.
// ---------------------------------------------------------------------------
// Panel rows. P_0 of tile pixel q - 2 lies in slot q of panel A, P_1 of pixel
// q - 1 in slot q of panel B. Slots below 64 are rows of the panel; slots 64
// and up of tile t are the slots 0 and up of tile t + 1 and lie in one of two
// carry rows sets, by the tile's parity.
__device__ __forceinline__ int panel_a_row(int q, int par) {
  return q < 2 ? 64 + 2 * (par ^ 1) + q : (q < 64 ? q : 64 + 2 * par + q - 64);
}
__device__ __forceinline__ int panel_b_row(int q, int par) {
  return q < 1 ? 64 + (par ^ 1) : (q < 64 ? q : 64 + par);
}

template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_roll_fwd_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             bf16* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kK8Rows, N, 2 * panel_bytes(N));
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;
  const int wbytes = weight_bytes(N);

  if (warp == kConsumerWarps) {
    if (lane != 0) return;
    if (p.stationary) {
      mbar_expect_tx(sm.wbar, wbytes);
      tma_load_3d(sm.weights, &wmap, sm.wbar, 0, o0, 0);
    }
    Ring r = {0, 1u};
    for (int item = walker; item < p.n_items; item += p.n_walkers) {
      const int sy = item % p.tiles_y, b = item / p.tiles_y;
      for (int xt = 0; xt < p.tiles_x; ++xt) {
        for (int cc = 0; cc < p.n_cc; ++cc) {
          mbar_wait(sm.empty + 8 * r.stage, r.parity);
          const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
          const uint32_t full = sm.full + 8 * r.stage;
          mbar_expect_tx(full, kK8Rows + (p.stationary ? 0 : wbytes));
          // Input rows sy * SR - 1 .. + SR, columns xt * SC .. + 63.
          tma_load_4d(st, &xmap, full, cc * p.kc, xt * SC, sy * SR - 1, b);
          if (!p.stationary) {
            tma_load_3d(st + kK8Rows, &wmap, full, cc * p.kc, o0, 0);
          }
          r.advance(p.stages);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns output row sy * SR + wg of the strip.
  const int wg = warp >> 2, wq = warp & 3, tw = threadIdx.x & 127;
  constexpr int PS = N + 8;  // panel row stride in floats: no bank conflicts
  float* pa = reinterpret_cast<float*>(
      const_cast<unsigned char*>(smem_raw) + (sm.extra - smem_u32(smem_raw)) +
      wg * panel_bytes(N));
  float* pb = pa + 68 * PS;
  if (p.stationary) mbar_wait(sm.wbar, 0u);
  Ring r = {0, 0u};
  for (int item = walker; item < p.n_items; item += p.n_walkers) {
    const int sy = item % p.tiles_y;
    const long long b = item / p.tiles_y;
    const int y = sy * SR + wg;
    for (int xt = 0; xt < p.tiles_x; ++xt) {
      float acc[3][N / 2];  // acc[j]: P_j of the tile's 64 input columns
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[j][e] = 0.f;

      for (int cc = 0; cc < p.n_cc; ++cc) {
        mbar_wait(sm.full + 8 * r.stage, r.parity);
        const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
        const uint32_t ws = p.stationary ? sm.weights : st + kK8Rows;
        wgmma_fence();
        for (int k = 0; k < p.ks; ++k) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const uint32_t a = st + (wg + dy) * SC * kRow;  // one input row
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              Wgmma<N>::mma(
                  acc[j], mma_desc(a + 32 * k, 8 * kRow),
                  mma_desc(ws + (dy * 3 + j) * N * kRow + 32 * k, 8 * kRow));
            }
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
        r.advance(p.stages);
      }

      // out[x0 - 1 + q] = P_0[q - 2] + P_1[q - 1] + P_2[q], q = 0 .. 63.
      const int par = xt & 1, x0 = xt * SC;
      if (xt == 0) {  // left of the image every sum is zero
        for (int e = tw; e < 3 * N; e += 128) {
          const int rr = e / N, c = e % N;
          if (rr < 2) {
            pa[panel_a_row(rr, par) * PS + c] = 0.f;
          } else {
            pb[panel_b_row(0, par) * PS + c] = 0.f;
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * wq + (lane >> 2) + 8 * half;
        float* da = pa + panel_a_row(q + 2, par) * PS + 2 * (lane & 3);
        float* db = pb + panel_b_row(q + 1, par) * PS + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          *reinterpret_cast<float2*>(da + 8 * i) = make_float2(
              acc[0][4 * i + 2 * half], acc[0][4 * i + 2 * half + 1]);
          *reinterpret_cast<float2*>(db + 8 * i) = make_float2(
              acc[1][4 * i + 2 * half], acc[1][4 * i + 2 * half + 1]);
        }
      }
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = 16 * wq + (lane >> 2) + 8 * half;
        const int x = x0 - 1 + q;
        const bool ok = y < p.H && x >= 0 && x < p.W;
        const float* sa = pa + panel_a_row(q, par) * PS + 2 * (lane & 3);
        const float* sb = pb + panel_b_row(q, par) * PS + 2 * (lane & 3);
        float v[N / 4];
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          const float2 va = *reinterpret_cast<const float2*>(sa + 8 * i);
          const float2 vb = *reinterpret_cast<const float2*>(sb + 8 * i);
          v[2 * i] = va.x + vb.x + acc[2][4 * i + 2 * half];
          v[2 * i + 1] = va.y + vb.y + acc[2][4 * i + 2 * half + 1];
        }
        store_row<N>(out + ((b * p.H + y) * p.W + x) * p.O + o0, v, lane, ok);
      }
      // The row ends with this tile's last column: its sum lacks only the
      // zero column right of the image.
      if (x0 + SC == p.W && y < p.H && tw < N / 2) {
        const float* sa = pa + panel_a_row(64, par) * PS + 2 * tw;
        const float* sb = pb + panel_b_row(64, par) * PS + 2 * tw;
        store_pair(out + ((b * p.H + y) * p.W + p.W - 1) * p.O + o0 + 2 * tw,
                   sa[0] + sb[0], sa[1] + sb[1]);
      }
      bar_sync(1 + wg, 128);  // the next tile writes the panel again
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// bf16 tensor map with the 128-byte swizzle and zero fill outside the tensor.
int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int N>
int run_bf16(bool roll, const CUtensorMap& xmap, const CUtensorMap& wmap,
             void* out, const Plan& p, size_t smem, void* stream) {
  auto kernel = roll ? conv3x3_roll_fwd_bf16_kernel<N>
                     : conv3x3_fwd_bf16_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_oc * p.n_walkers, kBlock, smem, (cudaStream_t)stream>>>(
      xmap, wmap, static_cast<bf16*>(out), p);
  return (int)cudaGetLastError();
}

// The launch plan (KC, OC, stationary, stages, shared-memory bytes) comes from
// ops/conv3x3.py:launch_plan; it is checked here, not chosen.
int launch_bf16(bool roll, const void* x, const void* wt, void* out, int B,
                int H, int W, int C, int O, int KC, int OC, int stationary,
                int stages, int smem_plan, void* stream) {
  const bool ok =
      B >= 1 && H >= 1 && W >= 1 && C >= 16 && O >= 16 &&
      (KC == 16 || KC == 32 || KC == 48 || KC == 64) && C % KC == 0 &&
      (OC == 16 || OC == 32 || OC == 64) && O % OC == 0 && stages >= 2 &&
      stages <= kMaxStages && (stationary == 0 || (stationary == 1 && C == KC));
  if (!ok) return (int)cudaErrorInvalidValue;
  Plan p;
  p.B = B, p.H = H, p.W = W, p.O = O;
  p.kc = KC, p.ks = KC / 16;
  p.n_cc = C / KC, p.n_oc = O / OC;
  p.stationary = stationary, p.stages = stages;
  p.tiles_x = cdiv(W, roll ? SC : WT);
  p.tiles_y = cdiv(H, roll ? SR : HT);
  const long long items =
      (long long)B * p.tiles_y * (roll ? 1 : p.tiles_x);
  if (items > 0x7fffffffLL || (long long)p.n_oc > 0x3fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  p.n_items = (int)items;
  const int share = sm_count() / p.n_oc;
  p.n_walkers = share < 1 ? 1 : (share < p.n_items ? share : p.n_items);
  const size_t smem = smem_bytes(p, roll ? kK8Rows : kK7Halo, OC,
                                 roll ? 2 * panel_bytes(OC) : 0);
  if (smem != (size_t)smem_plan) return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {64, (cuuint32_t)(roll ? SC : WT + 2),
                            (cuuint32_t)(roll ? SR + 2 : HT + 2), 1};
  int rc = encode(&xmap, x, 4, xd, xs, xb);
  if (rc) return rc;
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)O, 9};
  const cuuint64_t wst[2] = {(cuuint64_t)C * 2, (cuuint64_t)O * C * 2};
  const cuuint32_t wb[3] = {64, (cuuint32_t)OC, 9};
  rc = encode(&wmap, wt, 3, wd, wst, wb);
  if (rc) return rc;
  switch (OC) {
    case 16: return run_bf16<16>(roll, xmap, wmap, out, p, smem, stream);
    case 32: return run_bf16<32>(roll, xmap, wmap, out, p, smem, stream);
    default: return run_bf16<64>(roll, xmap, wmap, out, p, smem, stream);
  }
}

}  // namespace

// f32: x [B, H, W, C], w [3, 3, C, O], out [B, H, W, O], contiguous and
// 16-byte aligned; KC divides C, OC divides O, both multiples of 16 and at
// most 64; B and O / OC at most 65535. Offsets are 64-bit. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a refused shape).
extern "C" int conv3x3_fwd_f32(const void* x, const void* w, void* out, int B,
                               int H, int W, int C, int O, int KC, int OC,
                               void* stream) {
  const size_t tile = (size_t)(TH + 2) * (TW + 2) * chan_stride_f32(KC) * 4 +
                      (size_t)9 * KC * OC * 4;
  return launch<float>(conv3x3_fwd_f32_kernel, tile, cdiv(W, TW), cdiv(H, TH),
                       x, w, out, B, H, W, C, O, KC, OC, stream);
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

// bf16: x [B, H, W, C], wt [3, 3, O, C] (each tap's matrix transposed), out
// [B, H, W, O], contiguous and 16-byte aligned. KC (16, 32, 48 or 64) divides
// C, OC (16, 32 or 64) divides O; `stationary` (only where KC == C) keeps the
// weights in shared memory, else each of the `stages` ring stages carries
// its weight chunk; `smem` is the plan's shared-memory size and must equal
// the kernel's own count. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a refused plan), 20001 if libcuda lacks
// cuTensorMapEncodeTiled, or 30000 + the CUresult of a refused tensor map.
extern "C" int conv3x3_fwd_bf16(const void* x, const void* wt, void* out,
                                int B, int H, int W, int C, int O, int KC,
                                int OC, int stationary, int stages, int smem,
                                void* stream) {
  return launch_bf16(false, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                     stages, smem, stream);
}

extern "C" int conv3x3_roll_fwd_bf16(const void* x, const void* wt, void* out,
                                     int B, int H, int W, int C, int O, int KC,
                                     int OC, int stationary, int stages,
                                     int smem, void* stream) {
  return launch_bf16(true, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                     stages, smem, stream);
}
