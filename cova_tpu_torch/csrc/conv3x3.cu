// 3x3 stride-1 pad-1 convolution over NHWC maps for Hopper (sm_90a), as nine
// shifted matrix products with f32 accumulation, in two schedules.
//
//   out[b, y, x, o] = sum over (dy, dx, c) of
//                     x[b, y + dy - 1, x + dx - 1, c] * w[dy, dx, c, o]
//
// with zeros outside the image, all nine taps and all of C summed in f32 and
// rounded once to the output type. x: [B, H, W, C]; out: [B, H, W, O]; C and O
// multiples of 16. The kernels take w as [3, 3, O, C]: each tap's matrix with
// the contraction innermost, which is what wgmma's shared-memory B operand
// wants (f32: C padded to a multiple of 32 and permuted inside each 32-channel
// chunk, see load_a).
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
// (48 -> 256) is bound by operations. In f32 the tensor cores take TF32,
// which keeps 10 of f32's 23 mantissa bits: one pass misses f32 by about
// 3e-4 of the largest output. The f32 kernels run split TF32: each operand
// is v = hi + lo (hi = v rounded to TF32 to nearest, lo = v - hi), and
// hi * hi + hi * lo + lo * hi is summed in f32 (lo * lo is below f32's last
// bit). Three passes at 495 TFLOP/s bound them by operations, 2.5x below the
// 67 TFLOP/s of FMAs on the CUDA cores.
//
// What the design does about it. All four kernels are persistent: about one
// block per SM walks a strided list of work items. A block is two consumer
// warpgroups and one producer warp.
//   * Weights stay. Where all of C fits beside the ring (bf16: C in one chunk
//     of 64 channels; f32: the hi and lo planes of every 32-channel chunk), a
//     block copies its output chunk's weights into shared memory once (TMA)
//     and keeps them for all its tiles; a block keeps one chunk of output
//     channels for its whole life. Else each ring stage carries its weight
//     chunk beside its input chunk. The launcher is told which by the launch
//     plan of ops/conv3x3.py, which chooses by shape.
//   * Copies are asynchronous. The producer warp's one thread issues TMA
//     loads (cp.async.bulk.tensor, 4-D map over [B, H, W, C]) into a ring of
//     stages; each load completes on the stage's mbarrier, each consumer
//     warp frees the stage on a second one. The image's zero padding is TMA's
//     out-of-bounds fill at signed coordinates, and so are the channels
//     between C and the chunk's end (the stem's 48): no branch, no padded copy.
//   * Products are wgmma.mma_async: bf16 m64nNk16 with A and B read from
//     shared memory by descriptor, in the 128-byte swizzle that TMA wrote (a
//     pixel's 64 channels are one swizzle row); f32 m64nNk8.tf32 with B by
//     descriptor (a pixel's 32 channels are one swizzle row) and A from
//     registers.
//   * f32: the weights are split once where they stay (in the block's
//     prologue) or once per stage where they stream, by the consumers, into a
//     hi plane (in place) and a lo plane in the same layout. The pixels are
//     split in registers: a thread loads its A fragment of a tap from the
//     stage (two 16-byte reads per pixel row, no bank conflict), rounds it,
//     and issues hi * B_hi, hi * B_lo and lo * B_hi, so the ring holds one
//     copy of the input. The next tap's fragment is split while this tap's
//     products run (two fragments in flight, wgmma.wait_group 1).
//   * f32: the tensor cores add products into their f32 accumulator with
//     truncation, so a long run of products drifts (with one accumulator
//     per tile, K7 left the 1e-5 tolerance at 512 channels): the kernels sum
//     short runs of products in fresh accumulators and add those with
//     rounded f32 adds (see k7_stage).
//   * The epilogue stores from registers, masked at the right and bottom
//     edges, while the next loads fly. The four lanes that share an
//     accumulator row first exchange values, so that each stores 16
//     contiguous bytes: stores of 4-byte bf16 pairs fill half of every
//     32-byte sector they touch, and on this card they alone took as long as
//     the whole bf16 kernel does now.
// K7 (conv3x3_fwd_*): a tile is 16 x 16 output pixels (bf16) or 16 x 8
// (f32, where the hi and lo weights leave room for halos of 18 x 10); its
// halo is one stage. A warpgroup owns 8 rows of the tile as 8 x 8 sub-tiles
// (m64 each): two in bf16, one in f32. The eight row groups of an A
// descriptor are the eight tile rows' 8 consecutive pixels, one halo-row
// pitch apart (the descriptor's stride), and a tap's (dy, dx) shift moves
// only the descriptor's start address. The swizzle is a function of the
// address bits, so a start inside a 1024-byte swizzle atom reads what TMA
// wrote there; the f32 kernel's loads apply the same function.
// K8 (conv3x3_roll_fwd_*): a work item is a strip of two output rows (one
// per warpgroup) over the whole width, walked in tiles of 64 columns; a stage
// holds the four input rows of a tile. An A tile is 64 consecutive pixels of
// one input row, never shifted. A tile's three f32 sums meet through an f32
// panel in shared memory: P_0 and P_1 are written one and two rows down,
// P_2 stays in registers, and the tile stores output columns x0 - 1 ..
// x0 + 62. The last two pixels' sums are carried to the next tile of the row
// in two alternating slots, so no margin column is computed twice and the
// only missing neighbours are the image's own zero columns. In f32 its output
// chunk is 16 wide: at 32 the panels do not fit beside the weights.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kConsumerWarps = 8;                  // two warpgroups
constexpr int kBlock = kConsumerWarps * 32 + 32;   // and the producer warp
constexpr int kRow = 128;   // bytes of a swizzle row: 64 bf16 or 32 f32 values
constexpr int kF32Chunk = kRow / 4;  // f32 channels of a chunk
constexpr int kMaxStages = 4;
constexpr int HT = 16, WT = 16;  // K7: output tile (rows, columns)
constexpr int WT32 = 8;          // K7 f32: columns of its 16 x 8 tile
constexpr int SR = 2, SC = 64;   // K8: rows of a strip, columns of a tile
constexpr int slot(int bytes) { return (bytes + 1023) / 1024 * 1024; }
constexpr int kK7Tx = (HT + 2) * (WT + 2) * kRow;      // bytes of one halo
constexpr int kK7Halo = slot(kK7Tx);                   // its stage slot
constexpr int kF7Tx = (HT + 2) * (WT32 + 2) * kRow;    // f32: 18 x 10 halo
constexpr int kF7Halo = slot(kF7Tx);
constexpr int kK8Rows = (SR + 2) * SC * kRow;  // bytes of a tile's input rows
constexpr int kSplitBar = 3;  // named barrier of the 256 consumer threads

// What the launcher hands the kernel by value.
struct Plan {
  int B, H, W, O;
  int kc, ks;        // channels of a chunk, and its k-steps of 32 bytes
  int n_cc, n_oc;    // chunks of C and of O
  int stationary;    // weights stay in shared memory
  int stages;
  int tiles_x, tiles_y;  // K7: tiles of an image; K8: tiles of a row, strips
  int n_items;           // K7: tiles, K8: strips, over the batch
  int n_walkers;         // blocks that share one chunk of O
  int half_last;         // f32: the last chunk holds 16 channels (2 k-steps)
};

// Bytes of one chunk's weights for n output channels, one plane.
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
// Returns once at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// d += A * B^T for one m64nNk16 (bf16) or m64nNk8 (tf32) step; d in the
// instruction's register layout: d[4 i + {0, 1}] is row 16 (warp % 4) +
// lane / 4, columns 8 i + 2 (lane % 4) + {0, 1}; d[4 i + {2, 3}] the same
// columns eight rows down. tf32's A comes from registers (see load_a), and
// with add = 0 it writes d = A * B^T.
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
  static __device__ __forceinline__ void tf32(float (&d)[8], const uint32_t* a,
                                              uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
        "}\n"
        : ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
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
  static __device__ __forceinline__ void tf32(float (&d)[16],
                                              const uint32_t* a, uint64_t b,
                                              int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : ACC8(d, 0), ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
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
// weights (if any: `planes` planes of n_cc chunks), the ring's stages (input,
// then the stage's weight planes if they stream), `extra` bytes (K8's
// panels), then the barriers. A plane of a chunk is [9 taps][n rows][128 B].
struct Smem {
  uint32_t weights, ring, extra, full, empty, wbar;
  int stage_bytes;
};
__device__ __forceinline__ Smem carve(const unsigned char* raw, const Plan& p,
                                      int input_bytes, int n, int extra,
                                      int planes) {
  const int w = planes * weight_bytes(n);
  Smem s;
  s.weights = (smem_u32(raw) + 1023u) & ~1023u;
  s.ring = s.weights + (p.stationary ? p.n_cc * w : 0);
  s.stage_bytes = input_bytes + (p.stationary ? 0 : w);
  s.extra = s.ring + p.stages * s.stage_bytes;
  s.full = s.extra + extra;
  s.empty = s.full + 8 * kMaxStages;
  s.wbar = s.empty + 8 * kMaxStages;
  return s;
}
inline size_t smem_bytes(const Plan& p, int input_bytes, int n, int extra,
                         int planes) {
  const size_t w = (size_t)planes * weight_bytes(n);
  return 1024 + (p.stationary ? p.n_cc * w : 0) +
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

// The producer warp's one thread. It loads the stationary weights once
// (every chunk of C), then keeps the ring full: per work step and chunk of C
// one stage, the input box whose corner is (x, y) of image b (K7: one step,
// its tile's halo; K8: the strip's tiles, left to right) and, where the
// weights stream, the chunk's weights `input_slot` bytes behind it.
__device__ __forceinline__ void produce(const Smem& sm, const Plan& p,
                                        const CUtensorMap* xmap,
                                        const CUtensorMap* wmap, int o0,
                                        int walker, int wbytes, int box_bytes,
                                        int input_slot, bool roll, int tw) {
  if (p.stationary) {
    mbar_expect_tx(sm.wbar, p.n_cc * wbytes);
    for (int cc = 0; cc < p.n_cc; ++cc) {
      tma_load_3d(sm.weights + cc * wbytes, wmap, sm.wbar, cc * p.kc, o0, 0);
    }
  }
  Ring r = {0, 1u};  // a fresh barrier passes a wait on parity 1
  for (int item = walker; item < p.n_items; item += p.n_walkers) {
    int b, x, y;
    if (roll) {
      b = item / p.tiles_y;
      y = (item % p.tiles_y) * SR - 1;
      x = 0;
    } else {
      const int rest = item / p.tiles_x;
      b = rest / p.tiles_y;
      y = (rest % p.tiles_y) * HT - 1;
      x = (item % p.tiles_x) * tw - 1;
    }
    const int steps = roll ? p.tiles_x : 1;
    for (int s = 0; s < steps; ++s, x += SC) {
      for (int cc = 0; cc < p.n_cc; ++cc) {
        mbar_wait(sm.empty + 8 * r.stage, r.parity);
        const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
        const uint32_t full = sm.full + 8 * r.stage;
        mbar_expect_tx(full, box_bytes + (p.stationary ? 0 : wbytes));
        tma_load_4d(st, xmap, full, cc * p.kc, x, y, b);
        if (!p.stationary) {
          tma_load_3d(st + input_slot, wmap, full, cc * p.kc, o0, 0);
        }
        r.advance(p.stages);
      }
    }
  }
}

// Round two f32 sums and store them as one 4-byte pair; f32: one 8-byte pair.
__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
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
// f32: for each two chunks i0 = 2 g, i1 = 2 g + 1, an even lane j gives its
// pair of i1 to lane j + 1 and takes that lane's pair of i0: it then holds
// channels 8 i0 + 2 j .. + 3, and lane j + 1 channels 8 i1 + 2 j .. + 3.
template <int N>
__device__ __forceinline__ void store_row(float* row, const float (&v)[N / 4],
                                          int lane, bool ok) {
  const int j = lane & 3;
  const bool odd = j & 1;
#pragma unroll
  for (int g = 0; g < N / 16; ++g) {
    const int i0 = 2 * g, i1 = 2 * g + 1;
    const float s0 =
        __shfl_xor_sync(0xffffffffu, odd ? v[2 * i0] : v[2 * i1], 1);
    const float s1 =
        __shfl_xor_sync(0xffffffffu, odd ? v[2 * i0 + 1] : v[2 * i1 + 1], 1);
    const float4 q = odd ? make_float4(s0, s1, v[2 * i1], v[2 * i1 + 1])
                         : make_float4(v[2 * i0], v[2 * i0 + 1], s0, s1);
    if (ok) {
      *reinterpret_cast<float4*>(
          row + (odd ? 8 * i1 + 2 * (j - 1) : 8 * i0 + 2 * j)) = q;
    }
  }
}

// Store an 8 x 8 sub-tile of output pixels from its accumulators (row m is
// pixel (m / 8, m % 8) from (y0, x0)), masked at the image's edges.
template <int N, typename T>
__device__ __forceinline__ void store_subtile(T* __restrict__ out,
                                              const float (&acc)[N / 2],
                                              const Plan& p, long long b,
                                              int y0, int x0, int o0, int wq,
                                              int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = 16 * wq + (lane >> 2) + 8 * half;
    const int y = y0 + (m >> 3), x = x0 + (m & 7);
    float v[N / 4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      v[2 * i] = acc[4 * i + 2 * half];
      v[2 * i + 1] = acc[4 * i + 2 * half + 1];
    }
    store_row<N>(out + ((b * p.H + y) * p.W + x) * p.O + o0, v, lane,
                 y < p.H && x < p.W);
  }
}

// ---------------------------------------------------------------------------
// Split TF32.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// v rounded to TF32, to nearest with ties away from zero: the f32 bit
// pattern with its low 13 bits zero. For finite v these are the bits of
// cvt.rna.tf32.f32, in two integer operations instead of a conversion.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));  // exact; wgmma cuts it
}

// Split the f32 values of the plane at `hi` (`bytes` long) into hi, in place,
// and lo at `lo`. All 256 consumer threads call it; when it returns the
// planes are visible to wgmma (the async proxy).
__device__ __forceinline__ void split_planes(uint32_t hi, uint32_t lo,
                                             int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * 32 * kConsumerWarps) {
    const float4 v = lds4(hi + i);
    uint32_t h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    sts4(hi + i, make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                             __uint_as_float(h[2]), __uint_as_float(h[3])));
    sts4(lo + i, make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                             __uint_as_float(l[2]), __uint_as_float(l[3])));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(kSplitBar, 32 * kConsumerWarps);
}

// A thread's A fragment of one m64 x 32-channel product, read (load_a) and
// split (split_a): h and l hold 4 registers per k-step s of 8 channels, in
// wgmma's tf32 A layout (rows lane / 4 and + 8 of the warp's 16, columns
// t = lane % 4 and t + 4):
// {row r0 col t, row r1 col t, row r0 col t + 4, row r1 col t + 4}. r0 and r1
// are the two pixels' rows in the stage (128-byte swizzle rows from a
// 1024-byte boundary). The columns are a permutation of the chunk's
// channels, so that a thread's values of a pixel are contiguous, 2 KS
// channels from 2 KS t, read 16 bytes at a time: column (s, k) is channel
// 2 KS (k % 4) + 2 s + k / 4. KS is 4 k-steps (32 channels), or 2 for a
// last chunk that holds only 16 channels, whose other half is not read.
// The weights carry the same permutation (the launcher's layout), so the
// sum over the chunk is unchanged. With KS = 4 a quarter warp reads two
// neighbouring pixels whose swizzles differ in the lowest bit, so its eight
// 16-byte reads hit eight distinct bank groups.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t stage, int r0, int r1, int t,
                                       float (&v)[2][8]) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = row ? r1 : r0;
    const uint32_t base = stage + r * kRow;
#pragma unroll
    for (int i = 0; i < KS / 2; ++i) {
      const float4 a = lds4(base + ((((KS / 2) * t + i) ^ (r & 7)) << 4));
      v[row][4 * i] = a.x, v[row][4 * i + 1] = a.y;
      v[row][4 * i + 2] = a.z, v[row][4 * i + 3] = a.w;
    }
  }
}
template <int KS>
__device__ __forceinline__ void split_a(const float (&v)[2][8],
                                        uint32_t (&h)[16], uint32_t (&l)[16]) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int k = 4 * s + 2 * e + row;
        split(v[row][2 * s + e], h[k], l[k]);
      }
}

// The tensor cores add products into their f32 accumulator with truncation:
// so the sums are kept short and added with rounded f32 adds. K7 keeps a
// tap's four hi * hi products in a fresh partial, added to acc, and the
// stage's small products (hi * lo, lo * hi; 2^-11 of the large ones) in one
// accumulator of their own, so that its error against a float64 conv is the
// plain f32 conv's (chip_smoke.py conv_kernels reports both). With all 12
// of a tap's products in one partial it was twice that, and a near-tie of
// the model's f32 train step fell on the side away from the exact conv's.
// K8 keeps a stage's 36 products of each P_j in a partial.

// K7 f32, one stage: the nine taps of KS k-steps; two taps in flight.
// (Reading the next tap's pixels before the wait, as K8 does, measured
// slower here.)
template <int N, int KS>
__device__ __forceinline__ void k7_stage(float (&acc)[N / 2], uint32_t st,
                                         int r00, int t4, uint32_t whi,
                                         uint32_t wlo) {
  float part[2][N / 2], small[N / 2];
  // A descriptor's address field counts 16-byte units and no offset here
  // carries out of it: an offset is added to the stage's descriptors.
  const uint64_t dh = mma_desc(whi, 8 * kRow), dl = mma_desc(wlo, 8 * kRow);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int r0 = r00 + (t / 3) * (WT32 + 2) + t % 3;
    float v[2][8];
    uint32_t ah[16], al[16];
    load_a<KS>(st, r0, r0 + WT32 + 2, t4, v);
    split_a<KS>(v, ah, al);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const uint32_t off = (t * N * kRow + 32 * s) >> 4;
      const uint64_t bh = dh + off, bl = dl + off;
      Wgmma<N>::tf32(part[t & 1], ah + 4 * s, bh, s > 0);
      Wgmma<N>::tf32(small, ah + 4 * s, bl, t > 0 || s > 0);
      Wgmma<N>::tf32(small, al + 4 * s, bh, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tap's fragment and partial are done
    if (t > 0) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[e] += part[(t - 1) & 1][e];
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] += part[0][e] + small[e];
}

// K8 f32, one stage: the three input rows of KS k-steps, each feeding P_0,
// P_1 and P_2; two rows in flight, the next row's pixels read meanwhile.
template <int N, int KS>
__device__ __forceinline__ void k8_stage(float (&acc)[3][N / 2], uint32_t st,
                                         int r00, int t4, uint32_t whi,
                                         uint32_t wlo) {
  float part[3][N / 2];
  const uint64_t dh = mma_desc(whi, 8 * kRow), dl = mma_desc(wlo, 8 * kRow);
  float v[2][8];
  load_a<KS>(st, r00, r00 + 8, t4, v);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    uint32_t ah[16], al[16];
    split_a<KS>(v, ah, al);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint32_t off = ((dy * 3 + j) * N * kRow + 32 * s) >> 4;
        const uint64_t bh = dh + off, bl = dl + off;
        Wgmma<N>::tf32(part[j], ah + 4 * s, bh, dy > 0 || s > 0);
        Wgmma<N>::tf32(part[j], ah + 4 * s, bl, 1);
        Wgmma<N>::tf32(part[j], al + 4 * s, bh, 1);
      }
    }
    wgmma_commit();
    if (dy < 2) {
      load_a<KS>(st, r00 + (dy + 1) * SC, r00 + (dy + 1) * SC + 8, t4, v);
    }
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[j][e] += part[j][e];
}

// ---------------------------------------------------------------------------
// K7: input-stationary. Work item: a tile of one image, 16 x 16 pixels
// (bf16) or 16 x 8 (f32).
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_fwd_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        bf16* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kK7Halo, N, 0, 1);
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      produce(sm, p, &xmap, &wmap, o0, walker, weight_bytes(N), kK7Tx,
              kK7Halo, false, WT);
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
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
      r.advance(p.stages);
    }

    // Epilogue from registers; the next tile's loads are in flight.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store_subtile<N>(out, acc[h], p, b, ty * HT + 8 * wg, tx * WT + 8 * h,
                       o0, wq, lane);
    }
  }
}

// f32: a 16 x 8 tile; warpgroup wg owns its 8 x 8 sub-tile at rows 8 wg ..
template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_fwd_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       float* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kF7Halo, N, 0, 2);
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;
  const int wbytes = weight_bytes(N);

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      produce(sm, p, &xmap, &wmap, o0, walker, wbytes, kF7Tx, kF7Halo, false,
              WT32);
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  // lo lies behind hi: behind every chunk's hi where the weights stay,
  // behind the stage's hi where they stream.
  const int lo_off = p.stationary ? p.n_cc * wbytes : wbytes;
  if (p.stationary) {
    mbar_wait(sm.wbar, 0u);
    split_planes(sm.weights, sm.weights + lo_off, p.n_cc * wbytes);
  }
  // The thread's rows m = 16 wq + lane / 4 and m + 8 are the sub-tile's
  // pixels (2 wq, lane / 4) and (2 wq + 1, lane / 4): halo row r0 at tap
  // (0, 0), and r0 + one halo row.
  const int r00 = (8 * wg + 2 * wq) * (WT32 + 2) + (lane >> 2);
  Ring r = {0, 0u};
  for (int item = walker; item < p.n_items; item += p.n_walkers) {
    const int tx = item % p.tiles_x, rest = item / p.tiles_x;
    const int ty = rest % p.tiles_y;
    const long long b = rest / p.tiles_y;
    float acc[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;

    for (int cc = 0; cc < p.n_cc; ++cc) {
      mbar_wait(sm.full + 8 * r.stage, r.parity);
      const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
      const uint32_t whi = p.stationary ? sm.weights + cc * wbytes
                                        : st + kF7Halo;
      if (!p.stationary) split_planes(whi, whi + lo_off, wbytes);
      if (p.half_last && cc == p.n_cc - 1) {
        k7_stage<N, 2>(acc, st, r00, lane & 3, whi, whi + lo_off);
      } else {
        k7_stage<N, 4>(acc, st, r00, lane & 3, whi, whi + lo_off);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
      r.advance(p.stages);
    }
    store_subtile<N>(out, acc, p, b, ty * HT + 8 * wg, tx * WT32, o0, wq,
                     lane);
  }
}

// ---------------------------------------------------------------------------
// K8: output-stationary. Work item: a strip of two output rows of one image,
// walked left to right in tiles of 64 columns.
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

// A tile's sums, out[x0 - 1 + q] = P_0[q - 2] + P_1[q - 1] + P_2[q] for
// q = 0 .. 63, through the warpgroup's panels pa, pb (row stride N + 8
// floats: no bank conflicts); all 128 threads of the warpgroup call it.
template <int N, typename T>
__device__ __forceinline__ void roll_epilogue(const float (&acc)[3][N / 2],
                                              float* pa, float* pb,
                                              T* __restrict__ out,
                                              const Plan& p, long long b,
                                              int y, int xt, int o0, int wg,
                                              int wq, int lane) {
  constexpr int PS = N + 8;
  const int tw = threadIdx.x & 127;
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

// The warpgroup's panels: P_0's (68 rows) then P_1's (66 rows).
__device__ __forceinline__ float* panels(const unsigned char* raw,
                                         const Smem& sm, int wg, int n) {
  return reinterpret_cast<float*>(const_cast<unsigned char*>(raw) +
                                  (sm.extra - smem_u32(raw)) +
                                  wg * panel_bytes(n));
}

template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_roll_fwd_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             bf16* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kK8Rows, N, 2 * panel_bytes(N), 1);
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      produce(sm, p, &xmap, &wmap, o0, walker, weight_bytes(N), kK8Rows,
              kK8Rows, true, SC);
    }
    return;
  }

  // Consumers: warpgroup wg owns output row sy * SR + wg of the strip.
  const int wg = warp >> 2, wq = warp & 3;
  float* pa = panels(smem_raw, sm, wg, N);
  float* pb = pa + 68 * (N + 8);
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
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
        r.advance(p.stages);
      }
      roll_epilogue<N>(acc, pa, pb, out, p, b, y, xt, o0, wg, wq, lane);
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kBlock, 1)
conv3x3_roll_fwd_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            float* __restrict__ out, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, p, kK8Rows, N, 2 * panel_bytes(N), 2);
  init_barriers(sm, p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x % p.n_oc) * N;
  const int walker = blockIdx.x / p.n_oc;
  const int wbytes = weight_bytes(N);

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      produce(sm, p, &xmap, &wmap, o0, walker, wbytes, kK8Rows, kK8Rows, true,
              SC);
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  float* pa = panels(smem_raw, sm, wg, N);
  float* pb = pa + 68 * (N + 8);
  const int lo_off = p.stationary ? p.n_cc * wbytes : wbytes;
  if (p.stationary) {
    mbar_wait(sm.wbar, 0u);
    split_planes(sm.weights, sm.weights + lo_off, p.n_cc * wbytes);
  }
  const int q0 = 16 * wq + (lane >> 2);  // the thread's first tile pixel
  Ring r = {0, 0u};
  for (int item = walker; item < p.n_items; item += p.n_walkers) {
    const int sy = item % p.tiles_y;
    const long long b = item / p.tiles_y;
    const int y = sy * SR + wg;
    for (int xt = 0; xt < p.tiles_x; ++xt) {
      float acc[3][N / 2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[j][e] = 0.f;

      for (int cc = 0; cc < p.n_cc; ++cc) {
        mbar_wait(sm.full + 8 * r.stage, r.parity);
        const uint32_t st = sm.ring + r.stage * sm.stage_bytes;
        const uint32_t whi = p.stationary ? sm.weights + cc * wbytes
                                          : st + kK8Rows;
        if (!p.stationary) split_planes(whi, whi + lo_off, wbytes);
        const int r00 = wg * SC + q0;
        if (p.half_last && cc == p.n_cc - 1) {
          k8_stage<N, 2>(acc, st, r00, lane & 3, whi, whi + lo_off);
        } else {
          k8_stage<N, 4>(acc, st, r00, lane & 3, whi, whi + lo_off);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty + 8 * r.stage);
        r.advance(p.stages);
      }
      roll_epilogue<N>(acc, pa, pb, out, p, b, y, xt, o0, wg, wq, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

template <typename T, int N>
int run(bool roll, const CUtensorMap& xmap, const CUtensorMap& wmap,
        void* out, const Plan& p, size_t smem, void* stream) {
  void (*kernel)(CUtensorMap, CUtensorMap, T*, Plan);
  if constexpr (sizeof(T) == 2) {
    kernel = roll ? conv3x3_roll_fwd_bf16_kernel<N>
                  : conv3x3_fwd_bf16_kernel<N>;
  } else {
    if constexpr (N == 16) {
      kernel = roll ? conv3x3_roll_fwd_f32_kernel<N>
                    : conv3x3_fwd_f32_kernel<N>;
    } else {
      kernel = conv3x3_fwd_f32_kernel<N>;  // K8 f32 takes N = 16 only
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_oc * p.n_walkers, kBlock, smem, (cudaStream_t)stream>>>(
      xmap, wmap, static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

// The launch plan (KC, OC, stationary, stages, shared-memory bytes) comes from
// ops/conv3x3.py:launch_plan; it is checked here, not chosen.
int launch(bool roll, bool f32, const void* x, const void* wt, void* out,
           int B, int H, int W, int C, int O, int KC, int OC, int stationary,
           int stages, int smem_plan, void* stream) {
  const bool ok =
      B >= 1 && H >= 1 && W >= 1 && C >= 16 && C % 16 == 0 && O >= 16 &&
      O % OC == 0 && stages >= 2 && stages <= kMaxStages &&
      (stationary == 0 || stationary == 1) &&
      (f32 ? KC == kF32Chunk && (OC == 16 || (OC == 32 && !roll))
           : (KC == 16 || KC == 32 || KC == 48 || KC == 64) && C % KC == 0 &&
                 (OC == 16 || OC == 32 || OC == 64) &&
                 (stationary == 0 || C == KC));
  if (!ok) return (int)cudaErrorInvalidValue;
  Plan p;
  p.B = B, p.H = H, p.W = W, p.O = O;
  p.kc = KC, p.ks = f32 ? KC / 8 : KC / 16;
  p.n_cc = cdiv(C, KC), p.n_oc = O / OC;
  p.stationary = stationary, p.stages = stages;
  p.half_last = f32 && C % KC == 16;
  const int tw = roll ? SC : (f32 ? WT32 : WT);
  p.tiles_x = cdiv(W, tw);
  p.tiles_y = cdiv(H, roll ? SR : HT);
  const long long items =
      (long long)B * p.tiles_y * (roll ? 1 : p.tiles_x);
  if (items > 0x7fffffffLL || (long long)p.n_oc > 0x3fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  p.n_items = (int)items;
  const int share = sm_count() / p.n_oc;
  p.n_walkers = share < 1 ? 1 : (share < p.n_items ? share : p.n_items);
  const int input = roll ? kK8Rows : (f32 ? kF7Halo : kK7Halo);
  const size_t smem = smem_bytes(p, input, OC, roll ? 2 * panel_bytes(OC) : 0,
                                 f32 ? 2 : 1);
  if (smem != (size_t)smem_plan) return (int)cudaErrorInvalidValue;

  // Both maps in the 128-byte swizzle with zero fill outside the tensor; a
  // box row is one swizzle row. f32 weights are padded to whole chunks.
  const auto dtype =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint32_t row = kRow / es;
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * es, (cuuint64_t)W * C * es,
                            (cuuint64_t)H * W * C * es};
  const cuuint32_t xb[4] = {row, (cuuint32_t)(roll ? SC : tw + 2),
                            (cuuint32_t)(roll ? SR + 2 : HT + 2), 1};
  int rc = encode_map(&xmap, dtype, 4, x, xd, xs, xb,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const cuuint64_t cw = f32 ? (cuuint64_t)p.n_cc * KC : (cuuint64_t)C;
  const cuuint64_t wd[3] = {cw, (cuuint64_t)O, 9};
  const cuuint64_t wst[2] = {cw * es, (cuuint64_t)O * cw * es};
  const cuuint32_t wb[3] = {row, (cuuint32_t)OC, 9};
  rc = encode_map(&wmap, dtype, 3, wt, wd, wst, wb,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  if (f32) {
    return OC == 16 ? run<float, 16>(roll, xmap, wmap, out, p, smem, stream)
                    : run<float, 32>(roll, xmap, wmap, out, p, smem, stream);
  }
  switch (OC) {
    case 16: return run<bf16, 16>(roll, xmap, wmap, out, p, smem, stream);
    case 32: return run<bf16, 32>(roll, xmap, wmap, out, p, smem, stream);
    default: return run<bf16, 64>(roll, xmap, wmap, out, p, smem, stream);
  }
}

}  // namespace

// x [B, H, W, C], wt [3, 3, O, C'], out [B, H, W, O], contiguous and 16-byte
// aligned. bf16: C' = C; KC (16, 32, 48 or 64) divides C, OC (16, 32 or 64)
// divides O; `stationary` only where KC == C. f32: KC = 32, C' = C rounded up
// to 32 with zeros, each chunk of wt permuted as load_a says (a last chunk of
// 16 channels with KS = 2); OC
// 16 or 32 (conv3x3_roll: 16) divides O. `stationary` keeps the weights in
// shared memory, else each of the `stages` ring stages carries its weight
// chunk; `smem` is the plan's shared-memory size and must equal the kernel's
// own count. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a refused plan), 20001 if libcuda lacks cuTensorMapEncodeTiled, or
// 30000 + the CUresult of a refused tensor map.
extern "C" int conv3x3_fwd_f32(const void* x, const void* wt, void* out,
                               int B, int H, int W, int C, int O, int KC,
                               int OC, int stationary, int stages, int smem,
                               void* stream) {
  return launch(false, true, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                stages, smem, stream);
}

extern "C" int conv3x3_roll_fwd_f32(const void* x, const void* wt, void* out,
                                    int B, int H, int W, int C, int O, int KC,
                                    int OC, int stationary, int stages,
                                    int smem, void* stream) {
  return launch(true, true, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                stages, smem, stream);
}

extern "C" int conv3x3_fwd_bf16(const void* x, const void* wt, void* out,
                                int B, int H, int W, int C, int O, int KC,
                                int OC, int stationary, int stages, int smem,
                                void* stream) {
  return launch(false, false, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                stages, smem, stream);
}

extern "C" int conv3x3_roll_fwd_bf16(const void* x, const void* wt, void* out,
                                     int B, int H, int W, int C, int O, int KC,
                                     int OC, int stationary, int stages,
                                     int smem, void* stream) {
  return launch(true, false, x, wt, out, B, H, W, C, O, KC, OC, stationary,
                stages, smem, stream);
}
