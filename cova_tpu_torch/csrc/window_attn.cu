// K10: the shifted-window multi-head self-attention of a Swin block
// (Liu et al. 2021, arXiv 2103.14030; the detection backbone's
// SwinTransformerBlock, which pads the map to a multiple of the window),
// window 7, 3 heads of 32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: neither package had an attention trunk. In plain
// PyTorch (ops/window_attn.py window_attention_plain) the block pads the
// normed map, rolls it by -shift, cuts it into 7x7 windows, computes each
// window's scores with the relative-position bias (and, shifted, -100
// between tokens of different shift regions), softmaxes them, multiplies
// by v, merges the windows, rolls back and crops: a copy of the 288-channel
// qkv for each of pad, roll and partition, the f32 scores written and read
// again, and the reverse copies of the output.
//
// Here each block takes one window of one page and does all of it:
//
//   * the pad, the roll and the partition are index arithmetic: window
//     (wy, wx) of the padded, rolled map holds at its token (i, j) the
//     token at sy = 7 wy + i, py = (sy + shift) mod Hp (and so for x) of
//     the padded map; a token with py >= H or px >= W is a pad token,
//     whose normed value is zero, so its q, k and v are the qkv Linear's
//     bias (pad_qkv). The window's 49 rows of q, k and v (576 bytes each)
//     go into shared memory by cp.async, rows 49..63 zero;
//   * per head, one warp a 16-row tile: S = q k^T by mma.sync m16n8k16
//     (bf16 in, f32 sums) over 64 keys, then in f32 S * 32^-1/2 + bias[h]
//     (+ -100 where the shift regions of query and key differ, shift > 0;
//     keys 49..63 get -inf), the row's softmax (max and sum across the
//     quad of lanes that holds the row), P rounded to bf16 as the A operand
//     of O = P v (mma.sync again, v through ldmatrix.trans), O divided by
//     the row's sum; O goes to shared memory over the warp's own q rows;
//   * the window merge, the roll back and the crop are the same index
//     arithmetic: a real token's 96 output channels go back to its own
//     position of [B, H, W, 96]; pad tokens' queries are never written.
//
// What bounds it on the H100: HBM bytes. Each token's qkv is read once and
// its output written once (pad tokens read the 576-byte bias, from L2):
// at B = 10 and 1280^2 (a 320 x 320 map, 46 x 46 windows a page) that is
// 590 MB + 197 MB, 0.235 ms at 3.35 TB/s. The tensor-core work (scores and
// PV over 64 x 64 padded tiles, 33 GFLOP a launch) and the 64 x 64 x 3
// exponentials a window stay under that. Several blocks an SM (37 KB of
// shared memory each) keep loads in flight while others compute.
//
// Shared rows are 296 bf16 (592 bytes) apart, so the eight row addresses of
// an ldmatrix and the quad-row stores of O fall on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWin = 7;            // window side
constexpr int kTok = kWin * kWin;  // tokens a window
constexpr int kRows = 64;          // the tile's rows: kTok padded to 4 x 16
constexpr int kHeads = 3, kHd = 32, kC = kHeads * kHd, kQkv = 3 * kC;
constexpr int kStride = kQkv + 8;  // shared row stride, bf16 elements
constexpr int kThreads = 128;      // 4 warps: one 16-row tile each
constexpr int kMinBlocks = 5;      // caps the registers at 102
constexpr int kInVec = kQkv / 8;   // 16-byte vectors of a token's qkv
constexpr int kOutVec = kC / 8;    // ... of its output
constexpr float kMaskValue = -100.0f;  // the published attn_mask's value
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int h, w;        // the unpadded map
  int hp, wp;      // padded to multiples of the window
  int nwy, nwx;    // windows a side
  int shift;       // 0 (W-MSA) or the cyclic shift (SW-MSA)
};

// The token of the unpadded map at window row or column t of the rolled,
// padded map: its coordinate, or -1 for a pad token.
__device__ __forceinline__ int source(int s, int pad_len, int len,
                                      int shift) {
  int p = s + shift;
  if (p >= pad_len) p -= pad_len;
  return p < len ? p : -1;
}

// The shift region of rolled coordinate s along a padded side of pad_len:
// the published slices (0, -7), (-7, -shift), (-shift, end).
__device__ __forceinline__ int region(int s, int pad_len, int shift) {
  return s < pad_len - kWin ? 0 : (s < pad_len - shift ? 1 : 2);
}

// Token t of the window's flat index into [B, H, W] or -1 (pad or t >= 49).
__device__ __forceinline__ int token_index(int t, int b, int wy, int wx,
                                           const Geometry& g) {
  if (t >= kTok) return -1;
  const int sy = wy * kWin + t / kWin, sx = wx * kWin + t % kWin;
  const int py = source(sy, g.hp, g.h, g.shift);
  const int px = source(sx, g.wp, g.w, g.shift);
  if (py < 0 || px < 0) return -1;
  return (b * g.h + py) * g.w + px;
}

__device__ __forceinline__ int token_region(int t, int wy, int wx,
                                            const Geometry& g) {
  const int t7 = t < kTok ? t : 0;
  return region(wy * kWin + t7 / kWin, g.hp, g.shift) * 3 +
         region(wx * kWin + t7 % kWin, g.wp, g.shift);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
window_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ pad_qkv,
                   __nv_bfloat16* __restrict__ out, Geometry g,
                   float scale) {
  __shared__ __align__(16) uint16_t tile_bits[kRows * kStride];
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(tile_bits);

  const int tid = threadIdx.x;
  const int per_page = g.nwy * g.nwx;
  const int b = blockIdx.x / per_page;
  const int wy = (blockIdx.x % per_page) / g.nwx;
  const int wx = blockIdx.x % g.nwx;

  // Gather the window's q, k and v rows (pad tokens: the bias).
  for (int k = tid; k < kTok * kInVec; k += kThreads) {
    const int t = k / kInVec, v = k % kInVec;
    const int src = token_index(t, b, wy, wx, g);
    const __nv_bfloat16* from =
        src >= 0 ? qkv + static_cast<long long>(src) * kQkv + v * 8
                 : pad_qkv + v * 8;
    cp_async16(tile + t * kStride + v * 8, from);
  }
  for (int k = tid; k < (kRows - kTok) * kInVec; k += kThreads) {
    const int t = kTok + k / kInVec, v = k % kInVec;
    *reinterpret_cast<uint4*>(tile + t * kStride + v * 8) =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = warp * 16;
  const int r_lo = m0 + (lane >> 2), r_hi = r_lo + 8;  // this lane's rows
  const int cq = (lane & 3) * 2;  // ... and its first column of each tile
  const float neg_inf = __int_as_float(0xff800000);

  // Per lane and key tile: which of its 32 scores cross a shift region
  // (bit e + 2 nt for row r_lo, + 16 for r_hi). Keys >= 49 are masked
  // below by -inf.
  uint32_t cross = 0;
  if (g.shift > 0) {
    const int reg_lo = token_region(r_lo, wy, wx, g);
    const int reg_hi = token_region(r_hi, wy, wx, g);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kr = token_region(nt * 8 + cq + e, wy, wx, g);
        cross |= static_cast<uint32_t>(kr != reg_lo) << (nt * 2 + e);
        cross |= static_cast<uint32_t>(kr != reg_hi) << (16 + nt * 2 + e);
      }
    }
  }

#pragma unroll 1
  for (int h = 0; h < kHeads; ++h) {
    // S = q k^T over the head's 32 channels.
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(qa[ks], tile + (m0 + (lane & 15)) * kStride + h * kHd +
                              ks * 16 + (lane >> 4) * 8);
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t kb[4];
      ldmatrix_x4(kb, tile + (nt * 8 + (lane & 7)) * kStride + kC + h * kHd +
                          (lane >> 3) * 8);
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      mma_bf16(s[nt], qa[0], kb[0], kb[1]);
      mma_bf16(s[nt], qa[1], kb[2], kb[3]);
    }

    // Scale, bias, shift mask; the softmax's max and sum in f32.
    const float* bh = bias + h * kTok * kTok;
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int half = k >> 1, e = k & 1;
        const int row = half ? r_hi : r_lo, key = nt * 8 + cq + e;
        float v;
        if (key >= kTok) {
          v = neg_inf;
        } else {
          v = s[nt][k] * scale;
          if (row < kTok) v += __ldg(bh + row * kTok + key);
          if ((cross >> (half * 16 + nt * 2 + e)) & 1u) v += kMaskValue;
        }
        s[nt][k] = v;
        mx[half] = fmaxf(mx[half], v);
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int half = k >> 1;
        const float p = exp2f((s[nt][k] - mx[half]) * kLog2e);
        s[nt][k] = p;
        sum[half] += p;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    }

    // O = P v over 64 keys, 4 tiles of 8 channels.
    float o[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < 4; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, tile + (kk * 16 + (lane & 15)) * kStride +
                                  2 * kC + h * kHd + nd * 8 +
                                  (lane >> 4) * 8);
        mma_bf16(o[nd], pa, vb[0], vb[1]);
        mma_bf16(o[nd + 1], pa, vb[2], vb[3]);
      }
    }

    // O / sum over this warp's q rows of head h (only this warp reads
    // them, and it has them in registers).
    const float inv_lo = 1.f / sum[0], inv_hi = 1.f / sum[1];
    __syncwarp();
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      const int col = h * kHd + nd * 8 + cq;
      *reinterpret_cast<uint32_t*>(tile + r_lo * kStride + col) =
          pack_bf16(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
      *reinterpret_cast<uint32_t*>(tile + r_hi * kStride + col) =
          pack_bf16(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
  }
  __syncthreads();

  // Each real token's 96 channels back to its own position.
  for (int k = tid; k < kTok * kOutVec; k += kThreads) {
    const int t = k / kOutVec, v = k % kOutVec;
    const int dst = token_index(t, b, wy, wx, g);
    if (dst < 0) continue;
    *reinterpret_cast<uint4*>(out + static_cast<long long>(dst) * kC +
                              v * 8) =
        *reinterpret_cast<const uint4*>(tile + t * kStride + v * 8);
  }
}

}  // namespace

// qkv: [batch, h, w, 288] bf16, contiguous, 16-byte aligned (q, k, v of 3
// heads of 32 each, the published Linear's order); bias: [3, 49, 49] f32,
// the relative-position bias gathered from its table by the published
// index; pad_qkv: [288] bf16, 16-byte aligned, the qkv Linear's bias; out:
// [batch, h, w, 96] bf16. shift: 0 or 1..6. Returns the cudaError_t of the
// launch.
extern "C" int window_attn_bf16(const void* qkv, const void* bias,
                                const void* pad_qkv, void* out, int batch,
                                int h, int w, int shift, float scale,
                                void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || shift < 0 || shift >= kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  g.h = h, g.w = w, g.shift = shift;
  g.nwy = (h + kWin - 1) / kWin, g.nwx = (w + kWin - 1) / kWin;
  g.hp = g.nwy * kWin, g.wp = g.nwx * kWin;
  const long long blocks = static_cast<long long>(batch) * g.nwy * g.nwx;
  if (blocks > 0x7fffffffLL ||
      static_cast<long long>(batch) * h * w > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool carveout = false;
  if (!carveout) {
    // The most shared memory an SM can give: room for six blocks.
    const cudaError_t e = cudaFuncSetAttribute(
        window_attn_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return static_cast<int>(e);
    carveout = true;
  }
  window_attn_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(pad_qkv),
      static_cast<__nv_bfloat16*>(out), g, scale);
  return static_cast<int>(cudaGetLastError());
}
