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
// 256 bf16, 524 MB at B = 10) and writes a quarter of that; about 20 f32
// operations per output and channel are far below the card's rate.
//
// Design (the kernel is further down, after the backward's helpers, which it
// shares): persistent blocks, each keeping one chunk of FC channels f (of
// each of the four phase groups) and walking tiles of kFwdU x kFwdV s2d
// blocks. A tile's ys, with one halo row above and one halo column to the
// left (where the taps of rows i-1 and columns j-1 reach), comes into shared
// memory through a ring of stages, so the next tiles arrive while the block
// works on this one: by TMA (one thread issues a 5-D box) where a thread
// moves 16 bytes of channels, else by every thread's cp.async. A thread owns one output column of the tile
// and one vector of N channels, walks its rows top down and keeps the row
// above's column-stage values of the ey = 1 groups in registers, so each
// staged element gets its affine about once and each output reads six
// vectors (four groups here, two to the left), not nine. The maxima run in
// the TPU kernel's order: column stage (ex = 1 groups against column j-1),
// row stage (ey = 1 groups against row i-1), then the four groups; then
// ReLU, one rounding and one 16-byte store. TMA's zero fill is not the
// pool's padding (-inf after the affine): the halo row of the map's first
// tile row and the halo column of its first tile column are replaced by
// -inf, as the TPU kernel masks them. Offsets inside a tile are 32-bit and
// the tile is a compile-time shape, so the per-element path has no 64-bit
// division (the earlier kernel, a thread per output that split a 64-bit
// index by five divisions, ran at 38% of the bound on the H100; PERF.md).

#include <cuda_bf16.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

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
// What bounds it on the H100: HBM bytes: ys read and dys written once
// (B x 320 x 320 x 256, 262 MB each in bf16 at B = 5) and g read once; the
// nine-tap winners are a few tens of f32 operations per output.
//
// Design: a gather, so no atomics and no scratch map. A persistent block
// keeps one chunk of FC channels (of each of the four groups) and walks
// tiles of kTileU x kTileV s2d blocks through two shared-memory buffers:
// the next tile's ys, with one block of halo above and to the left (where
// the winners' taps reach) and one below and to the right (the outputs whose
// winners can land in the tile), and its g arrive while the block works on
// the current one. In bf16 one thread copies the whole tile by TMA
// (measured faster than every thread's cp.async); in f32, and where a thread
// moves a pair of channels, every thread issues 16-, 8- or 4-byte cp.async
// copies (in f32 TMA measured slower). For each tile:
//   1. every output of the tile and of its extra row and column finds its
//      winner once per channel, with the forward's unfused affine
//      (__fmul_rn then __fadd_rn, so the winners are the forward's), and
//      stores it as one byte: 0 for no gradient, else 1 + 4 * group + 2 *
//      (row i-1 won) + (column j-1 won); a thread takes half a vector of
//      channels, so the tile's outputs fill the block's threads in three
//      rounds;
//   2. every input (u, v, group, channel) gathers the g of the at most four
//      outputs (u, v), (u+1, v), (u, v+1), (u+1, v+1) whose code names it:
//      four codes are compared in one 32-bit word and the matches mask g, so
//      the sum needs no branches. It adds them in the plain version's order,
//        dpre = (c(u, v) + c(u+1, v)) + (c(u, v+1) + c(u+1, v+1)),
//      so dys equals the plain version bit for bit (up to the sign of a
//      zero), and stores dys = dpre * scale as one 16-byte vector per thread.
// The 2-D block (thread x: group and channel vector, y: pixel slot), the
// compile-time tile and 32-bit offsets inside a tile keep the index
// arithmetic to a few operations per access. Each thread keeps
// d(scale)/d(shift) sums for its channels over the whole walk; at the end
// the block adds its threads' sums in shared memory in a fixed order into its
// walker's row of partials [n_walkers, 2, 4*O], which the wrapper sums.
// Those sums are exact up to f32 rounding in another order than the plain
// version's.

// s2d blocks per tile, kTileU x kTileV: 8 x 16 in bf16, 8 x 8 in f32 (where
// 16 columns would leave room for chunks of only 8 channels; measured
// slower). The halo adds a row and column on each side (kHaloU x kHaloV),
// the outputs one below and to the right (kOutU x kOutV).
template <typename T> struct BwdTile {
  static constexpr int U = 8, V = sizeof(T) == 2 ? 16 : 8;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared-memory layout (the wrapper's plan, ops/bn_pool.py::bwd_plan,
// mirrors it), from the first 128-byte boundary: two tile buffers, each ys
// [kHaloU rows][4 groups][kHaloV columns][FC] then g [kOutU * kOutV][FC],
// each part rounded up to 128 bytes (a TMA destination); then the winner
// codes [kOutU * kOutV][FC] bytes, rounded up to 16; then scale and shift of
// the chunk, FC floats each; then the two buffers' mbarriers. A group's
// columns lie side by side, so the neighbouring outputs' threads of the
// winner step read consecutive segments.
template <typename T>
struct BwdLayout {
  static constexpr int kTileV = BwdTile<T>::V, kHaloV = kTileV + 2;
  static constexpr int kHaloU = BwdTile<T>::U + 2;
  static constexpr int kOutU = BwdTile<T>::U + 1, kOutV = kTileV + 1;
  int FC, ys_bytes, g_bytes, stage_bytes, codes_bytes;
  __device__ explicit BwdLayout(int fc, int itemsize = sizeof(T)) : FC(fc) {
    ys_bytes = round128(kHaloU * 4 * kHaloV * fc * itemsize);
    g_bytes = round128(kOutU * kOutV * fc * itemsize);
    stage_bytes = ys_bytes + g_bytes;
    codes_bytes = (kOutU * kOutV * fc + 15) & ~15;
  }
  __device__ static int round128(int n) { return (n + 127) & ~127; }
  // Element offset of (tile row r, tile column c, group) in a ys tile.
  __device__ int ys_at(int r, int c, int grp) const {
    return ((r * 4 + grp) * kHaloV + c) * FC;
  }
};

// Winner codes of one output for HN channels, from its taps (raw ys of the
// four groups at (i, j); l: column j-1, u: row i-1, ul: both), with the
// forward's unfused affine. The winner is the lowest group whose stage value
// equals the largest M; each stage keeps the shifted tap on ties. kEdge:
// the output lies in row 0 or column 0, where the missing taps are -inf.
template <bool kEdge, typename T, int HN>
__device__ __forceinline__ Vec<unsigned char, HN> winner_codes(
    const Vec<T, HN> (&a)[4], const Vec<T, HN>& l1, const Vec<T, HN>& l3,
    const Vec<T, HN>& u2, const Vec<T, HN>& u3, const Vec<T, HN>& ul3,
    const float* sc, const float* sh, bool up, bool left) {
  Vec<unsigned char, HN> code;
  const float ninf = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < HN; ++k) {
    auto aff = [&](T x) {
      return __fadd_rn(__fmul_rn(to_f(x), sc[k]), sh[k]);
    };
    const float v0 = aff(a[0].v[k]);
    const float z1 = aff(a[1].v[k]), z2 = aff(a[2].v[k]);
    const float z3 = aff(a[3].v[k]);
    float zl1 = aff(l1.v[k]), zu2 = aff(u2.v[k]), zl3 = aff(l3.v[k]);
    float zu3 = aff(u3.v[k]), zul3 = aff(ul3.v[k]);
    if (kEdge) {
      if (!left) zl1 = zl3 = zul3 = ninf;
      if (!up) zu2 = zu3 = zul3 = ninf;
    }
    // group 1: column j-1 against j; group 2: row i-1 against i; group 3:
    // the column stage on rows i and i-1, then the row stage.
    const bool cs1 = zl1 >= z1, rs2 = zu2 >= z2;
    const float v1 = fmaxf(zl1, z1), v2 = fmaxf(zu2, z2);
    const bool ci3 = zl3 >= z3, cu3 = zul3 >= zu3;
    const float zi3 = fmaxf(zl3, z3), zr3 = fmaxf(zul3, zu3);
    const bool rs3 = zr3 >= zi3;
    const float v3 = fmaxf(zr3, zi3);
    const float m = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
    int w = 13 + (rs3 ? 2 : 0) + ((rs3 ? cu3 : ci3) ? 1 : 0);
    if (v2 == m) w = rs2 ? 11 : 9;
    if (v1 == m) w = cs1 ? 6 : 5;
    if (v0 == m) w = 1;
    code.v[k] = m > 0.f ? (unsigned char)w : 0;
  }
  return code;
}

// 0xff in each byte of w that equals the same byte of pat, else 0.
__device__ __forceinline__ unsigned eq_bytes(unsigned w, unsigned pat) {
  const unsigned t = w ^ pat;
  const unsigned z = ~(((t & 0x7f7f7f7fu) + 0x7f7f7f7fu) | t | 0x7f7f7f7fu);
  return (z >> 7) * 0xffu;
}

// The N codes at p as 32-bit words (N = 2: the upper half is 0, no code).
template <int N> struct CodeWords {
  static constexpr int kWords = N >= 4 ? N / 4 : 1;
  unsigned w[kWords];
  __device__ explicit CodeWords(const unsigned char* p) {
    if constexpr (N >= 4) {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        w[k] = reinterpret_cast<const unsigned*>(p)[k];
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
};

// The channels of g whose codes matched (mask m: 0xff per matching byte),
// else +0, as f32.
template <int N>
__device__ __forceinline__ void masked(const Vec<float, N>& g,
                                       const unsigned* m, float (&c)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const unsigned keep = __byte_perm(m[k / 4], 0, (k % 4) * 0x1111u);
    c[k] = __uint_as_float(__float_as_uint(g.v[k]) & keep);
  }
}
template <int N>
__device__ __forceinline__ void masked(const Vec<__nv_bfloat16, N>& g,
                                       const unsigned* m, float (&c)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 2) {  // a pair of channels: one 32-bit word
    const unsigned s = k % 4;
    const unsigned keep = __byte_perm(m[k / 4], 0,
                                      s * 0x11u + (s + 1) * 0x1100u);
    const unsigned pair = reinterpret_cast<const unsigned*>(g.v)[k / 2] & keep;
    c[k] = __uint_as_float(pair << 16);
    c[k + 1] = __uint_as_float(pair & 0xffff0000u);
  }
}

// grid: n_chunks * n_walkers blocks; block: (4 * FC / N, ny) threads;
// dynamic shared memory: the plan's bytes. Block x keeps channel chunk
// x % n_chunks and walks the tiles x / n_chunks, + n_walkers, ..., the
// copies of one tile in flight while it works on the one before. Where a
// thread moves 16 bytes (kTma), one thread copies each tile by TMA through
// the maps ymap (ys as [B][U][4][V][O], box FC x kHaloV x 4 x kHaloU) and
// gmap (g, box FC x kOutV x kOutU); else every thread copies pairs of
// channels with cp.async.
// At most 85 registers a thread, so three blocks share an SM (measured a
// little faster than two blocks with more registers, and no spills).
template <typename T, int N>
__global__ void __launch_bounds__(256, 3)
bn_relu_pool_bwd_kernel(const __grid_constant__ CUtensorMap ymap,
                        const __grid_constant__ CUtensorMap gmap,
                        const T* __restrict__ ys,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const T* __restrict__ g, T* __restrict__ dys,
                        float* __restrict__ partial, int B, int U, int V,
                        int O, int FC) {
  constexpr bool kTma = N * sizeof(T) == 16 && sizeof(T) == 2;
  constexpr int kTileU = BwdTile<T>::U, kTileV = BwdTile<T>::V;
  constexpr int kHaloU = kTileU + 2, kHaloV = kTileV + 2;
  constexpr int kOutU = kTileU + 1, kOutV = kTileV + 1;
  constexpr int HN = N > 1 ? N / 2 : 1;  // channels of a winner item
  constexpr unsigned kB = sizeof(T);
  using Vv = Vec<T, N>;
  using Hv = Vec<T, HN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BwdLayout<T> lay(FC);
  const unsigned raw_u32 = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* const smem = smem_raw + (((raw_u32 + 127) & ~127u) - raw_u32);
  const unsigned smem_u32 = (raw_u32 + 127) & ~127u;
  unsigned char* const code_s = smem + 2 * lay.stage_bytes;
  float* const sc_s = reinterpret_cast<float*>(code_s + lay.codes_bytes);
  float* const sh_s = sc_s + FC;
  const unsigned bar0 = smem_u32 + 2 * lay.stage_bytes + lay.codes_bytes +
                        2 * FC * 4;  // two mbarriers, 8 bytes each

  const int n_chunks = O / FC;
  const int chunk = blockIdx.x % n_chunks;
  const int walker = blockIdx.x / n_chunks;
  const int n_walkers = gridDim.x / n_chunks;
  const int FV = FC / N;            // vectors per group segment
  const int tx = threadIdx.x;       // (group, vector) of this thread
  const int grp = tx / FV, cv = tx % FV;
  const int ty = threadIdx.y, ny = blockDim.y;
  const int nt = blockDim.x * ny, me = ty * blockDim.x + tx;
  const int f0 = chunk * FC + cv * N;  // first channel f of this thread
  const int c4 = 4 * O;
  // Winner items: (output, half vector); `per_round` outputs at a time.
  const int halves = FC / HN;
  const int hv = me % halves, osub = me / halves;
  const int per_round = nt / halves;

  for (int k = me; k < FC; k += nt) {
    sc_s[k] = scale[chunk * FC + k];
    sh_s[k] = shift[chunk * FC + k];
  }
  if (kTma && me == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float dsc[N], dsh[N];
#pragma unroll
  for (int k = 0; k < N; ++k) dsc[k] = dsh[k] = 0.f;

  const int tiles_u = (U + kTileU - 1) / kTileU;
  const int tiles_v = (V + kTileV - 1) / kTileV;
  const long long n_tiles = (long long)B * tiles_u * tiles_v;
  const long long image = (long long)U * V;  // pixels of one image

  // Copies of the walk's tile number `it` into buffer it % 2. By TMA,
  // positions outside the map are zero; by cp.async they are left as they
  // are; neither is read. cp.async addresses are 32-bit offsets from the
  // tile's first pixel (the wrapper checks that kHaloU rows of the map span
  // fewer than 2^31 elements).
  auto load = [&](long long it) {
    const long long t = walker + it * n_walkers;
    if (t >= n_tiles) return;
    const int tv = (int)(t % tiles_v);
    const long long bt = t / tiles_v;
    const int tu = (int)(bt % tiles_u);
    const int b = (int)(bt / tiles_u);
    const int u0 = tu * kTileU, v0 = tv * kTileV;
    const unsigned stage = smem_u32 + (unsigned)(it & 1) * lay.stage_bytes;
    if constexpr (kTma) {
      if (me == 0) {
        const unsigned bar = bar0 + (unsigned)(it & 1) * 8;
        // Earlier reads of this buffer come before the copy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, (unsigned)((kHaloU * 4 * kHaloV +
                                        kOutU * kOutV) * FC * kB));
        tma_load_5d(stage, &ymap, bar, chunk * FC, v0 - 1, 0, u0 - 1, b);
        tma_load_4d(stage + lay.ys_bytes, &gmap, bar, chunk * FC, v0, u0, b);
      }
    } else {
      const long long at0 = (long long)b * image + (long long)u0 * V + v0;
      const T* src = ys + at0 * c4 + grp * O + f0;
      for (int pix = ty; pix < kHaloU * kHaloV; pix += ny) {
        const int r = pix / kHaloV, c = pix % kHaloV;
        if ((unsigned)(u0 + r - 1) >= (unsigned)U ||
            (unsigned)(v0 + c - 1) >= (unsigned)V)
          continue;
        cp_async<(int)sizeof(Vv)>(
            stage + (lay.ys_at(r, c, grp) + cv * N) * kB,
            src + ((r - 1) * V + c - 1) * c4);
      }
      const T* gsrc = g + at0 * O + f0;
      for (int p4 = ty; p4 * 4 < kOutU * kOutV; p4 += ny) {
        const int pix = p4 * 4 + grp;
        if (pix >= kOutU * kOutV) continue;
        const int r = pix / kOutV, c = pix % kOutV;
        if (u0 + r >= U || v0 + c >= V) continue;
        cp_async<(int)sizeof(Vv)>(
            stage + lay.ys_bytes + (pix * FC + cv * N) * kB,
            gsrc + (r * V + c) * O);
      }
    }
  };

  load(0);
  if constexpr (!kTma) cp_async_commit();
  const long long n_mine =
      walker < n_tiles ? (n_tiles - 1 - walker) / n_walkers + 1 : 0;
  for (long long it = 0; it < n_mine; ++it) {
    load(it + 1);
    if constexpr (kTma) {
      mbar_wait(bar0 + (unsigned)(it & 1) * 8, (unsigned)(it >> 1) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed
      __syncthreads();
    }

    const long long t = walker + it * n_walkers;
    const int tv = (int)(t % tiles_v);
    const long long bt = t / tiles_v;
    const int tu = (int)(bt % tiles_u);
    const long long b = bt / tiles_u;
    const int u0 = tu * kTileU, v0 = tv * kTileV;
    const T* ysb = reinterpret_cast<const T*>(smem + (it & 1) *
                                              lay.stage_bytes);
    const T* gsb = reinterpret_cast<const T*>(smem + (it & 1) *
                                              lay.stage_bytes + lay.ys_bytes);

    // 1. Winner codes of outputs (u0 + oi, v0 + oj), oi < kOutU, oj < kOutV.
    if (osub < per_round) {
      float sc[HN], sh[HN];
#pragma unroll
      for (int k = 0; k < HN; ++k) {
        sc[k] = sc_s[hv * HN + k];
        sh[k] = sh_s[hv * HN + k];
      }
      for (int pix = osub; pix < kOutU * kOutV; pix += per_round) {
        const int oi = pix / kOutV, oj = pix % kOutV;
        const int i = u0 + oi, j = v0 + oj;
        Vec<unsigned char, HN> code;
#pragma unroll
        for (int k = 0; k < HN; ++k) code.v[k] = 0;
        if (i < U && j < V) {
          // Taps: rows i (tile row oi + 1) and i - 1 (oi), columns j
          // (oj + 1) and j - 1 (oj); a tap outside the map is read but not
          // used.
          const T* here = ysb + lay.ys_at(oi + 1, oj + 1, 0) + hv * HN;
          const int gs = kHaloV * FC, rs = 4 * gs;  // group, row strides
          auto tap = [&](int off) {
            return *reinterpret_cast<const Hv*>(here + off);
          };
          const Hv a[4] = {tap(0), tap(gs), tap(2 * gs), tap(3 * gs)};
          const Hv l1 = tap(gs - FC), l3 = tap(3 * gs - FC);
          const Hv u2 = tap(2 * gs - rs), u3 = tap(3 * gs - rs);
          const Hv ul3 = tap(3 * gs - rs - FC);
          const bool up = i > 0, left = j > 0;
          code = up && left
                     ? winner_codes<false>(a, l1, l3, u2, u3, ul3, sc, sh,
                                           up, left)
                     : winner_codes<true>(a, l1, l3, u2, u3, ul3, sc, sh,
                                          up, left);
        }
        *reinterpret_cast<Vec<unsigned char, HN>*>(code_s + pix * FC +
                                                   hv * HN) = code;
      }
    }
    __syncthreads();

    // 2. Gather: input (u0 + u, v0 + v), group grp, channels f0 .. f0+N-1,
    // from outputs (u, v), (u+1, v), (u, v+1), (u+1, v+1) of the tile.
    float sc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) sc[k] = sc_s[cv * N + k];
    const unsigned want = 1 + 4 * grp;
    const unsigned pat[4] = {want * 0x01010101u, (want + 2) * 0x01010101u,
                             (want + 1) * 0x01010101u,
                             (want + 3) * 0x01010101u};
    T* dimg = dys + (b * image + (long long)u0 * V + v0) * c4 + grp * O + f0;
    for (int pix = ty; pix < kTileU * kTileV; pix += ny) {
      const int u = pix / kTileV, v = pix % kTileV;
      if (u0 + u >= U || v0 + v >= V) continue;
      const int o00 = u * kOutV + v;
      const int oo[4] = {o00, o00 + kOutV, o00 + 1, o00 + kOutV + 1};
      float c[4][N];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const CodeWords<N> cw(code_s + oo[q] * FC + cv * N);
        unsigned m[CodeWords<N>::kWords];
#pragma unroll
        for (int w = 0; w < CodeWords<N>::kWords; ++w)
          m[w] = eq_bytes(cw.w[w], pat[q]);
        const Vv gq = *reinterpret_cast<const Vv*>(gsb + oo[q] * FC + cv * N);
        masked(gq, m, c[q]);
      }
      const Vv x = *reinterpret_cast<const Vv*>(
          ysb + lay.ys_at(u + 1, v + 1, grp) + cv * N);
      Vv out;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        // (u, v) and (u+1, v) reach this input through column v; (u, v+1)
        // and (u+1, v+1) through column v+1 (their column j-1).
        const float d = (c[0][k] + c[1][k]) + (c[2][k] + c[3][k]);
        out.v[k] = from_f<T>(__fmul_rn(d, sc[k]));
        dsc[k] += d * to_f(x.v[k]);
        dsh[k] += d;
      }
      *reinterpret_cast<Vv*>(dimg + (u * V + v) * c4) = out;
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
  if constexpr (!kTma) cp_async_wait<0>();  // the group past the walk's end
  __syncthreads();

  // The block's sums, thread row by thread row, into its walker's partials.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    red[k * nt + me] = dsc[k];
    red[(N + k) * nt + me] = dsh[k];
  }
  __syncthreads();
  if (ty == 0) {
    float* row = partial + (long long)walker * 2 * c4 + grp * O + f0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float a = 0.f, h = 0.f;
      for (int r = 0; r < ny; ++r) {
        a += red[k * nt + r * blockDim.x + tx];
        h += red[(N + k) * nt + r * blockDim.x + tx];
      }
      row[k] = a;
      row[c4 + k] = h;
    }
  }
}

// A tensor map of rank `rank` over `base` with zero fill outside it.
template <typename T>
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  return encode_map(map,
                    sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    rank, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int N>
int launch_bwd(const void* ys, const void* scale, const void* shift,
               const void* g, void* dys, void* partial, int B, int U, int V,
               int O, int FC, int n_walkers, int ny, int smem_bytes,
               void* stream) {
  if (FC < N || FC % N || O % FC || n_walkers < 1 || ny < 1 ||
      4 * (FC / N) * ny > 256)
    return (int)cudaErrorInvalidValue;
  constexpr int kHaloU = BwdTile<T>::U + 2, kHaloV = BwdTile<T>::V + 2;
  constexpr int kOutU = BwdTile<T>::U + 1, kOutV = BwdTile<T>::V + 1;
  CUtensorMap ymap{}, gmap{};
  if (N * sizeof(T) == 16 && sizeof(T) == 2) {
    const cuuint64_t sz = sizeof(T), o = O, v = V, u = U;
    // ys [B][U][V][4][O] read as [B][U][4][V][O]: groups before columns.
    const cuuint64_t yd[5] = {o, v, 4, u, (cuuint64_t)B};
    const cuuint64_t yst[4] = {4 * o * sz, o * sz, v * 4 * o * sz,
                               u * v * 4 * o * sz};
    const cuuint32_t yb[5] = {(cuuint32_t)FC, kHaloV, 4, kHaloU, 1};
    int rc = encode<T>(&ymap, ys, 5, yd, yst, yb);
    if (rc) return rc;
    const cuuint64_t gd[4] = {o, v, u, (cuuint64_t)B};
    const cuuint64_t gst[3] = {o * sz, v * o * sz, u * v * o * sz};
    const cuuint32_t gb[4] = {(cuuint32_t)FC, kOutV, kOutU, 1};
    rc = encode<T>(&gmap, g, 4, gd, gst, gb);
    if (rc) return rc;
  }
  auto kernel = bn_relu_pool_bwd_kernel<T, N>;
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc) return rc;
  const dim3 block(4 * (FC / N), ny);
  kernel<<<(O / FC) * n_walkers, block, smem_bytes, (cudaStream_t)stream>>>(
      ymap, gmap, static_cast<const T*>(ys), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const T*>(g),
      static_cast<T*>(dys), static_cast<float*>(partial), B, U, V, O, FC);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- forward

// s2d blocks per forward tile (ops/bn_pool.py::FWD_TILE), and the stage of
// one tile: ys rows u0-1 .. u0+kFwdU-1, each as [4 groups][kFwdV + 1
// columns v0-1 .. v0+kFwdV-1][FC], groups before columns as in the
// backward's tiles; rounded up to 128 bytes (a TMA destination).
constexpr int kFwdU = 8, kFwdV = 16;
constexpr int kFwdRows = kFwdU + 1, kFwdCols = kFwdV + 1;
constexpr int kFwdMaxThreads = 256;

__host__ __device__ constexpr int fwd_stage_bytes(int fc, int itemsize) {
  return (kFwdRows * 4 * kFwdCols * fc * itemsize + 127) & ~127;
}

// Waits until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// grid: n_chunks * n_walkers blocks; block: FC / N * kFwdV * RS threads
// (thread: vector cv of the chunk, output column oj, row split rs); dynamic
// shared memory: the plan's bytes (ops/bn_pool.py::fwd_plan): `stages`
// tile stages, then one mbarrier per stage. Block x keeps channel chunk
// x % n_chunks and walks the tiles x / n_chunks, + n_walkers, ... Where a
// thread moves 16 bytes (kTma), one thread loads each tile through ymap (ys as [B][U][4][V][O], box FC x
// (kFwdV + 1) x 4 x (kFwdU + 1) from (u0 - 1, v0 - 1)); else every thread
// copies vectors with cp.async and skips positions outside the map (the
// taps that reach them are the padding, replaced by -inf, or belong to
// outputs outside the map, which are not stored).
template <typename T, int N>
__global__ void __launch_bounds__(kFwdMaxThreads)
bn_relu_pool_fwd_kernel(const __grid_constant__ CUtensorMap ymap,
                        const T* __restrict__ ys,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift, T* __restrict__ out,
                        int B, int U, int V, int O, int FC, int RS,
                        int stages) {
  constexpr bool kTma = N * sizeof(T) == 16;
  using Vv = Vec<T, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const unsigned raw_u32 = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned smem_u32 = (raw_u32 + 127) & ~127u;
  unsigned char* const smem = smem_raw + (smem_u32 - raw_u32);
  const int stage_bytes = fwd_stage_bytes(FC, (int)sizeof(T));
  const unsigned bar0 = smem_u32 + (unsigned)(stages * stage_bytes);

  const int n_chunks = O / FC;
  const int chunk = blockIdx.x % n_chunks;
  const int walker = blockIdx.x / n_chunks;
  const int n_walkers = gridDim.x / n_chunks;
  const int FV = FC / N;  // vectors per group segment
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cv = tid % FV, oj = (tid / FV) % kFwdV, rs = tid / (FV * kFwdV);
  const int R = kFwdU / RS, r0 = rs * R;  // this thread's output rows
  const int f0 = chunk * FC + cv * N;     // its first channel f
  const int c4 = 4 * O;

  float sc[N], sh[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    sc[k] = scale[f0 + k];
    sh[k] = shift[f0 + k];
  }
  if (kTma && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_u = (U + kFwdU - 1) / kFwdU;
  const int tiles_v = (V + kFwdV - 1) / kFwdV;
  const int n_tiles = B * tiles_u * tiles_v;  // < 2^31 (the plan checks)
  const int n_mine = walker < n_tiles ? (n_tiles - 1 - walker) / n_walkers + 1
                                      : 0;
  // cp.async roles: lane (group, vector), pixel slot.
  const int lanes = 4 * FV, ny = nt / lanes;
  const int cgrp = (tid % lanes) / FV, ccv = tid % FV, cpy = tid / lanes;

  // Copies of the walk's tile number `it` into stage it % stages.
  auto load = [&](int it) {
    if (it >= n_mine) return;
    const int t = walker + it * n_walkers;
    const int tv = t % tiles_v, bt = t / tiles_v;
    const int tu = bt % tiles_u, b = bt / tiles_u;
    const int u0 = tu * kFwdU, v0 = tv * kFwdV;
    const int s = it % stages;
    const unsigned stage = smem_u32 + (unsigned)(s * stage_bytes);
    if constexpr (kTma) {
      if (tid == 0) {
        const unsigned bar = bar0 + 8 * s;
        // Earlier reads of this stage come before the copy's writes.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, (unsigned)(kFwdRows * 4 * kFwdCols * FC *
                                       (int)sizeof(T)));
        tma_load_5d(stage, &ymap, bar, chunk * FC, v0 - 1, 0, u0 - 1, b);
      }
    } else {
      const T* src = ys + (((long long)b * U + u0) * V + v0) * c4 +
                     cgrp * O + chunk * FC + ccv * N;
      for (int pix = cpy; pix < kFwdRows * kFwdCols; pix += ny) {
        const int r = pix / kFwdCols, c = pix % kFwdCols;
        if ((unsigned)(u0 + r - 1) >= (unsigned)U ||
            (unsigned)(v0 + c - 1) >= (unsigned)V)
          continue;
        cp_async<(int)sizeof(Vv)>(
            stage + (unsigned)((((r * 4 + cgrp) * kFwdCols + c) * FC +
                                ccv * N) * (int)sizeof(T)),
            src + ((r - 1) * V + c - 1) * c4);
      }
    }
  };

  for (int it = 0; it < stages - 1; ++it) {
    load(it);
    if constexpr (!kTma) cp_async_commit();
  }
  const float ninf = -CUDART_INF_F;
  const int gs = kFwdCols * FC, rstride = 4 * gs;  // group, row strides
  for (int it = 0; it < n_mine; ++it) {
    load(it + stages - 1);
    const int s = it % stages;
    if constexpr (kTma) {
      mbar_wait(bar0 + 8 * s, (unsigned)(it / stages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait_upto(stages - 1);  // this tile's copies have landed
      __syncthreads();
    }

    const int t = walker + it * n_walkers;
    const int tv = t % tiles_v, bt = t / tiles_v;
    const int tu = bt % tiles_u, b = bt / tiles_u;
    const int u0 = tu * kFwdU, v0 = tv * kFwdV;
    const int j = v0 + oj;
    if (j < V && u0 + r0 < U) {
      const T* ysb = reinterpret_cast<const T*>(smem + s * stage_bytes);
      // Stage row r0 holds map row u0 + r0 - 1; column oj + 1 holds j.
      const T* here = ysb + r0 * rstride + (oj + 1) * FC + cv * N;
      const bool left = j > 0, up = u0 + r0 > 0;
      auto aff = [&](const T* p, float (&z)[N]) {
        const Vv x = *reinterpret_cast<const Vv*>(p);
#pragma unroll
        for (int k = 0; k < N; ++k)
          z[k] = __fadd_rn(__fmul_rn(to_f(x.v[k]), sc[k]), sh[k]);
      };
      // Column stage of group g at the row of `p`: max of columns j-1, j.
      auto col = [&](const T* p, float (&z)[N]) {
        float l[N];
        aff(p, z);
        aff(p - FC, l);
#pragma unroll
        for (int k = 0; k < N; ++k) z[k] = fmaxf(left ? l[k] : ninf, z[k]);
      };
      // The row above: groups 2 and 3 after the column stage.
      float p2[N], p3[N];
      aff(here + 2 * gs, p2);
      col(here + 3 * gs, p3);
      if (!up) {
#pragma unroll
        for (int k = 0; k < N; ++k) p2[k] = p3[k] = ninf;
      }
      T* dst = out + (((long long)b * U + u0 + r0) * V + j) * O + f0;
      const int n_rows = min(R, U - u0 - r0);
      for (int r = 0; r < n_rows; ++r) {
        here += rstride;
        float a0[N], a1[N], a2[N], a3[N];
        aff(here, a0);
        col(here + gs, a1);
        aff(here + 2 * gs, a2);
        col(here + 3 * gs, a3);
        Vv o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          // Row stage (rows i-1, i) of groups 2 and 3, then the groups.
          const float m = fmaxf(fmaxf(a0[k], a1[k]),
                                fmaxf(fmaxf(p2[k], a2[k]), fmaxf(p3[k], a3[k])));
          o.v[k] = from_f<T>(fmaxf(m, 0.f));
          p2[k] = a2[k];
          p3[k] = a3[k];
        }
        *reinterpret_cast<Vv*>(dst + r * V * O) = o;
      }
    }
    __syncthreads();  // the stage is free for the load of tile it + stages
  }
  if constexpr (!kTma) cp_async_wait<0>();  // the groups past the walk's end
}

template <typename T, int N>
int launch_fwd(const void* ys, const void* scale, const void* shift,
               void* out, int B, int U, int V, int O, int FC, int RS,
               int stages, int n_walkers, int smem_bytes, void* stream) {
  const int threads = FC / N * kFwdV * RS;
  if (FC < N || FC % N || O % FC || RS < 1 || kFwdU % RS || stages < 2 ||
      stages > 4 || n_walkers < 1 || threads > kFwdMaxThreads ||
      smem_bytes < 128 + stages * (fwd_stage_bytes(FC, sizeof(T)) + 8))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * U * V == 0) return 0;
  CUtensorMap ymap{};
  if (N * sizeof(T) == 16) {
    const cuuint64_t sz = sizeof(T), o = O, v = V, u = U;
    // ys [B][U][V][4][O] read as [B][U][4][V][O]: groups before columns.
    const cuuint64_t yd[5] = {o, v, 4, u, (cuuint64_t)B};
    const cuuint64_t yst[4] = {4 * o * sz, o * sz, v * 4 * o * sz,
                               u * v * 4 * o * sz};
    const cuuint32_t yb[5] = {(cuuint32_t)FC, kFwdCols, 4, kFwdRows, 1};
    const int rc = encode<T>(&ymap, ys, 5, yd, yst, yb);
    if (rc) return rc;
  }
  auto kernel = bn_relu_pool_fwd_kernel<T, N>;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc) return rc;
  kernel<<<(O / FC) * n_walkers, threads, smem_bytes,
           (cudaStream_t)stream>>>(
      ymap, static_cast<const T*>(ys), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), B, U, V, O, FC,
      RS, stages);
  return (int)cudaGetLastError();
}

// The forward's entry: vec picks the instantiation (16 bytes' worth of
// channels by TMA, or one pair of channels by cp.async).
template <typename T, int NV>
int fwd(const void* ys, const void* scale, const void* shift, void* out,
        int B, int U, int V, int O, int vec, int fc, int rs, int stages,
        int n_walkers, int smem_bytes, void* stream) {
  if (vec == NV)
    return launch_fwd<T, NV>(ys, scale, shift, out, B, U, V, O, fc, rs,
                             stages, n_walkers, smem_bytes, stream);
  if (vec == 2)
    return launch_fwd<T, 2>(ys, scale, shift, out, B, U, V, O, fc, rs, stages,
                            n_walkers, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ys: [B, U, V, 4*O] contiguous (O even, O <= 512); scale, shift: f32 [O];
// g: [B, U, V, O]; dys: [B, U, V, 4*O]; partial: f32 [n_walkers, 2, 4*O].
// vec: channels per access (16 bytes' worth where O and the pointers allow,
// else 2); fc: channels per chunk; tile: BwdTile's; ny: pixel slots
// per block; smem_bytes: the plan's (ops/bn_pool.py::bwd_plan). Returns the
// cudaError_t of the launch.
extern "C" int bn_relu_pool_bwd_f32(const void* ys, const void* scale,
                                    const void* shift, const void* g,
                                    void* dys, void* partial, int B, int U,
                                    int V, int O, int vec, int fc, int tile_u,
                                    int tile_v, int n_walkers, int ny,
                                    int smem_bytes, void* stream) {
  if (tile_u != BwdTile<float>::U || tile_v != BwdTile<float>::V)
    return (int)cudaErrorInvalidValue;
  if (vec == 4)
    return launch_bwd<float, 4>(ys, scale, shift, g, dys, partial, B, U, V, O,
                                fc, n_walkers, ny, smem_bytes, stream);
  if (vec == 2)
    return launch_bwd<float, 2>(ys, scale, shift, g, dys, partial, B, U, V, O,
                                fc, n_walkers, ny, smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bn_relu_pool_bwd_bf16(const void* ys, const void* scale,
                                     const void* shift, const void* g,
                                     void* dys, void* partial, int B, int U,
                                     int V, int O, int vec, int fc,
                                     int tile_u, int tile_v, int n_walkers,
                                     int ny, int smem_bytes, void* stream) {
  if (tile_u != BwdTile<__nv_bfloat16>::U ||
      tile_v != BwdTile<__nv_bfloat16>::V)
    return (int)cudaErrorInvalidValue;
  if (vec == 8)
    return launch_bwd<__nv_bfloat16, 8>(ys, scale, shift, g, dys, partial, B,
                                        U, V, O, fc, n_walkers, ny,
                                        smem_bytes, stream);
  if (vec == 2)
    return launch_bwd<__nv_bfloat16, 2>(ys, scale, shift, g, dys, partial, B,
                                        U, V, O, fc, n_walkers, ny,
                                        smem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// ys: [B, U, V, 4*O] contiguous (O even, O <= 512); scale, shift: f32 [O];
// out: [B, U, V, O]. vec: channels per access (16 bytes' worth, by TMA,
// where O and the pointers allow; else 2, by cp.async); fc: channels per
// chunk; rs: row splits of the tile; stages: tile stages in flight;
// smem_bytes: the plan's (ops/bn_pool.py::fwd_plan).
// Returns the cudaError_t of the launch.
extern "C" int bn_relu_pool_fwd_f32(const void* ys, const void* scale,
                                    const void* shift, void* out, int B, int U,
                                    int V, int O, int vec, int fc, int rs,
                                    int stages, int n_walkers, int smem_bytes,
                                    void* stream) {
  return fwd<float, 4>(ys, scale, shift, out, B, U, V, O, vec, fc, rs, stages,
                       n_walkers, smem_bytes, stream);
}

extern "C" int bn_relu_pool_fwd_bf16(const void* ys, const void* scale,
                                     const void* shift, void* out, int B,
                                     int U, int V, int O, int vec, int fc,
                                     int rs, int stages, int n_walkers,
                                     int smem_bytes, void* stream) {
  return fwd<__nv_bfloat16, 8>(ys, scale, shift, out, B, U, V, O, vec, fc, rs,
                               stages, n_walkers, smem_bytes, stream);
}
