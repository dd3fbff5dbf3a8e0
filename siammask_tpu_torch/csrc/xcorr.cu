// Depthwise valid cross-correlation for Hopper (sm_90a), NHWC, and its two
// gradients.
//
//   out[b, i, j, c] = sum_{dy, dx} x[b, i + dy, j + dx, c] * k[b, dy, dx, c]
//
// Replaces the TPU kernel `depthwise_xcorr_pallas` (`_xcorr_kernel`) in
// siammask_tpu/ops/xcorr_pallas.py: the same map, fp32 accumulation in the
// same (dy, dx) tap order, output cast to the input type. It is not a
// block-by-block copy: the TPU kernel keeps a (Hx, Wx, 128-channel) slab in
// VMEM per grid step; here registers and L1 do that work.
//
// Channels are innermost everywhere, so the 32 lanes of a warp take 32
// neighbouring channels of one pixel and every load is one coalesced
// 128-byte (fp32) row per warp. There is no channel-multiple requirement:
// lanes past C idle.
//
// Tensor cores do not apply to any of the three kernels. A depthwise
// correlation shares no reduction across channels: per (b, c) it is a
// (taps x positions) matrix-vector product, 25 x 625 for SiamMask, so there
// is no K dimension for `wgmma` or `mma.sync` to tile. The kernels win by
// issuing fewer loads and moving fewer bytes, on the fp32 CUDA cores.
//
// Forward (`depthwise_xcorr_strip_kernel`, shared with grad-input below).
// A warp owns (b, 32-channel tile, strip of S = 5 outputs j0 ..
// j0+4 along a row, band of output rows); SiamMask's Wo = 25 is 5 strips,
// and a ragged last strip leaves its extra slots idle. A thread loads its
// channel's Hk x Wk taps into registers once and keeps a rolling window of
// the Hk input rows x[b, i+dy, j0 .. j0+S+Wk-2, c] that output row i needs:
// moving down one row loads one new input row (S+Wk-1 values, prefetched a
// row ahead) and each of the S accumulators takes Hk*Wk FMAs in (dy, dx)
// order, the TPU kernel's order, so the output is bit-identical to the
// one-thread-per-output version. Loads per output fall from 2*Hk*Wk (50) to
// ((S+Wk-1)*(band+Hk-1) + Hk*Wk) / (S*band): 2.7 at B=64 (bands of 13 rows),
// 14 at B=1, where the launcher shortens the bands to one row so that the
// grid holds 8 warps per SM (250 blocks for 132 SMs). Templates larger than
// the 5x5 register window (none on the model's paths) take
// `depthwise_xcorr_any_kernel`, one thread per output.
//
// The two gradients replace the backward of the trainable wrapper
// `depthwise_xcorr_ad` (its custom_vjp bwd, which differentiates the im2col
// form in XLA). With Ho = Hx - Hk + 1, Wo = Wx - Wk + 1 and g the upstream
// gradient (B, Ho, Wo, C):
//
//   grad-input:  dx[b, y, x, c] = sum_{dy, dx} g[b, y - dy, x - dx, c] * k[b, dy, dx, c]
//                over the taps with 0 <= y - dy < Ho and 0 <= x - dx < Wo
//                (a full correlation). It is the forward's map on g padded
//                with Hk-1 rows and Wk-1 columns of zeros on every side, with
//                the taps flipped, so it runs the forward's strip kernel
//                (`depthwise_xcorr_strip_kernel`, kFullCorr): the window
//                holds g rows y-4 .. y and columns x0-4 .. x0+4, rows and
//                columns outside g are zeros and are never loaded (the rows by
//                a warp-uniform branch), and acc[s] takes g[y-dy, x0+s-dx] *
//                k[dy, dx] in the same (dy, dx) order as the one-thread-per-
//                output kernel it replaces. A zero tap adds exactly 0 to an
//                fp32 sum, so the output equals that kernel's. SiamMask's
//                Wx = 29 is 6 strips, the last 4 wide. Loads per output fall
//                from up to 2*Hk*Wk (50) to at most 2.6 at B=64 (bands of 15
//                rows) and 7.9 at B=1 (bands of 2 rows, 180 blocks).
//                Templates larger than 5x5 take
//                `depthwise_xcorr_grad_input_any_kernel`, one thread per
//                element of dx with its taps clipped to g.
//   grad-kernel: dk[b, dy, dx, c] = sum_{i < Ho, j < Wo} x[b, i + dy, j + dx, c] * g[b, i, j, c]
//                fp32 (`depthwise_xcorr_grad_kernel_kernel`): a block owns one (b,
//                32-channel tile) and all taps of it, up to 5x5 (a larger
//                template takes one block per 5x5 group of taps). Its 8 warps
//                split the (chunk of 5 outputs along j, row i) items, each
//                warp walking down the rows of a chunk with a rolling window
//                of x rows, as the forward does. Per row a thread loads the
//                chunk's 5 values of g once for all its taps and one new x row
//                of 9 values; its 25 tap sums stay in registers: 14 loads per
//                125 FMAs, and g comes from DRAM/L2 once per (b, tile). The 8
//                warps' partial sums are added in warp order in shared memory:
//                no atomics, the same bits every call. Its grid has one block
//                a (b, tile): 8 at B=1, and at stage 2's 3x3 g 5 of the 8
//                warps have no item; in fp32 that is as fast as a wider split
//                was at B=1, so it stays.
//
// What bounds the three fp32 kernels (inferred from bytes and time; no
// hardware counters are read): at B=64 each moves ~98 MB (x or dx 55 MB, g
// or out 41 MB), which at the rate a plain copy reaches on an H100
// (~2.85 TB/s) takes ~34 us, against ~51 us measured for the forward and
// grad-kernel and ~56 us for grad-input; their FMAs take ~8 us and their
// load instructions are a few per output. What is left is memory latency:
// 116-128 registers a thread leave 16 warps an SM, each with one row of
// loads in flight. More loads in flight per warp cost registers and were
// slower (a second prefetched row, a fifth block per SM with spills).
// A three-stage cp.async ring per warp in shared memory was ~9% faster for
// grad-kernel in fp32 but is not used: cp.async copies at least 4 bytes, so
// bf16 and ragged C would need a second path. PERF.md has the times.
//
// bf16. The kernels' bf16 instantiations took 1.7-2x the fp32 kernels' time
// while they move half the bytes, at B=1 too (strip kernel 6.2 against
// 3.1-3.3 us; grad-kernel 23 against 13 us). Not for want of registers: ptxas
// gives the strip kernel 119 / 124 registers (forward / grad-input) and no
// spills against fp32's 116 / 118. Their loads are the cause: each 16-bit
// load is converted to float32 as it arrives, and ptxas issues them a few at
// a time behind those conversions, so a warp waits out one memory latency
// per few loads, where the fp32 kernel issues a row of loads at once. So the
// bf16 paths on the model's shapes (even C, templates up to 5x5, 4-byte
// aligned pointers) take packed kernels, two channels a lane in one 4-byte
// load: `depthwise_xcorr_strip_bf16x2_kernel` (forward, grad-input; bit for
// bit the scalar instantiation's output) and
// `depthwise_xcorr_grad_kernel_bf16x2_kernel` (grad-kernel). Packing halves
// the channel tiles, which the grad-kernel's one-block-a-(b, tile) grid could
// not afford (4 blocks at B=1, 256 at B=64), so the packed grad-kernel also
// splits each (b, tile) over a thread-block cluster of up to 8 blocks, each
// a band of x rows, and over tap rows where g is narrow (stage 2's 3x3 g:
// a warp a tap row, none idle), and reduces the partials through
// distributed shared memory in a fixed order. A cluster rather than a
// float32 scratch and a second pass: one launch, nothing allocated, and the
// partials never leave the GPC; its cost is the 8-block limit, which caps
// B=1 at 32 blocks. The scalar
// instantiations stay for odd C and misaligned pointers.
//
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kChannelTile = 32;  // threadIdx.x: one warp across channels
constexpr int kTapRows = 5;       // the template (or tap group) held in registers:
constexpr int kTapCols = 5;       // SiamMask's 5x5
constexpr int kStripWarps = 4;      // strip kernel: warps per block, each its own unit
constexpr int kStrip = 5;           // strip kernel: outputs along a row per thread
constexpr int kStripWarpsPerSM = 8; // strip kernel: bands are split until the grid has this many
constexpr int kStripBandRows = 16;  // strip kernel: the longest band of output rows
constexpr int kGradWarps = 8;       // grad-kernel, threadIdx.y: warps splitting the items
constexpr int kGradChunk = 5;       // grad-kernel: outputs along j per item

// dst[t] = p[t * c] for lo <= t < n, 0 elsewhere: one coalesced load per element.
template <typename T, int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const T* p, int c, int lo, int n) {
#pragma unroll
  for (int t = 0; t < N; ++t) dst[t] = t >= lo && t < n ? to_float(p[t * c]) : 0.0f;
}

// One output row of a strip, taps in (dy, dx) order. kFull: the template is
// exactly kTapRows x kTapCols.
//   valid (forward):     acc[s] = sum_{dy, dx} w[dy][s + dx] * kr[dy][dx]
//   kFull correlation:   acc[s] = sum_{dy, dx} w[kTapRows-1-dy][s + kTapCols-1-dx] * kr[dy][dx]
template <bool kFull, bool kFullCorr>
__device__ __forceinline__ void xcorr_row(float (&acc)[kStrip],
                                          const float (&w)[kTapRows][kStrip + kTapCols - 1],
                                          const float (&kr)[kTapRows][kTapCols], int hk, int wk) {
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy) {
    if (!kFull && dy >= hk) break;
    const int d = kFullCorr ? kTapRows - 1 - dy : dy;
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx) {
      if (!kFull && dx >= wk) break;
      const int t = kFullCorr ? kTapCols - 1 - dx : dx;
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[s] = fmaf(w[d][s + t], kr[dy][dx], acc[s]);
    }
  }
}

// A warp owns (b, strip of kStrip outputs along a row, band of output rows,
// 32 channels); units are numbered with the channel tile fastest. It reads
// src (b, hs, ws, c) and writes dst (b, hd, wd, c).
//   forward (kFullCorr false): src = x, dst = out; the window's row d holds
//     x row i + d, columns j0 .. j0 + kStrip + kTapCols - 2.
//   grad-input (kFullCorr true): src = g, dst = dx; the window starts
//     kTapRows - 1 rows above and kTapCols - 1 columns left of that, and g's
//     rows and columns outside g read as zero: the full correlation.
template <typename T, bool kFullCorr>
__global__ void __launch_bounds__(kChannelTile * kStripWarps)
    depthwise_xcorr_strip_kernel(const T* __restrict__ src, const T* __restrict__ k,
                                 T* __restrict__ dst, int hs, int ws, int c, int hk, int wk,
                                 int hd, int wd, int strips, int band, int bands,
                                 long long units) {
  constexpr int S = kStrip, W = S + kTapCols - 1;
  constexpr int oy = kFullCorr ? kTapRows - 1 : 0, ox = kFullCorr ? kTapCols - 1 : 0;
  const long long unit = (long long)blockIdx.x * kStripWarps + threadIdx.y;
  const int tiles = (c + kChannelTile - 1) / kChannelTile;
  const int ch = (int)(unit % tiles) * kChannelTile + threadIdx.x;
  if (unit >= units || ch >= c) return;
  long long rest = unit / tiles;
  const int i0 = (int)(rest % bands) * band;
  rest /= bands;
  const int j0 = (int)(rest % strips) * S;
  const long long b = rest / strips;
  const int i1 = min(hd, i0 + band);
  // window column t is src column j0 - ox + t; [lo, hi) lie inside src (and,
  // in the forward, under the strip's taps)
  const int lo = kFullCorr ? max(0, ox - j0) : 0;
  const int hi = kFullCorr ? min(W, ws - j0 + ox) : min(S + wk - 1, ws - j0);

  float kr[kTapRows][kTapCols];
  const T* kb = k + b * hk * wk * c + ch;
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy)
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx)
      kr[dy][dx] = dy < hk && dx < wk ? to_float(kb[(dy * wk + dx) * c]) : 0.0f;

  // w[d] holds src row i - oy + d; nx prefetches the row that output row
  // i + 1 adds. Rows outside src are zero and are never loaded.
  const long long row = (long long)ws * c;
  const T* sb = src + ((b * hs + i0) * ws + j0 - ox) * c + ch;  // src[b, i0, j0 - ox, ch]
  auto load_src = [&](float(&dst)[W], int r) {  // src row r
    const bool inside = (!kFullCorr || r >= 0) && r < hs;
    load_row(dst, sb + (r - i0) * row, c, lo, inside ? hi : 0);
  };
  float w[kTapRows][W], nx[W];
#pragma unroll
  for (int d = 0; d < kTapRows - 1; ++d) load_src(w[d], i0 - oy + d);
  load_src(nx, i0 - oy + kTapRows - 1);
  const bool full = hk == kTapRows && wk == kTapCols;
  T* ob = dst + ((b * hd + i0) * wd + j0) * c + ch;
  for (int i = i0; i < i1; ++i) {
#pragma unroll
    for (int t = 0; t < W; ++t) w[kTapRows - 1][t] = nx[t];
    if (i + 1 < i1) load_src(nx, i + 1 - oy + kTapRows - 1);
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.0f;
    if (full)
      xcorr_row<true, kFullCorr>(acc, w, kr, hk, wk);
    else
      xcorr_row<false, kFullCorr>(acc, w, kr, hk, wk);
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (j0 + s < wd) ob[(long long)(i - i0) * wd * c + s * c] = from_float<T>(acc[s]);
#pragma unroll
    for (int d = 0; d < kTapRows - 1; ++d)
#pragma unroll
      for (int t = 0; t < W; ++t) w[d][t] = w[d + 1][t];
  }
}

// ---- bf16, packed: the forward and grad-input of the bf16 model's paths ----
//
// `depthwise_xcorr_strip_bf16x2_kernel` keeps the strip kernel's design and
// removes the two costs of its bf16 instantiation (the header): a lane takes
// 2 * kPackWords neighbouring channels (a warp 64 with one word, one 128-byte
// line a load, as in fp32), and the taps and the rolling window stay packed
// in registers as raw words of two bf16 (one 32-bit register a channel pair,
// so the window costs what the fp32 kernel's one-channel window costs). The
// loads go straight into the window's registers, so a row of them issues at
// once, and a value is unpacked to float32 (exactly: a bf16 is the top half
// of its float32) only at its FMA. Each channel accumulates in float32 with
// fmaf in `xcorr_row`'s (dy, dx) order and is rounded to bf16 once, at the
// store, so the output is bit for bit the scalar instantiation's. The
// wrapper takes this kernel for bf16 when C is a multiple of 2 * kPackWords,
// the template at most kTapRows x kTapCols and every pointer 4 * kPackWords-
// byte aligned; the scalar instantiation otherwise. Four channels a lane
// (kPackWords = 2, 8-byte loads) took 255 registers with spills and was
// slower on the H100, as were other band splits and a 128-register cap
// (PERF.md, scripts/bench_xcorr_bf16.py).
constexpr int kPackWords = 1;        // 32-bit words of two bf16 a lane
constexpr int kPackedWarpsPerSM = 8; // as kStripWarpsPerSM, for the packed kernel
constexpr int kPackedBandRows = 16;  // as kStripBandRows, for the packed kernel

__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

// the two floats rounded to bf16 as `__float2bfloat16` rounds one
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (unsigned int)__bfloat16_as_ushort(v.x) |
         ((unsigned int)__bfloat16_as_ushort(v.y) << 16);
}

// dst = the P words at p, read as one 4P-byte load
template <int P>
__device__ __forceinline__ void load_words(unsigned int (&dst)[P], const __nv_bfloat16* p) {
  if constexpr (P == 1) {
    dst[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    static_assert(P == 2, "one or two words a lane");
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

template <int P>
__device__ __forceinline__ void store_words(__nv_bfloat16* p, const unsigned int (&src)[P]) {
  if constexpr (P == 1)
    *reinterpret_cast<unsigned int*>(p) = src[0];
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(src[0], src[1]);
}

// dst[t] = the words at p + t * c for lo <= t < n, 0 elsewhere.
template <int P, int N>
__device__ __forceinline__ void load_packed_row(unsigned int (&dst)[N][P],
                                                const __nv_bfloat16* p, int c, int lo, int n) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t >= lo && t < n) {
      load_words<P>(dst[t], p + t * c);
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) dst[t][q] = 0u;
    }
  }
}

// `xcorr_row` on packed words: channel 2q + h of the lane (h = 0 the low
// half) takes acc[2q + h][s], with the same FMAs in the same order.
template <int P, bool kFull, bool kFullCorr>
__device__ __forceinline__ void xcorr_row_packed(
    float (&acc)[2 * P][kStrip], const unsigned int (&w)[kTapRows][kStrip + kTapCols - 1][P],
    const unsigned int (&kr)[kTapRows][kTapCols][P], int hk, int wk) {
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy) {
    if (!kFull && dy >= hk) break;
    const int d = kFullCorr ? kTapRows - 1 - dy : dy;
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx) {
      if (!kFull && dx >= wk) break;
      const int t = kFullCorr ? kTapCols - 1 - dx : dx;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float k0 = bf16_lo(kr[dy][dx][q]), k1 = bf16_hi(kr[dy][dx][q]);
#pragma unroll
        for (int s = 0; s < kStrip; ++s) {
          acc[2 * q][s] = fmaf(bf16_lo(w[d][s + t][q]), k0, acc[2 * q][s]);
          acc[2 * q + 1][s] = fmaf(bf16_hi(w[d][s + t][q]), k1, acc[2 * q + 1][s]);
        }
      }
    }
  }
}

// `depthwise_xcorr_strip_kernel` for bf16 with 2P channels a lane: the same
// units, window, zero rows and columns and output order.
template <int P, bool kFullCorr>
__global__ void __launch_bounds__(kChannelTile * kStripWarps)
    depthwise_xcorr_strip_bf16x2_kernel(const __nv_bfloat16* __restrict__ src,
                                        const __nv_bfloat16* __restrict__ k,
                                        __nv_bfloat16* __restrict__ dst, int hs, int ws, int c,
                                        int hk, int wk, int hd, int wd, int strips, int band,
                                        int bands, long long units) {
  constexpr int V = 2 * P, S = kStrip, W = S + kTapCols - 1;
  constexpr int oy = kFullCorr ? kTapRows - 1 : 0, ox = kFullCorr ? kTapCols - 1 : 0;
  const long long unit = (long long)blockIdx.x * kStripWarps + threadIdx.y;
  const int tiles = (c + kChannelTile * V - 1) / (kChannelTile * V);
  const int ch = (int)(unit % tiles) * kChannelTile * V + threadIdx.x * V;
  if (unit >= units || ch >= c) return;
  long long rest = unit / tiles;
  const int i0 = (int)(rest % bands) * band;
  rest /= bands;
  const int j0 = (int)(rest % strips) * S;
  const long long b = rest / strips;
  const int i1 = min(hd, i0 + band);
  const int lo = kFullCorr ? max(0, ox - j0) : 0;
  const int hi = kFullCorr ? min(W, ws - j0 + ox) : min(S + wk - 1, ws - j0);

  unsigned int kr[kTapRows][kTapCols][P];
  const __nv_bfloat16* kb = k + b * hk * wk * c + ch;
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy)
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx) {
      if (dy < hk && dx < wk) {
        load_words<P>(kr[dy][dx], kb + (dy * wk + dx) * c);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) kr[dy][dx][q] = 0u;
      }
    }

  const long long row = (long long)ws * c;
  const __nv_bfloat16* sb = src + ((b * hs + i0) * ws + j0 - ox) * c + ch;
  auto load_src = [&](unsigned int(&d)[W][P], int r) {  // src row r
    const bool inside = (!kFullCorr || r >= 0) && r < hs;
    load_packed_row<P>(d, sb + (r - i0) * row, c, lo, inside ? hi : 0);
  };
  unsigned int w[kTapRows][W][P], nx[W][P];
#pragma unroll
  for (int d = 0; d < kTapRows - 1; ++d) load_src(w[d], i0 - oy + d);
  load_src(nx, i0 - oy + kTapRows - 1);
  const bool full = hk == kTapRows && wk == kTapCols;
  __nv_bfloat16* ob = dst + ((b * hd + i0) * wd + j0) * c + ch;
  for (int i = i0; i < i1; ++i) {
#pragma unroll
    for (int t = 0; t < W; ++t)
#pragma unroll
      for (int q = 0; q < P; ++q) w[kTapRows - 1][t][q] = nx[t][q];
    if (i + 1 < i1) load_src(nx, i + 1 - oy + kTapRows - 1);
    float acc[V][S];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[v][s] = 0.0f;
    if (full)
      xcorr_row_packed<P, true, kFullCorr>(acc, w, kr, hk, wk);
    else
      xcorr_row_packed<P, false, kFullCorr>(acc, w, kr, hk, wk);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (j0 + s < wd) {
        unsigned int out[P];
#pragma unroll
        for (int q = 0; q < P; ++q) out[q] = pack_bf16x2(acc[2 * q][s], acc[2 * q + 1][s]);
        store_words<P>(ob + (long long)(i - i0) * wd * c + s * c, out);
      }
    }
#pragma unroll
    for (int d = 0; d < kTapRows - 1; ++d)
#pragma unroll
      for (int t = 0; t < W; ++t)
#pragma unroll
        for (int q = 0; q < P; ++q) w[d][t][q] = w[d + 1][t][q];
  }
}

// Templates larger than kTapRows x kTapCols (none on the model's paths): one
// thread per output element.
template <typename T>
__global__ void depthwise_xcorr_any_kernel(const T* __restrict__ x, const T* __restrict__ k,
                                           T* __restrict__ out, int hx, int wx, int c, int hk,
                                           int wk, int ho, int wo, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  long long t = idx / c;
  const int ox = (int)(t % wo);
  t /= wo;
  const int oy = (int)(t % ho);
  const long long b = t / ho;
  const T* xb = x + b * hx * wx * c + ch;
  const T* kb = k + b * hk * wk * c + ch;
  float acc = 0.0f;
  for (int dy = 0; dy < hk; ++dy) {
    const T* xrow = xb + ((long long)(oy + dy) * wx + ox) * c;
    const T* krow = kb + (long long)dy * wk * c;
    for (int dx = 0; dx < wk; ++dx)
      acc = fmaf(to_float(xrow[(long long)dx * c]), to_float(krow[(long long)dx * c]), acc);
  }
  out[idx] = from_float<T>(acc);
}

// grad-input for templates larger than kTapRows x kTapCols (none on the
// model's paths): one thread per element of dx, its taps clipped to g.
template <typename T>
__global__ void depthwise_xcorr_grad_input_any_kernel(const T* __restrict__ g,
                                                      const T* __restrict__ k, T* __restrict__ dx,
                                                      int hx, int wx, int c, int hk, int wk,
                                                      int ho, int wo, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int ch = (int)(idx % c);
  long long t = idx / c;
  const int x = (int)(t % wx);
  t /= wx;
  const int y = (int)(t % hx);
  const long long b = t / hx;

  // taps with 0 <= y - dy < ho and 0 <= x - dx < wo
  const int dy0 = max(0, y - ho + 1), dy1 = min(hk - 1, y);
  const int dx0 = max(0, x - wo + 1), dx1 = min(wk - 1, x);
  const T* gb = g + b * ho * wo * c + ch;
  const T* kb = k + b * hk * wk * c + ch;
  float acc = 0.0f;
  for (int dy = dy0; dy <= dy1; ++dy) {
    const T* grow = gb + (long long)(y - dy) * wo * c;
    const T* krow = kb + (long long)dy * wk * c;
    for (int tx = dx0; tx <= dx1; ++tx) {
      acc = fmaf(to_float(grow[(long long)(x - tx) * c]), to_float(krow[(long long)tx * c]), acc);
    }
  }
  dx[idx] = from_float<T>(acc);
}

// One item of grad-kernel: acc[dy][dx] += sum_jj w[dy][jj + dx] * gr[jj].
// kFull: all kTapRows x kTapCols taps and a whole chunk of kGradChunk outputs.
template <bool kFull>
__device__ __forceinline__ void grad_kernel_item(
    float (&acc)[kTapRows][kTapCols], const float (&w)[kTapRows][kGradChunk + kTapCols - 1],
    const float (&gr)[kGradChunk], int th, int tw, int n) {
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy) {
    if (!kFull && dy >= th) break;
#pragma unroll
    for (int jj = 0; jj < kGradChunk; ++jj) {
      if (!kFull && jj >= n) break;
#pragma unroll
      for (int dx = 0; dx < kTapCols; ++dx) {
        if (!kFull && dx >= tw) break;
        acc[dy][dx] = fmaf(w[dy][jj + dx], gr[jj], acc[dy][dx]);
      }
    }
  }
}

// One block per (32-channel tile, tap group, b). A tap group is gh x gw taps
// (gh <= kTapRows, gw <= kTapCols) starting at (dy0, dx0); blockIdx.y numbers
// the groups row-major, groups_x to a row. The items are (chunk of kGradChunk
// outputs along j, row i), rows fastest; warp w takes a contiguous run of
// them, so it walks down the rows of a chunk with a rolling window of x rows.
template <typename T>
__global__ void __launch_bounds__(kChannelTile * kGradWarps)
    depthwise_xcorr_grad_kernel_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                       T* __restrict__ dk, int hx, int wx, int c, int hk, int wk,
                                       int ho, int wo, int gh, int gw, int groups_x) {
  constexpr int W = kGradChunk + kTapCols - 1;
  __shared__ float partial[kGradWarps][kTapRows * kTapCols][kChannelTile];
  const int ch = blockIdx.x * kChannelTile + threadIdx.x;
  const int dy0 = (blockIdx.y / groups_x) * gh;
  const int dx0 = (blockIdx.y % groups_x) * gw;
  const int th = min(gh, hk - dy0), tw = min(gw, wk - dx0);  // this group's taps
  const long long b = blockIdx.z;

  float acc[kTapRows][kTapCols];
#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy)
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx) acc[dy][dx] = 0.0f;

  if (ch < c) {
    const long long row = (long long)wx * c;
    const T* xb = x + ((b * hx + dy0) * wx + dx0) * c + ch;  // x[b, dy0, dx0, ch]
    const T* gb = g + b * ho * wo * c + ch;
    const int chunks = (wo + kGradChunk - 1) / kGradChunk;
    const int per = (ho * chunks + kGradWarps - 1) / kGradWarps;
    const int first = threadIdx.y * per, last = min(ho * chunks, first + per);
    for (int item = first; item < last;) {
      // a run down the rows of one chunk: w[d] holds x row dy0 + i + d,
      // nx and ng prefetch what the next row needs
      const int chunk = item / ho;
      const int i0 = item - chunk * ho, i1 = min(ho, i0 + last - item);
      const int j0 = chunk * kGradChunk;
      const int n = min(kGradChunk, wo - j0);  // valid outputs in the chunk
      const int loads = n + tw - 1;
      const T* xc = xb + (long long)j0 * c;
      const T* gc = gb + (long long)j0 * c;
      auto load_x = [&](float(&dst)[W], int r) {  // x row dy0 + r
        load_row(dst, xc + r * row, c, 0, dy0 + r < hx ? loads : 0);
      };
      auto load_g = [&](float(&dst)[kGradChunk], int r) {  // g row r
        load_row(dst, gc + (long long)r * wo * c, c, 0, n);
      };
      float w[kTapRows][W], nx[W], gr[kGradChunk], ng[kGradChunk];
#pragma unroll
      for (int d = 0; d < kTapRows - 1; ++d) load_x(w[d], i0 + d);
      load_x(nx, i0 + kTapRows - 1);
      load_g(ng, i0);
      const bool full = th == kTapRows && tw == kTapCols && n == kGradChunk;
      for (int i = i0; i < i1; ++i) {
#pragma unroll
        for (int t = 0; t < W; ++t) w[kTapRows - 1][t] = nx[t];
#pragma unroll
        for (int t = 0; t < kGradChunk; ++t) gr[t] = ng[t];
        if (i + 1 < i1) {
          load_x(nx, i + kTapRows);
          load_g(ng, i + 1);
        }
        if (full)
          grad_kernel_item<true>(acc, w, gr, th, tw, n);
        else
          grad_kernel_item<false>(acc, w, gr, th, tw, n);
#pragma unroll
        for (int d = 0; d < kTapRows - 1; ++d)
#pragma unroll
          for (int t = 0; t < W; ++t) w[d][t] = w[d + 1][t];
      }
      item += i1 - i0;
    }
  }

#pragma unroll
  for (int dy = 0; dy < kTapRows; ++dy)
#pragma unroll
    for (int dx = 0; dx < kTapCols; ++dx)
      partial[threadIdx.y][dy * kTapCols + dx][threadIdx.x] = acc[dy][dx];
  __syncthreads();
  // each tap's warp partials, added in warp order
  for (int t = threadIdx.y; t < th * tw; t += kGradWarps) {
    const int dy = t / tw, dx = t - dy * tw;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kGradWarps; ++w) sum += partial[w][dy * kTapCols + dx][threadIdx.x];
    if (ch < c) dk[((b * hk + dy0 + dy) * wk + dx0 + dx) * c + ch] = from_float<T>(sum);
  }
}

// ---- bf16, packed: the grad-kernel of the bf16 model's paths ----
//
// `depthwise_xcorr_grad_kernel_bf16x2_kernel` (the header has why it exists).
// A cluster of K blocks owns one (b, tile of 2 * P * 32 channels); P words of
// two bf16 a lane, loaded as one 4P-byte word and unpacked at the FMA, as in
// the packed strip kernel. Its work is split into segments, one a (group of
// gh tap rows dy0 .., chunk of kGradChunk outputs along j), each of the
// Ho + gh - 1 x rows dy0 + u that the group's taps meet; the segments' x
// rows are numbered one after another. The cluster's warps take contiguous,
// balanced slices of them, slice y * K + r for warp y of block r: with the
// launcher's choice of blockDim.y = segments and K bands of x rows, warp y
// of every block takes segment y and block r band r, so a warp walks one
// band of x rows of one chunk, and a block's warps walk the same x rows in
// step, side by side, and share through L1 the 4 columns their chunks
// overlap. A warp keeps the g rows in a rolling window: x row dy0 + u meets
// g rows u - d for the group's tap rows d, so a step loads one x row (n + wk
// - 1 words) and one g row (n words), a step ahead, for
// gh * n * wk * 2P FMAs; the window's first g rows (up to 4, the band's
// start) are loaded at once with its first x row, so a band of R x rows
// waits out about R + 1 memory latencies. The window holds g (5 x 5 words),
// not x (5 x 9): the 50 float32 accumulators (25 taps x 2 channels) and the
// window take ~150 registers, two blocks of 5 warps an SM. Each band adds
// its sums into the warp's partials in shared memory; the block adds its
// warps' partials in warp order, and after a cluster barrier the cluster's
// warps add the K blocks' sums of each tap in rank order through
// distributed shared memory, round to bf16 once and store. A one-block
// cluster (B=64) stores its block's sums with no cluster barrier, and
// where every tap is one warp's alone (stage 2: a warp a tap row, one
// chunk) the warp stores its sums with no partials at all: the barriers
// and the shared-memory passes cost ~2-3 us a call. Every addition has a
// fixed place, so two calls give the same bits; the order differs from
// the scalar kernel's, so the two differ by at most a bf16 step.
// What bounds it (scripts/bench_xcorr_bf16.py's diagnostics, PERF.md on an
// H100): the loads' latency, with one row in flight a warp and 10 warps an
// SM; its FMAs alone take about two thirds of its time at B=64. None of
// the bench's variants is faster at B=64 (four channels a lane, a
// 136-register cap, other cluster sizes), nor were two rows in flight in
// registers (one block an SM) or a per-warp cp.async ring in shared memory,
// tried and not kept.
constexpr int kGradPackWords = 1;         // 32-bit words of two bf16 a lane
constexpr int kGradPackedMaxWarps = 8;    // warps a block, at most
constexpr int kGradPackedMaxCluster = 8;  // blocks a cluster: the portable maximum
constexpr int kGradPackedWaves = 1;       // waves of resident blocks the grid aims at

// One x row of a run: acc[d][dx] += sum_jj xr[jj + dx] * gw[d][jj] over the
// window rows d whose g row is in the run (bit d of live); channel 2q + h of
// the lane takes half h of word q. kFull: gh = kTapRows, wk = kTapCols and a
// whole chunk.
template <int P, bool kFull>
__device__ __forceinline__ void grad_kernel_row_packed(
    float (&acc)[kTapRows][kTapCols][2 * P],
    const unsigned int (&xr)[kGradChunk + kTapCols - 1][P],
    const unsigned int (&gw)[kTapRows][kGradChunk][P], unsigned int live, int th, int n,
    int wk) {
#pragma unroll
  for (int d = 0; d < kTapRows; ++d) {
    if (!kFull && d >= th) break;
    if (!((live >> d) & 1u)) continue;
#pragma unroll
    for (int jj = 0; jj < kGradChunk; ++jj) {
      if (!kFull && jj >= n) break;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const float g0 = bf16_lo(gw[d][jj][q]), g1 = bf16_hi(gw[d][jj][q]);
#pragma unroll
        for (int dx = 0; dx < kTapCols; ++dx) {
          if (!kFull && dx >= wk) break;
          acc[d][dx][2 * q] = fmaf(bf16_lo(xr[jj + dx][q]), g0, acc[d][dx][2 * q]);
          acc[d][dx][2 * q + 1] = fmaf(bf16_hi(xr[jj + dx][q]), g1, acc[d][dx][2 * q + 1]);
        }
      }
    }
  }
}

// grid (K, channel tiles, B), cluster (K, 1, 1), block (32, warps <=
// kGradPackedMaxWarps); dynamic shared memory: float partial[warps][kTapRows *
// kTapCols][64 P].
template <int P>
__global__ void __launch_bounds__(kChannelTile * kGradPackedMaxWarps)
    depthwise_xcorr_grad_kernel_bf16x2_kernel(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ g,
                                              __nv_bfloat16* __restrict__ dk, int hx, int wx,
                                              int c, int hk, int wk, int ho, int wo, int gh,
                                              bool direct) {
  constexpr int V = 2 * P, W = kGradChunk + kTapCols - 1, T = kTapRows * kTapCols;
  constexpr int L = kChannelTile * V;  // channels a tile
  extern __shared__ __align__(16) float partial[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int per_block = blockDim.y, warps = blocks * per_block;
  const int ch = blockIdx.y * L + threadIdx.x * V;
  const long long b = blockIdx.z;
  float* mine = partial + threadIdx.y * T * L + threadIdx.x * V;
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) mine[t * L + v] = 0.0f;

  if (ch < c) {
    const int span = ho + gh - 1;  // x rows a segment's group of tap rows meets
    const int per_group = (wo + kGradChunk - 1) / kGradChunk * span;
    const int items = (hk + gh - 1) / gh * per_group;
    const int slice = threadIdx.y * blocks + rank;
    const int first = (int)((long long)items * slice / warps);
    const int last = (int)((long long)items * (slice + 1) / warps);
    const long long row_x = (long long)wx * c, row_g = (long long)wo * c;
    for (int item = first; item < last;) {
      const int group = item / per_group, rest = item - group * per_group;
      const int chunk = rest / span, u0 = rest - chunk * span;
      const int u1 = min(span, u0 + last - item);  // x rows dy0 + u0 .. dy0 + u1 - 1
      item += u1 - u0;
      const int dy0 = group * gh, th = min(gh, hk - dy0);
      const int end = min(u1, ho + th - 1);  // a shorter last group meets fewer x rows
      if (u0 >= end) continue;
      const int j0 = chunk * kGradChunk, n = min(kGradChunk, wo - j0);
      // x row dy0 + u at xc + u * row_x, g row i at gc + i * row_g
      const __nv_bfloat16* xc = x + ((b * hx + dy0) * wx + j0) * c + ch;
      const __nv_bfloat16* gc = g + (b * ho * wo + j0) * c + ch;
      float acc[kTapRows][kTapCols][V];
      // gw: the g window; nx, ng: the next x and g rows, in flight
      unsigned int gw[kTapRows][kGradChunk][P], xr[W][P], nx[W][P], ng[kGradChunk][P];
#pragma unroll
      for (int d = 0; d < kTapRows; ++d)
#pragma unroll
        for (int t = 0; t < kTapCols; ++t)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[d][t][v] = 0.0f;
      // x row dy0 + u and g row u, g rows past g read as zero
      auto load = [&](int u) {
        load_packed_row<P>(nx, xc + u * row_x, c, 0, n + wk - 1);
        load_packed_row<P>(ng, gc + min(u, ho - 1) * row_g, c, 0, u < ho ? n : 0);
      };
      // the window before x row u0 (gw[d - 1] holds g row u0 - d) and the
      // first rows, all loaded at once
#pragma unroll
      for (int d = 1; d < kTapRows; ++d) {
        const int i = u0 - d;
        const bool in = d < th && i >= 0 && i < ho;
        load_packed_row<P>(gw[d - 1], gc + (in ? i : 0) * row_g, c, 0, in ? n : 0);
      }
      load(u0);
      const bool full = th == kTapRows && wk == kTapCols && n == kGradChunk;
      for (int u = u0; u < end; ++u) {
        // window row d holds g row u - d; it is in g for lo <= d <= hi
#pragma unroll
        for (int d = kTapRows - 1; d > 0; --d)
#pragma unroll
          for (int t = 0; t < kGradChunk; ++t)
#pragma unroll
            for (int p = 0; p < P; ++p) gw[d][t][p] = gw[d - 1][t][p];
#pragma unroll
        for (int t = 0; t < kGradChunk; ++t)
#pragma unroll
          for (int p = 0; p < P; ++p) gw[0][t][p] = ng[t][p];
#pragma unroll
        for (int t = 0; t < W; ++t)
#pragma unroll
          for (int p = 0; p < P; ++p) xr[t][p] = nx[t][p];
        if (u + 1 < end) load(u + 1);
        const int lo = max(0, u - ho + 1), hi = min(kTapRows - 1, u);
        const unsigned int live = ((2u << hi) - 1u) & ~((1u << lo) - 1u);
        if (full)
          grad_kernel_row_packed<P, true>(acc, xr, gw, live, th, n, wk);
        else
          grad_kernel_row_packed<P, false>(acc, xr, gw, live, th, n, wk);
      }
#pragma unroll
      for (int d = 0; d < kTapRows; ++d) {
        if (d >= th) break;
#pragma unroll
        for (int dx = 0; dx < kTapCols; ++dx) {
          if (dx >= wk) break;
          if (direct) {  // this warp's taps are its own: store them
            unsigned int out[P];
#pragma unroll
            for (int q = 0; q < P; ++q)
              out[q] = pack_bf16x2(acc[d][dx][2 * q], acc[d][dx][2 * q + 1]);
            store_words<P>(dk + ((b * hk + dy0 + d) * wk + dx) * c + ch, out);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              mine[((dy0 + d) * kTapCols + dx) * L + v] += acc[d][dx][v];
          }
        }
      }
    }
  }
  if (direct) return;  // the whole grid: nothing to add up

  __syncthreads();
  if (blocks == 1) {  // each tap's warp partials, added in warp order and stored
    for (int t = threadIdx.y; t < T; t += per_block) {
      const int dy = t / kTapCols, dx = t - dy * kTapCols;
      if (dy >= hk || dx >= wk || ch >= c) continue;
      const float* p = partial + t * L + threadIdx.x * V;
      unsigned int out[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        float sum0 = p[2 * q], sum1 = p[2 * q + 1];
        for (int w = 1; w < per_block; ++w) {
          sum0 += p[w * T * L + 2 * q];
          sum1 += p[w * T * L + 2 * q + 1];
        }
        out[q] = pack_bf16x2(sum0, sum1);
      }
      store_words<P>(dk + ((b * hk + dy) * wk + dx) * c + ch, out);
    }
    return;
  }
  // each tap's warp partials, added in warp order into warp 0's
  for (int t = threadIdx.y; t < T; t += per_block) {
    float* p = partial + t * L + threadIdx.x * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float sum = p[v];
      for (int w = 1; w < per_block; ++w) sum += p[w * T * L + v];
      p[v] = sum;
    }
  }
  cluster.sync();
  // each tap's block sums, added in rank order, by one of the cluster's warps
  for (int t = rank * per_block + threadIdx.y; t < T; t += warps) {
    const int dy = t / kTapCols, dx = t - dy * kTapCols;
    if (dy >= hk || dx >= wk) continue;
    float sum[V] = {};
    for (int r = 0; r < blocks; ++r) {
      const float* p = cluster.map_shared_rank(partial + t * L + threadIdx.x * V, r);
#pragma unroll
      for (int v = 0; v < V; ++v) sum[v] = r == 0 ? p[v] : sum[v] + p[v];
    }
    if (ch < c) {
      unsigned int out[P];
#pragma unroll
      for (int p = 0; p < P; ++p) out[p] = pack_bf16x2(sum[2 * p], sum[2 * p + 1]);
      store_words<P>(dk + ((b * hk + dy) * wk + dx) * c + ch, out);
    }
  }
  cluster.sync();  // the peers' shared memory stays until every block has read it
}

// The forward (kFullCorr false: src = x (hx, wx), dst = out (ho, wo)) or
// grad-input (kFullCorr true: src = g (ho, wo), dst = dx (hx, wx)).
template <typename T, bool kFullCorr>
cudaError_t launch(const void* src_, const void* k_, void* dst_, int b, int hx, int wx, int c,
                   int hk, int wk, int device, cudaStream_t stream) {
  const int ho = hx - hk + 1, wo = wx - wk + 1;
  const int hs = kFullCorr ? ho : hx, ws = kFullCorr ? wo : wx;
  const int hd = kFullCorr ? hx : ho, wd = kFullCorr ? wx : wo;
  const long long total = (long long)b * hd * wd * c;
  if (total == 0) return cudaSuccess;
  const T* src = static_cast<const T*>(src_);
  const T* k = static_cast<const T*>(k_);
  T* dst = static_cast<T*>(dst_);
  if (hk > kTapRows || wk > kTapCols) {
    const unsigned int blocks = (unsigned int)((total + 255) / 256);
    if constexpr (kFullCorr)
      depthwise_xcorr_grad_input_any_kernel<T><<<blocks, 256, 0, stream>>>(
          src, k, dst, hx, wx, c, hk, wk, ho, wo, total);
    else
      depthwise_xcorr_any_kernel<T><<<blocks, 256, 0, stream>>>(src, k, dst, hx, wx, c, hk, wk,
                                                                ho, wo, total);
    return cudaGetLastError();
  }
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // bands of at most kStripBandRows output rows, shorter ones (down to one
  // row) while the grid has fewer than kStripWarpsPerSM warps per SM
  const int strips = (wd + kStrip - 1) / kStrip;
  const long long columns = (long long)b * ((c + kChannelTile - 1) / kChannelTile) * strips;
  const long long fill = ((long long)kStripWarpsPerSM * sms + columns - 1) / columns;
  const int split = (int)std::min<long long>(
      hd, std::max<long long>(fill, (hd + kStripBandRows - 1) / kStripBandRows));
  const int band = (hd + split - 1) / split;
  const int bands = (hd + band - 1) / band;
  const long long units = columns * bands;
  depthwise_xcorr_strip_kernel<T, kFullCorr>
      <<<(unsigned int)((units + kStripWarps - 1) / kStripWarps),
         dim3(kChannelTile, kStripWarps), 0, stream>>>(src, k, dst, hs, ws, c, hk, wk, hd, wd,
                                                       strips, band, bands, units);
  return cudaGetLastError();
}

// The packed bf16 forward or grad-input (the arguments as `launch`'s). It
// returns cudaErrorInvalidValue for what the packed kernel does not take: a
// template larger than kTapRows x kTapCols, C not a multiple of 2 * kPackWords
// or a pointer not 4 * kPackWords-byte aligned (the wrapper sends those to
// the scalar kernel).
template <bool kFullCorr>
cudaError_t launch_bf16x2(const void* src_, const void* k_, void* dst_, int b, int hx, int wx,
                          int c, int hk, int wk, int device, cudaStream_t stream) {
  constexpr int V = 2 * kPackWords, align = 4 * kPackWords;
  if (hk > kTapRows || wk > kTapCols || c % V != 0 ||
      reinterpret_cast<uintptr_t>(src_) % align != 0 ||
      reinterpret_cast<uintptr_t>(k_) % align != 0 ||
      reinterpret_cast<uintptr_t>(dst_) % align != 0)
    return cudaErrorInvalidValue;
  const int ho = hx - hk + 1, wo = wx - wk + 1;
  const int hs = kFullCorr ? ho : hx, ws = kFullCorr ? wo : wx;
  const int hd = kFullCorr ? hx : ho, wd = kFullCorr ? wx : wo;
  if ((long long)b * hd * wd * c == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // bands of at most kPackedBandRows output rows, shorter ones (down to one
  // row) while the grid has fewer than kPackedWarpsPerSM warps per SM
  const int strips = (wd + kStrip - 1) / kStrip;
  const long long columns = (long long)b * ((c + kChannelTile * V - 1) / (kChannelTile * V)) *
                            strips;
  const long long fill = ((long long)kPackedWarpsPerSM * sms + columns - 1) / columns;
  const int split = (int)std::min<long long>(
      hd, std::max<long long>(fill, (hd + kPackedBandRows - 1) / kPackedBandRows));
  const int band = (hd + split - 1) / split;
  const int bands = (hd + band - 1) / band;
  const long long units = columns * bands;
  depthwise_xcorr_strip_bf16x2_kernel<kPackWords, kFullCorr>
      <<<(unsigned int)((units + kStripWarps - 1) / kStripWarps),
         dim3(kChannelTile, kStripWarps), 0, stream>>>(
          static_cast<const __nv_bfloat16*>(src_), static_cast<const __nv_bfloat16*>(k_),
          static_cast<__nv_bfloat16*>(dst_), hs, ws, c, hk, wk, hd, wd, strips, band, bands,
          units);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad_kernel(const void* x, const void* g, void* dk, int b, int hx, int wx, int c,
                               int hk, int wk, cudaStream_t stream) {
  if ((long long)b * hk * wk * c == 0) return cudaSuccess;
  const int tiles = (c + kChannelTile - 1) / kChannelTile;
  const int gh = std::min(hk, kTapRows), gw = std::min(wk, kTapCols);
  const int groups_x = (wk + gw - 1) / gw;
  const dim3 grid(tiles, ((hk + gh - 1) / gh) * groups_x, b);
  depthwise_xcorr_grad_kernel_kernel<T><<<grid, dim3(kChannelTile, kGradWarps), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dk), hx, wx, c, hk, wk,
      hx - hk + 1, wx - wk + 1, gh, gw, groups_x);
  return cudaGetLastError();
}

// The packed bf16 grad-kernel. It returns cudaErrorInvalidValue for what the
// packed kernel does not take (as `launch_bf16x2`). The split: a block's
// warps are the segments, (tap-row group, chunk) pairs: the 5 chunks of a
// 25-wide g with one group of all tap rows, or, where the chunks leave room
// in kGradPackedMaxWarps, groups of fewer tap rows (stage 2's 3x3 g: one
// chunk, five groups of one tap row, so that no warp idles); then K blocks
// a cluster, each a band of x rows, as many as fill kGradPackedWaves waves
// of the blocks the card holds at once over the B * tiles clusters, at
// most kGradPackedMaxCluster and a segment's x rows, and no more than lets
// one wave of the clusters be resident together
// (cudaOccupancyMaxActiveClusters).
cudaError_t launch_grad_kernel_bf16x2(const void* x, const void* g, void* dk, int b, int hx,
                                      int wx, int c, int hk, int wk, int device,
                                      cudaStream_t stream) {
  constexpr int V = 2 * kGradPackWords, align = 4 * kGradPackWords, L = kChannelTile * V;
  constexpr size_t kWarpBytes = sizeof(float) * kTapRows * kTapCols * L;  // a warp's partials
  if (hk > kTapRows || wk > kTapCols || c % V != 0 ||
      reinterpret_cast<uintptr_t>(x) % align != 0 ||
      reinterpret_cast<uintptr_t>(g) % align != 0 ||
      reinterpret_cast<uintptr_t>(dk) % align != 0)
    return cudaErrorInvalidValue;
  if ((long long)b * hk * wk * c == 0) return cudaSuccess;
  const int ho = hx - hk + 1, wo = wx - wk + 1;
  const auto kernel = depthwise_xcorr_grad_kernel_bf16x2_kernel<kGradPackWords>;
  // the device's occupancy, queried once a device and shape of launch and
  // kept, so that a launch inside CUDA-graph capture queries nothing
  // (0: not queried yet)
  constexpr int kDevices = 64;
  static int sms[kDevices], resident[kDevices][kGradPackedMaxWarps + 1];
  static int active[kDevices][kGradPackedMaxWarps + 1][kGradPackedMaxCluster + 1];
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (sms[device] == 0) {
    constexpr int kMaxBytes = (int)(kGradPackedMaxWarps * kWarpBytes);
    if (kMaxBytes > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBytes);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int chunks = (wo + kGradChunk - 1) / kGradChunk;
  const int groups = std::max(1, std::min(hk, kGradPackedMaxWarps / chunks));
  const int gh = (hk + groups - 1) / groups;
  const int warps = std::min(kGradPackedMaxWarps, (hk + gh - 1) / gh * chunks);
  const size_t smem = warps * kWarpBytes;
  if (resident[device][warps] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kChannelTile * warps, smem);
    if (err != cudaSuccess) return err;
    resident[device][warps] = std::max(n, 1);
  }
  const int tiles = (c + L - 1) / L;
  const long long pairs = (long long)b * tiles;
  const long long items = (long long)((hk + gh - 1) / gh) * chunks * (ho + gh - 1);
  int k = (int)std::max<long long>(
      1, std::min<long long>(
             std::min<long long>(kGradPackedMaxCluster, std::max<long long>(1, items / warps)),
             (long long)kGradPackedWaves * resident[device][warps] * sms[device] / pairs));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.blockDim = dim3(kChannelTile, warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  for (; k > 1; --k) {  // a wave of the clusters resident at once
    cluster.val.clusterDim.x = k;
    cfg.gridDim = dim3(k, tiles, b);
    int& n = active[device][warps][k];
    if (n == 0) {
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (n == 0) n = -1;  // queried: none fits
    }
    if ((long long)n * kGradPackedWaves >= pairs) break;
  }
  cluster.val.clusterDim.x = k;
  cfg.gridDim = dim3(k, tiles, b);
  // one block a (b, tile) whose warps are the tap groups of a one-chunk g:
  // each tap is one warp's alone, which stores it with no partials
  const bool direct = k == 1 && chunks == 1 && warps == (hk + gh - 1) / gh;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dk),
                           hx, wx, c, hk, wk, ho, wo, gh, direct);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() after the launch.
// dtype: 0 = float32, 1 = bfloat16. kernel: 0 = the kernel of that type (one
// channel a lane), 1 = the packed bf16 kernel of that entry (bf16 only; the
// Python wrapper chooses). Shapes are validated by the Python
// wrapper; (hk, wk) is always the template's size and (hx, wx) the search
// map's.
extern "C" int siammask_depthwise_xcorr(const void* x, const void* k, void* out, int b, int hx,
                                        int wx, int c, int hk, int wk, int dtype, int kernel,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kernel == 0)
    return (int)launch<float, false>(x, k, out, b, hx, wx, c, hk, wk, device, s);
  if (dtype == 1 && kernel == 0)
    return (int)launch<__nv_bfloat16, false>(x, k, out, b, hx, wx, c, hk, wk, device, s);
  if (dtype == 1 && kernel == 1)
    return (int)launch_bf16x2<false>(x, k, out, b, hx, wx, c, hk, wk, device, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int siammask_depthwise_xcorr_grad_input(const void* g, const void* k, void* dx, int b,
                                                   int hx, int wx, int c, int hk, int wk,
                                                   int dtype, int kernel, int device,
                                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kernel == 0)
    return (int)launch<float, true>(g, k, dx, b, hx, wx, c, hk, wk, device, s);
  if (dtype == 1 && kernel == 0)
    return (int)launch<__nv_bfloat16, true>(g, k, dx, b, hx, wx, c, hk, wk, device, s);
  if (dtype == 1 && kernel == 1)
    return (int)launch_bf16x2<true>(g, k, dx, b, hx, wx, c, hk, wk, device, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int siammask_depthwise_xcorr_grad_kernel(const void* x, const void* g, void* dk, int b,
                                                    int hx, int wx, int c, int hk, int wk,
                                                    int dtype, int kernel, int device,
                                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kernel == 0)
    return (int)launch_grad_kernel<float>(x, g, dk, b, hx, wx, c, hk, wk, s);
  if (dtype == 1 && kernel == 0)
    return (int)launch_grad_kernel<__nv_bfloat16>(x, g, dk, b, hx, wx, c, hk, wk, s);
  if (dtype == 1 && kernel == 1)
    return (int)launch_grad_kernel_bf16x2(x, g, dk, b, hx, wx, c, hk, wk, device, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* siammask_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
