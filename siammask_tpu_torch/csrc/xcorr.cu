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
//                A block owns one (b, 32-channel tile) and all taps of it, up
//                to 5x5 (a larger template takes one block per 5x5 group of
//                taps). Its 8 warps split the (chunk of 5 outputs along j,
//                row i) items, each warp walking down the rows of a chunk
//                with a rolling window of x rows, as the forward does. Per
//                row a thread loads the chunk's 5 values of g once for all
//                its taps and one new x row of 9 values; its 25 tap sums stay
//                in registers: 14 loads per 125 FMAs (against 2 loads per FMA
//                when a block held one tap), and g comes from DRAM/L2 once per
//                (b, tile) instead of once per tap. The 8 warps' partial sums
//                are added in warp order in shared memory: no atomics, the
//                same bits every call. At B=1 the grid has only 8 blocks (one
//                per channel tile); that is as fast as the one-tap-per-block
//                version was, so the launcher does not split further.
//
// What bounds the three kernels now (inferred from bytes and time; no
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
// The strip kernel's bf16 instantiation took 1.7-2x the fp32 kernel's time
// while it moves half the bytes, at B=1 too (6.2 against 3.1-3.3 us). Not
// for want of registers: ptxas gives it 119 / 124 registers (forward /
// grad-input) and no spills against fp32's 116 / 118, so an SM holds the
// same 16 warps. Its loads are the cause: each 16-bit load is converted to
// float32 as it arrives, and ptxas issues them a few at a time behind those
// conversions, so a warp waits out one memory latency per few loads, where
// the fp32 kernel issues a row of loads at once. The packed bf16 kernel
// below is the bf16 path's forward and grad-input on the model's shapes.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

}  // namespace

// Each entry launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() after the launch.
// dtype: 0 = float32, 1 = bfloat16. kernel: 0 = the kernel of that type (one
// channel a lane), 1 = the packed bf16 kernel (bf16 forward and grad-input
// only; the Python wrapper chooses). Shapes are validated by the Python
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
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch_grad_kernel<float>(x, g, dk, b, hx, wx, c, hk, wk, s);
  if (dtype == 1)
    return (int)launch_grad_kernel<__nv_bfloat16>(x, g, dk, b, hx, wx, c, hk, wk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* siammask_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
