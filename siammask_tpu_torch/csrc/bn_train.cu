// Train-mode BatchNorm2d for Hopper (sm_90a) on channels_last bf16 maps,
// with the residual add and the ReLU that follow it in a ResNet block, and
// its backward.
//
//   y = bf16(relu((x - mean_c) * a_c + beta_c (+ z))),  a_c = gamma_c * invstd_c
//
// over a map seen as R = N*H*W rows of C contiguous channels, with the batch
// statistics (mean_c and the biased variance) taken over the R rows, in
// float32.
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA. It was
// added because ATen's train-mode BN on channels_last maps ran far below the
// card: its statistics kernel (`batch_norm_collect_statistics_channels_last`)
// at 18% of its bytes' bound, its backward's reduction at 46%, and the
// residual add, the ReLU and ReLU's backward as passes of their own over the
// maps. Every kernel here is bound by the bytes it moves (a few float32
// operations per element against the card's ~18 FLOPs a byte of bandwidth),
// so the design moves fewer bytes and keeps enough loads in flight:
//
// - Blocks tile the map as (a run of rows) x (64 channels): 8 lanes across
//   the channels, each one 16-byte load of 8 bf16 channels a row, and 32
//   row groups down the rows, each with kUnroll rows' loads in flight. A
//   thread's 8 channels' coefficients stay in registers for all its rows.
// - Statistics (`bn_stats_kernel`): the rows are split over enough blocks to
//   fill the SMs (the split is chosen by the caller from R, C and the SM
//   count). Each thread keeps Welford's (count, mean, M2) for its channels,
//   the block merges its row groups with Chan's formula, and each block
//   writes its partials. The last block of a channel tile to finish (an
//   arrival counter in device memory, left at 0 after) merges the partials
//   in a fixed order, writes the float32 mean and inverse std, and updates
//   the running statistics with the biased variance and the module's
//   momentum. One launch, no E[x^2] - E[x]^2: a channel whose mean is large
//   against its spread keeps its variance.
// - Normalise (`bn_apply_kernel`): one pass that reads x (and z) and writes
//   y, rounding once. Right after the statistics, a map under ~40 MB is
//   read again from L2.
// - Backward: two passes. The reduction (`bn_backward_reduce_kernel`) takes
//   g = dy where the forward's output was above 0 (or dy, without ReLU) and
//   sums g and g * (x - mean) per channel, the last block as above; with a
//   residual it also writes g, which is the residual's gradient. Without a
//   residual the ReLU's decision is worked out again from x by the
//   forward's own float operations (`bn_value`, then bf16 rounding), bit
//   for bit, so dy and x are the only maps read. The elementwise pass
//   (`bn_backward_elemt_kernel`) writes dx = a_c (g - sum g / R - xhat *
//   sum g xhat / R). No separate threshold_backward, add or copy.
//
// Sums are merged in a fixed order: the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kVec = 8;                       // channels a thread: one 16-byte load
constexpr int kLanes = 8;                     // threads across a channel tile
constexpr int kTile = kVec * kLanes;          // channels a block
constexpr int kGroups = 32;                   // threads down the rows
constexpr int kThreads = kLanes * kGroups;    // 256
constexpr int kUnroll = 4;                    // rows a thread has in flight
constexpr int kQuarters = kThreads / kTile;   // threads a channel when the last block merges
constexpr int kBatch = 8;                     // partials a thread loads at once there

// the ReLU's decision in the backward
constexpr int kMaskNone = 0;       // no ReLU: g = dy
constexpr int kMaskRecompute = 1;  // from x, as the forward computed it
constexpr int kMaskFromY = 2;      // from the saved output; g is written (the residual's grad)

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ uint4 load(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// The normalised value before the residual, in explicit round-to-nearest
// operations so that the backward's recomputation gives the forward's bits.
__device__ __forceinline__ float bn_value(float x, float mean, float a, float beta) {
  return __fmaf_rn(__fsub_rn(x, mean), a, beta);
}

// ReLU that keeps a NaN (as torch.relu does), so the trainer's guard sees it.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

__device__ __forceinline__ bool above_zero_in_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v)) > 0.0f;
}

// (na, ma, qa) <- (na, ma, qa) merged with (nb, mb, qb): Chan et al.'s
// pairwise update of a count, mean and sum of squared deviations; the
// caller adds nb to its count.
__device__ __forceinline__ void merge(float na, float& ma, float& qa, float nb, float mb,
                                      float qb) {
  if (nb == 0.0f) return;
  const float n = na + nb, d = mb - ma, w = nb / n;
  ma = fmaf(d, w, ma);
  qa = qa + qb + d * d * na * w;
}

// rows [r0, r1) of this block, for (lane, group) = threadIdx.x
struct Place {
  int lane, group, c0, r0, r1;
};

__device__ __forceinline__ Place place(int rows, int c, int per_block) {
  Place p;
  p.lane = threadIdx.x % kLanes;
  p.group = threadIdx.x / kLanes;
  p.c0 = blockIdx.y * kTile + p.lane * kVec;
  p.r0 = blockIdx.x * per_block;
  p.r1 = min(rows, p.r0 + per_block);
  return p;
}

// The last block of this channel tile to arrive gets true; the counter is
// left at 0 for the next launch. Every thread's writes before the call are
// visible to the last block after it.
__device__ __forceinline__ bool last_to_arrive(unsigned* counters) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + blockIdx.y, 1u) == gridDim.x - 1;
    if (last) counters[blockIdx.y] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const __nv_bfloat16* __restrict__ x, int rows, int c, int per_split,
                    float* __restrict__ part, unsigned* __restrict__ counters,
                    float* __restrict__ mean_out, float* __restrict__ invstd_out,
                    float* __restrict__ running_mean, float* __restrict__ running_var,
                    float momentum, float eps) {
  __shared__ float s_mean[kGroups][kTile];
  __shared__ float s_m2[kGroups][kTile];
  __shared__ float s_n[kGroups];
  const Place p = place(rows, c, per_split);
  const bool active = p.c0 < c;
  float n = 0.0f, mean[kVec], m2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) mean[k] = m2[k] = 0.0f;
  if (active) {
    for (int r = p.r0 + p.group; r < p.r1; r += kGroups * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * kGroups;
        v[u] = row < p.r1 ? load(x + (size_t)row * c + p.c0) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * kGroups >= p.r1) break;
        float f[kVec];
        unpack(v[u], f);
        n += 1.0f;
        const float inv = 1.0f / n;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float d = f[k] - mean[k];
          mean[k] = fmaf(d, inv, mean[k]);
          m2[k] = fmaf(d, f[k] - mean[k], m2[k]);
        }
      }
    }
  }
  // the block's row groups, merged pairwise down to group 0
  const int j = p.lane * kVec;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s_mean[p.group][j + k] = mean[k];
    s_m2[p.group][j + k] = m2[k];
  }
  if (p.lane == 0) s_n[p.group] = n;
  __syncthreads();
  for (int stride = kGroups / 2; stride > 0; stride /= 2) {
    if (p.group < stride) {
      const int o = p.group + stride;
      const float nb = s_n[o];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        merge(n, mean[k], m2[k], nb, s_mean[o][j + k], s_m2[o][j + k]);
        s_mean[p.group][j + k] = mean[k];
        s_m2[p.group][j + k] = m2[k];
      }
      n += nb;
      if (p.lane == 0) s_n[p.group] = n;
    }
    __syncthreads();
  }
  if (p.group == 0 && active) {
    float* out = part + (size_t)blockIdx.x * 2 * c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      out[p.c0 + k] = mean[k];
      out[c + p.c0 + k] = m2[k];
    }
  }
  if (!last_to_arrive(counters)) return;

  // the last block: each channel's partials in kQuarters interleaved runs,
  // then the runs in order; a thread's loads kBatch at a time, so that it
  // waits for L2 once a batch and not once a partial
  const int jj = threadIdx.x % kTile, q = threadIdx.x / kTile;
  const int ch = blockIdx.y * kTile + jj;
  float fn = 0.0f, fm = 0.0f, fq = 0.0f;
  if (ch < c) {
    for (int s0 = q; s0 < (int)gridDim.x; s0 += kQuarters * kBatch) {
      float pm[kBatch], pq[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int s = s0 + i * kQuarters;
        const float* in = part + (size_t)s * 2 * c;
        pm[i] = s < (int)gridDim.x ? __ldcg(in + ch) : 0.0f;
        pq[i] = s < (int)gridDim.x ? __ldcg(in + c + ch) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int s = s0 + i * kQuarters;
        const int ns = s < (int)gridDim.x ? min(rows, (s + 1) * per_split) - s * per_split : 0;
        merge(fn, fm, fq, (float)ns, pm[i], pq[i]);
        fn += (float)ns;
      }
    }
  }
  s_mean[q][jj] = fm;
  s_m2[q][jj] = fq;
  if (jj == 0) s_n[q] = fn;
  __syncthreads();
  if (q == 0 && ch < c) {
    for (int o = 1; o < kQuarters; ++o) {
      merge(fn, fm, fq, s_n[o], s_mean[o][jj], s_m2[o][jj]);
      fn += s_n[o];
    }
    const float var = fq / fn;  // biased, as flax's running variance takes it
    mean_out[ch] = fm;
    invstd_out[ch] = 1.0f / sqrtf(var + eps);
    running_mean[ch] = momentum * fm + (1.0f - momentum) * running_mean[ch];
    running_var[ch] = momentum * var + (1.0f - momentum) * running_var[ch];
  }
}

template <bool kRelu, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ z,
                    __nv_bfloat16* __restrict__ y, int rows, int c, int per_block,
                    const float* __restrict__ mean, const float* __restrict__ invstd,
                    const float* __restrict__ gamma, const float* __restrict__ beta) {
  const Place p = place(rows, c, per_block);
  if (p.c0 >= c) return;
  float m[kVec], a[kVec], b[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    m[k] = mean[p.c0 + k];
    a[k] = __fmul_rn(gamma[p.c0 + k], invstd[p.c0 + k]);
    b[k] = beta[p.c0 + k];
  }
  for (int r = p.r0 + p.group; r < p.r1; r += kGroups * kUnroll) {
    uint4 v[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kGroups;
      if (row < p.r1) {
        v[u] = load(x + (size_t)row * c + p.c0);
        if (kResidual) w[u] = load(z + (size_t)row * c + p.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kGroups;
      if (row >= p.r1) break;
      float f[kVec], g[kVec];
      unpack(v[u], f);
      if (kResidual) unpack(w[u], g);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float val = bn_value(f[k], m[k], a[k], b[k]);
        if (kResidual) val = __fadd_rn(val, g[k]);
        f[k] = kRelu ? relu(val) : val;
      }
      store(y + (size_t)row * c + p.c0, pack(f));
    }
  }
}

// dy masked by the ReLU's decision: raw bf16 words kept or zeroed, exact.
template <int kMask>
__device__ __forceinline__ uint4 masked(const uint4& dy, const float (&xf)[kVec],
                                        const uint4& y, const float (&m)[kVec],
                                        const float (&a)[kVec], const float (&b)[kVec]) {
  if (kMask == kMaskNone) return dy;
  bool keep[kVec];
  if (kMask == kMaskRecompute) {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      keep[k] = above_zero_in_bf16(bn_value(xf[k], m[k], a[k], b[k]));
  } else {
    float yf[kVec];
    unpack(y, yf);
#pragma unroll
    for (int k = 0; k < kVec; ++k) keep[k] = yf[k] > 0.0f;
  }
  const uint32_t in[4] = {dy.x, dy.y, dy.z, dy.w};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = (keep[2 * i] ? in[i] & 0xffffu : 0u) |
             (keep[2 * i + 1] ? in[i] & 0xffff0000u : 0u);
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <int kMask>
__global__ void __launch_bounds__(kThreads)
    bn_backward_reduce_kernel(const __nv_bfloat16* __restrict__ dy,
                              const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ y,
                              __nv_bfloat16* __restrict__ g_out,
                              int rows, int c, int per_split, const float* __restrict__ mean,
                              const float* __restrict__ invstd, const float* __restrict__ gamma,
                              const float* __restrict__ beta, float* __restrict__ part,
                              unsigned* __restrict__ counters, float* __restrict__ sums) {
  __shared__ float s_g[kGroups][kTile];
  __shared__ float s_gx[kGroups][kTile];
  const Place p = place(rows, c, per_split);
  const bool active = p.c0 < c;
  float m[kVec], a[kVec], b[kVec], sg[kVec], sgx[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    m[k] = active ? mean[p.c0 + k] : 0.0f;
    const bool affine = active && kMask == kMaskRecompute;
    a[k] = affine ? __fmul_rn(gamma[p.c0 + k], invstd[p.c0 + k]) : 0.0f;
    b[k] = affine ? beta[p.c0 + k] : 0.0f;
    sg[k] = sgx[k] = 0.0f;
  }
  if (active) {
    for (int r = p.r0 + p.group; r < p.r1; r += kGroups * kUnroll) {
      uint4 d[kUnroll], v[kUnroll], w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * kGroups;
        if (row < p.r1) {
          const size_t at = (size_t)row * c + p.c0;
          d[u] = load(dy + at);
          v[u] = load(x + at);
          if (kMask == kMaskFromY) w[u] = load(y + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * kGroups;
        if (row >= p.r1) break;
        float xf[kVec], gf[kVec];
        unpack(v[u], xf);
        const uint4 g = masked<kMask>(d[u], xf, w[u], m, a, b);
        if (kMask == kMaskFromY) store(g_out + (size_t)row * c + p.c0, g);
        unpack(g, gf);
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          sg[k] += gf[k];
          sgx[k] = fmaf(gf[k], xf[k] - m[k], sgx[k]);
        }
      }
    }
  }
  const int j = p.lane * kVec;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    s_g[p.group][j + k] = sg[k];
    s_gx[p.group][j + k] = sgx[k];
  }
  __syncthreads();
  for (int stride = kGroups / 2; stride > 0; stride /= 2) {
    if (p.group < stride) {
      const int o = p.group + stride;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        sg[k] += s_g[o][j + k];
        sgx[k] += s_gx[o][j + k];
        s_g[p.group][j + k] = sg[k];
        s_gx[p.group][j + k] = sgx[k];
      }
    }
    __syncthreads();
  }
  if (p.group == 0 && active) {
    float* out = part + (size_t)blockIdx.x * 2 * c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      out[p.c0 + k] = sg[k];
      out[c + p.c0 + k] = sgx[k];
    }
  }
  if (!last_to_arrive(counters)) return;

  const int jj = threadIdx.x % kTile, q = threadIdx.x / kTile;
  const int ch = blockIdx.y * kTile + jj;
  float tg = 0.0f, tgx = 0.0f;
  if (ch < c) {
    for (int s0 = q; s0 < (int)gridDim.x; s0 += kQuarters * kBatch) {
      float pg[kBatch], pgx[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int s = s0 + i * kQuarters;
        const float* in = part + (size_t)s * 2 * c;
        pg[i] = s < (int)gridDim.x ? __ldcg(in + ch) : 0.0f;
        pgx[i] = s < (int)gridDim.x ? __ldcg(in + c + ch) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        tg += pg[i];
        tgx += pgx[i];
      }
    }
  }
  s_g[q][jj] = tg;
  s_gx[q][jj] = tgx;
  __syncthreads();
  if (q == 0 && ch < c) {
    for (int o = 1; o < kQuarters; ++o) {
      tg += s_g[o][jj];
      tgx += s_gx[o][jj];
    }
    sums[ch] = tg;                       // d beta
    sums[c + ch] = tgx * invstd[ch];     // d gamma: sum g * xhat
  }
}

template <bool kRecompute>
__global__ void __launch_bounds__(kThreads)
    bn_backward_elemt_kernel(const __nv_bfloat16* __restrict__ g,
                             const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ dx, int rows, int c, int per_block,
                             const float* __restrict__ mean, const float* __restrict__ invstd,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const float* __restrict__ sums) {
  const Place p = place(rows, c, per_block);
  if (p.c0 >= c) return;
  float m[kVec], is[kVec], a[kVec], b[kVec], k1[kVec], k2[kVec];
  const float inv_rows = 1.0f / (float)rows;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    m[k] = mean[p.c0 + k];
    is[k] = invstd[p.c0 + k];
    a[k] = __fmul_rn(gamma[p.c0 + k], is[k]);
    b[k] = kRecompute ? beta[p.c0 + k] : 0.0f;
    k1[k] = sums[p.c0 + k] * inv_rows;
    k2[k] = sums[c + p.c0 + k] * inv_rows;
  }
  constexpr int kMask = kRecompute ? kMaskRecompute : kMaskNone;
  const uint4 none = make_uint4(0, 0, 0, 0);
  for (int r = p.r0 + p.group; r < p.r1; r += kGroups * kUnroll) {
    uint4 d[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kGroups;
      if (row < p.r1) {
        d[u] = load(g + (size_t)row * c + p.c0);
        v[u] = load(x + (size_t)row * c + p.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * kGroups;
      if (row >= p.r1) break;
      float xf[kVec], gf[kVec];
      unpack(v[u], xf);
      unpack(masked<kMask>(d[u], xf, none, m, a, b), gf);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float xhat = (xf[k] - m[k]) * is[k];
        gf[k] = a[k] * fmaf(-xhat, k2[k], gf[k] - k1[k]);
      }
      store(dx + (size_t)row * c + p.c0, pack(gf));
    }
  }
}

cudaError_t begin(int device) { return cudaSetDevice(device); }

// blocks (runs of rows, channel tiles) for runs of about rows / want rows
dim3 grid(int rows, int c, int want, int* per) {
  *per = (rows + want - 1) / want;
  return dim3((rows + *per - 1) / *per, (c + kTile - 1) / kTile);
}

}  // namespace

// Each entry launches on the caller's stream, does not synchronise, allocates
// nothing and returns the launch's CUDA error code (0 for none). The Python
// wrapper (ops/bn_train.py) checks shapes, dtypes, layout and alignment:
// maps are channels_last bf16 (rows, c) with c a multiple of 8 and every map
// 16-byte aligned; per-channel vectors are float32. `splits` / `chunks`: the
// runs of rows the reduction / elementwise kernels split the map into (at
// most that many); `part` holds 2 * c * splits floats; `counters` one
// unsigned a channel tile of 64, all 0, and left at 0.
extern "C" int siammask_bn_train_stats(const void* x, int rows, int c, int splits, void* part,
                                       void* counters, void* mean, void* invstd,
                                       void* running_mean, void* running_var, float momentum,
                                       float eps, int device, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  int per;
  const dim3 blocks = grid(rows, c, splits, &per);
  bn_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), rows, c, per, static_cast<float*>(part),
      static_cast<unsigned*>(counters), static_cast<float*>(mean), static_cast<float*>(invstd),
      static_cast<float*>(running_mean), static_cast<float*>(running_var), momentum, eps);
  return (int)cudaGetLastError();
}

extern "C" int siammask_bn_train_apply(const void* x, const void* z, void* y, int rows, int c,
                                       int chunks, const void* mean, const void* invstd,
                                       const void* gamma, const void* beta, int relu,
                                       int device, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  int per;
  const dim3 blocks = grid(rows, c, chunks, &per);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* zp = static_cast<const __nv_bfloat16*>(z);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  const auto *mp = static_cast<const float*>(mean), *ip = static_cast<const float*>(invstd);
  const auto *gp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  const auto kernel = relu ? (z ? bn_apply_kernel<true, true> : bn_apply_kernel<true, false>)
                           : (z ? bn_apply_kernel<false, true> : bn_apply_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, s>>>(xp, zp, yp, rows, c, per, mp, ip, gp, bp);
  return (int)cudaGetLastError();
}

// mask: 0 none (g = dy), 1 the ReLU's decision worked out from x, 2 from y,
// with g written to g_out.
extern "C" int siammask_bn_train_backward_reduce(const void* dy, const void* x, const void* y,
                                                 void* g_out, int rows, int c, int splits,
                                                 const void* mean, const void* invstd,
                                                 const void* gamma, const void* beta, int mask,
                                                 void* part, void* counters, void* sums,
                                                 int device, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  int per;
  const dim3 blocks = grid(rows, c, splits, &per);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dyp = static_cast<const __nv_bfloat16*>(dy);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  auto* gp = static_cast<__nv_bfloat16*>(g_out);
  const auto *mp = static_cast<const float*>(mean), *ip = static_cast<const float*>(invstd);
  const auto *wp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  auto* pp = static_cast<float*>(part);
  auto* cp = static_cast<unsigned*>(counters);
  auto* sp = static_cast<float*>(sums);
  if (mask < kMaskNone || mask > kMaskFromY) return (int)cudaErrorInvalidValue;
  const auto kernel = mask == kMaskNone        ? bn_backward_reduce_kernel<kMaskNone>
                      : mask == kMaskRecompute ? bn_backward_reduce_kernel<kMaskRecompute>
                                               : bn_backward_reduce_kernel<kMaskFromY>;
  kernel<<<blocks, kThreads, 0, s>>>(dyp, xp, yp, gp, rows, c, per, mp, ip, wp, bp, pp, cp, sp);
  return (int)cudaGetLastError();
}

// recompute: g is dy, masked by the ReLU's decision worked out from x.
extern "C" int siammask_bn_train_backward_elemt(const void* g, const void* x, void* dx, int rows,
                                                int c, int chunks, const void* mean,
                                                const void* invstd, const void* gamma,
                                                const void* beta, const void* sums,
                                                int recompute, int device, void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  int per;
  const dim3 blocks = grid(rows, c, chunks, &per);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* dxp = static_cast<__nv_bfloat16*>(dx);
  const auto *mp = static_cast<const float*>(mean), *ip = static_cast<const float*>(invstd);
  const auto *wp = static_cast<const float*>(gamma), *bp = static_cast<const float*>(beta);
  const auto* sp = static_cast<const float*>(sums);
  const auto kernel =
      recompute ? bn_backward_elemt_kernel<true> : bn_backward_elemt_kernel<false>;
  kernel<<<blocks, kThreads, 0, s>>>(gp, xp, dxp, rows, c, per, mp, ip, wp, bp, sp);
  return (int)cudaGetLastError();
}
