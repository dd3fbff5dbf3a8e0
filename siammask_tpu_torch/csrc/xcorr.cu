// Depthwise valid cross-correlation for Hopper (sm_90a), NHWC, and its two
// gradients.
//
//   out[b, i, j, c] = sum_{dy, dx} x[b, i + dy, j + dx, c] * k[b, dy, dx, c]
//
// Replaces the TPU kernel `depthwise_xcorr_pallas` (`_xcorr_kernel`) in
// siammask_tpu/ops/xcorr_pallas.py: the same map, fp32 accumulation, output
// cast to the input type. It is not a block-by-block copy: the TPU kernel
// keeps a (Hx, Wx, 128-channel) slab in VMEM per grid step; here every
// thread owns one output element.
//
// What bounds it on this card: bytes. Each output does Hk*Wk FMAs (25 for
// SiamMask) per 4-byte store, far below the ~20 FLOP/byte at which an H100's
// fp32 units, not memory, become the limit. At the tracking shape
// (1,29,29,256) * (1,5,5,256) the inputs are 861 KB plus 26 KB and sit in
// the 50 MB L2 after the first touch, so the kernel is bound by L2 and
// launch latency rather than by device memory.
//
// What the design does about it: channels are innermost, so the 32 threads
// of a warp read 32 neighbouring channels of one pixel -- each tap is one
// coalesced 128-byte (fp32) load per warp, and the overlapping windows of
// neighbouring output pixels hit L1/L2 instead of device memory. The taps are
// a runtime loop (any Hk, Wk); there is no channel-multiple requirement.
// Shared-memory staging, vector loads and batching the three heads of a
// frame into one launch are left for later.
//
// The two gradients replace the backward of the trainable wrapper
// `depthwise_xcorr_ad` (its custom_vjp bwd, which differentiates the im2col
// form in XLA). With Ho = Hx - Hk + 1, Wo = Wx - Wk + 1 and g the upstream
// gradient (B, Ho, Wo, C):
//
//   grad-input:  dx[b, y, x, c] = sum_{dy, dx} g[b, y - dy, x - dx, c] * k[b, dy, dx, c]
//                over the taps with 0 <= y - dy < Ho and 0 <= x - dx < Wo
//                (a full correlation). One thread per element of dx, channels
//                innermost as in the forward; the tap range is clipped once,
//                so no tap inside the loop is out of bounds.
//   grad-kernel: dk[b, dy, dx, c] = sum_{i < Ho, j < Wo} x[b, i + dy, j + dx, c] * g[b, i, j, c]
//                A 625-term reduction per output for SiamMask, and only
//                B*Hk*Wk*C outputs (6,400 at B=1), so one thread per output
//                would leave most of the card idle. A block owns one
//                (b, tap, 32-channel tile); its 16 rows of 32 threads split
//                the Ho*Wo positions, each row striding by 16, and a
//                fixed-order tree in shared memory adds the 16 partial sums.
//                No atomics: the result is the same from run to run.
//
// Both gradients are bound by bytes like the forward. grad-kernel reads
// each (b, tile) window of g once per tap (25 times, mostly from L2); a
// version that keeps all taps of a tile in one block is later work.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
__global__ void depthwise_xcorr_kernel(const T* __restrict__ x, const T* __restrict__ k,
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
    for (int dx = 0; dx < wk; ++dx) {
      acc = fmaf(to_float(xrow[(long long)dx * c]), to_float(krow[(long long)dx * c]), acc);
    }
  }
  out[idx] = from_float<T>(acc);
}

template <typename T>
__global__ void depthwise_xcorr_grad_input_kernel(const T* __restrict__ g, const T* __restrict__ k,
                                                  T* __restrict__ dx, int hx, int wx, int c,
                                                  int hk, int wk, int ho, int wo,
                                                  long long total) {
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

constexpr int kChannelTile = 32;  // threadIdx.x: one warp across channels
constexpr int kPositionSplit = 16;  // threadIdx.y: rows that split the positions

template <typename T>
__global__ void depthwise_xcorr_grad_kernel_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                                   T* __restrict__ dk, int hx, int wx, int c,
                                                   int hk, int wk, int ho, int wo) {
  __shared__ float partial[kPositionSplit][kChannelTile];
  const int ch = blockIdx.x * kChannelTile + threadIdx.x;
  const int tap = blockIdx.y;
  const int dy = tap / wk, tx = tap % wk;
  const long long b = blockIdx.z;

  float acc = 0.0f;
  if (ch < c) {
    const T* xb = x + (b * hx * wx + (long long)dy * wx + tx) * c + ch;
    const T* gb = g + b * ho * wo * c + ch;
    const int positions = ho * wo;
    for (int p = threadIdx.y; p < positions; p += kPositionSplit) {
      const int i = p / wo;
      const int j = p - i * wo;
      acc = fmaf(to_float(xb[((long long)i * wx + j) * c]), to_float(gb[(long long)p * c]), acc);
    }
  }
  partial[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  for (int s = kPositionSplit / 2; s > 0; s >>= 1) {
    if (threadIdx.y < s) partial[threadIdx.y][threadIdx.x] += partial[threadIdx.y + s][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && ch < c) {
    dk[(b * hk * wk + tap) * c + ch] = from_float<T>(partial[0][threadIdx.x]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* k, void* out, int b, int hx, int wx, int c,
                   int hk, int wk, cudaStream_t stream) {
  const int ho = hx - hk + 1;
  const int wo = wx - wk + 1;
  const long long total = (long long)b * ho * wo * c;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  depthwise_xcorr_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<T*>(out), hx, wx, c,
      hk, wk, ho, wo, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad_input(const void* g, const void* k, void* dx, int b, int hx, int wx, int c,
                              int hk, int wk, cudaStream_t stream) {
  const long long total = (long long)b * hx * wx * c;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  depthwise_xcorr_grad_input_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(k), static_cast<T*>(dx), hx, wx, c, hk,
      wk, hx - hk + 1, wx - wk + 1, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad_kernel(const void* x, const void* g, void* dk, int b, int hx, int wx, int c,
                               int hk, int wk, cudaStream_t stream) {
  if ((long long)b * hk * wk * c == 0) return cudaSuccess;
  const dim3 grid((c + kChannelTile - 1) / kChannelTile, hk * wk, b);
  const dim3 block(kChannelTile, kPositionSplit);
  depthwise_xcorr_grad_kernel_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dk), hx, wx, c, hk, wk,
      hx - hk + 1, wx - wk + 1);
  return cudaGetLastError();
}

}  // namespace

// Each entry launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() after the launch.
// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python wrapper;
// (hk, wk) is always the template's size and (hx, wx) the search map's.
extern "C" int siammask_depthwise_xcorr(const void* x, const void* k, void* out, int b, int hx,
                                        int wx, int c, int hk, int wk, int dtype, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, k, out, b, hx, wx, c, hk, wk, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, k, out, b, hx, wx, c, hk, wk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int siammask_depthwise_xcorr_grad_input(const void* g, const void* k, void* dx, int b,
                                                   int hx, int wx, int c, int hk, int wk,
                                                   int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_grad_input<float>(g, k, dx, b, hx, wx, c, hk, wk, s);
  if (dtype == 1) return (int)launch_grad_input<__nv_bfloat16>(g, k, dx, b, hx, wx, c, hk, wk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int siammask_depthwise_xcorr_grad_kernel(const void* x, const void* g, void* dk, int b,
                                                    int hx, int wx, int c, int hk, int wk,
                                                    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_grad_kernel<float>(x, g, dk, b, hx, wx, c, hk, wk, s);
  if (dtype == 1) return (int)launch_grad_kernel<__nv_bfloat16>(x, g, dk, b, hx, wx, c, hk, wk, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* siammask_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
