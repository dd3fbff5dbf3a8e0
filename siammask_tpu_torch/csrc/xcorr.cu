// Depthwise valid cross-correlation for Hopper (sm_90a), NHWC.
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
// The launch goes on the caller's stream, does not synchronise and allocates
// nothing; the C entry returns cudaGetLastError() after the launch.

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python wrapper.
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

extern "C" const char* siammask_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
