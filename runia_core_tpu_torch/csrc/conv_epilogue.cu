// The conv-norm epilogue: inference batch norm, the residual and ReLU in
// one pass over a convolution's channels_last output, written in place:
//
//   y <- relu(y * scale + shift [+ r | + (r * scale_p + shift_p)])
//
// with the per-channel f32 scale and shift of the norm (and of the
// projection's norm, whose conv output is r), for channel c the fastest
// dimension of the (N, H, W, C) memory. The arithmetic is f32, each product
// with its shift one FMA, rounded once to the map's dtype (bf16 or f32):
// ops/conv_epilogue.py::conv_epilogue_plain is its twin.
//
// Replaces: no Pallas kernel. The JAX package's ResNet
// (runia_core_tpu/models/resnet.py) leaves batch norm, the residual add and
// ReLU to XLA, which fuses them into one loop over the conv's output; the
// port's eager modules ran them as three or four elementwise passes, the
// norm's a broadcast multiply-add on PyTorch's generic strided kernel.
//
// Bound on the H100: bytes. A value is read once (and its residual once)
// and written once, with two to four FMAs. At ResNet-50's batch 128 the
// 56 x 56 x 256 bf16 block end moves 617 MB (0.184 ms at 3.35 TB/s); an
// inner 28 x 28 x 128 conv 51 MB (0.015 ms).
//
// Design: a thread takes V consecutive channels with one 16-byte load (8
// bf16 or 4 f32; the wrapper checks C % V and the alignment), neighbouring
// threads neighbouring vectors, so a warp reads 512 contiguous bytes. The
// grid-stride loop's stride (blocks x threads) is a multiple of C / V, so
// every vector a thread visits covers the same channels: their scale and
// shift sit in registers, loaded once. The grid is what the 132 SMs hold
// resident at the kernel's occupancy, no more, rounded up to keep that
// multiple. The residual is read through the read-only path; y, read then
// written by the same thread, through the ordinary one. Nothing is
// allocated; the launch goes on the caller's stream.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace runia {
namespace {

constexpr int kEpilogueThreads = 256;

enum ResidualMode { kNoResidual = 0, kAddResidual = 1, kProjectedResidual = 2 };

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using Raw = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kWidth = 8;
};

__device__ __forceinline__ void unpack(const float4 q, float (&v)[4]) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void unpack(const uint4 q, float (&v)[8]) {
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32; the lower address the low half
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 pack(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // round to nearest even, NaN kept, as PyTorch's cast
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kEpilogueThreads)
    conv_epilogue_kernel(T* __restrict__ y, const T* __restrict__ residual, const float* __restrict__ scale,
                         const float* __restrict__ shift, const float* __restrict__ scale_p,
                         const float* __restrict__ shift_p, int64_t vectors, int groups) {
  using Raw = typename Vec<T>::Raw;
  constexpr int V = Vec<T>::kWidth;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;  // a multiple of groups = C / V
  const int c0 = static_cast<int>(i % groups) * V;
  float s[V], b[V], sp[V], bp[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = __ldg(scale + c0 + k);
    b[k] = __ldg(shift + c0 + k);
    if (kMode == kProjectedResidual) {
      sp[k] = __ldg(scale_p + c0 + k);
      bp[k] = __ldg(shift_p + c0 + k);
    }
  }
  Raw* out = reinterpret_cast<Raw*>(y);
  const Raw* res = reinterpret_cast<const Raw*>(residual);
  for (; i < vectors; i += stride) {
    float v[V], r[V];
    unpack(out[i], v);
    if (kMode != kNoResidual) unpack(__ldg(res + i), r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float o = fmaf(v[k], s[k], b[k]);
      if (kMode == kAddResidual) o += r[k];
      if (kMode == kProjectedResidual) o += fmaf(r[k], sp[k], bp[k]);
      o = o < 0.0f ? 0.0f : o;  // ReLU; NaN stays NaN, as torch.relu
      v[k] = o;
    }
    out[i] = pack(v);
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, int kMode>
int launch(void* y, const void* residual, const void* scale, const void* shift, const void* scale_p,
           const void* shift_p, int64_t vectors, int groups, cudaStream_t stream) {
  const auto kernel = conv_epilogue_kernel<T, kMode>;
  // Blocks an SM holds at once: one instance, one target (sm_90a), asked once.
  static const int per_sm = [kernel] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kEpilogueThreads, 0) != cudaSuccess) n = 1;
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (vectors + kEpilogueThreads - 1) / kEpilogueThreads;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const int64_t step = groups / gcd(groups, kEpilogueThreads);  // blocks x threads a multiple of groups
  int64_t blocks = needed < resident ? needed : resident;
  blocks = (blocks + step - 1) / step * step;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), kEpilogueThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(residual), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(scale_p), static_cast<const float*>(shift_p),
      vectors, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(int mode, void* y, const void* residual, const void* scale, const void* shift, const void* scale_p,
                const void* shift_p, int64_t vectors, int groups, cudaStream_t stream) {
  switch (mode) {
    case kNoResidual:
      return launch<T, kNoResidual>(y, residual, scale, shift, scale_p, shift_p, vectors, groups, stream);
    case kAddResidual:
      return launch<T, kAddResidual>(y, residual, scale, shift, scale_p, shift_p, vectors, groups, stream);
    default:
      return launch<T, kProjectedResidual>(y, residual, scale, shift, scale_p, shift_p, vectors, groups, stream);
  }
}

}  // namespace
}  // namespace runia

// (y, residual or null, scale, shift, scale_p, shift_p (mode 2) or null, rows = N * H * W, channels, bf16 map,
//  mode: 0 no residual, 1 add it, 2 add its own affine; stream)
extern "C" int runia_conv_epilogue(void* y, const void* residual, const void* scale, const void* shift,
                                   const void* scale_p, const void* shift_p, int rows, int channels, int bf16,
                                   int mode, void* stream) {
  using namespace runia;
  const int width = bf16 ? 8 : 4;
  const bool with_residual = mode == kAddResidual || mode == kProjectedResidual;
  if (rows <= 0 || channels <= 0 || channels % width || mode < kNoResidual || mode > kProjectedResidual ||
      y == nullptr || scale == nullptr || shift == nullptr || reinterpret_cast<uintptr_t>(y) % 16 ||
      (with_residual && (residual == nullptr || reinterpret_cast<uintptr_t>(residual) % 16)) ||
      (mode == kProjectedResidual && (scale_p == nullptr || shift_p == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t vectors = static_cast<int64_t>(rows) * (channels / width);
  const int groups = channels / width;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mode<__nv_bfloat16>(mode, y, residual, scale, shift, scale_p, shift_p, vectors, groups, s)
              : launch_mode<float>(mode, y, residual, scale, shift, scale_p, shift_p, vectors, groups, s);
}
