// ROIAlign over a batch of NHWC feature maps: (B, H, W, C) f32 or bf16 and
// K = B * M boxes (xyxy, image coordinates, ROI k on image k / M) ->
// pooled (K, C, oh, ow) or the per-ROI channel means (K, C), in the map's
// dtype, summed in f32.
//
// Replaces: runia_core_tpu/ops/roi_align.py::roi_align, no Pallas kernel but
// two XLA einsums against one-hot (N, out, S, size) interpolation matrices,
// vmapped over the image batch by extraction/object_level_batched.py, which
// then averages the pooled bins. torchvision's semantics as JAX keeps them:
// continuous coordinates with the half-pixel `aligned` offset, the adaptive
// ceil(roi / out) grid capped at max_samples, zero outside [-1, size], edge
// clamping, count = max(grid, 1) per axis, positions in f32 always.
//
// Bound on the H100: bytes. Each ROI reads the map cells its bins touch,
// C values each, and writes its result; there are a few operations a
// value. At the object scorer's 2,560 ROIs on (128, 8, 8, 512) bf16 maps,
// the map is 8.4 MB and the (2,560, 512) means 2.6 MB, where the JAX form
// writes a (2,560, 512, 7, 7) pooled tensor (128 MB in bf16) and reads it
// back to average it.
//
// Design: one block per (ROI, tile of up to 128 channels), one thread per
// channel, so each map tap is one coalesced row of channels (the NHWC
// order the forward leaves, so no transpose of the map is made). The
// block first builds the separable interpolation weights of its ROI in
// shared memory, as the JAX form does: Ay (oh, H) and Ax (ow, W), row r by
// thread r, summing the bilinear weights of the row's samples in order,
// and each bin's footprint (the first and last map row and column with a
// sample). Then, pooled: each thread sums sum_y Ay[ph, y] sum_x Ax[pw, x]
// F[y, x, c] over a bin's footprint into a shared-memory tile (one row of
// oh * ow values per channel, written out coalesced: the tile is a
// contiguous stretch of the output). Means: the bins' sum is separable
// too, sum_{ph,pw} Ay Ax = (sum_ph Ay)(sum_pw Ax), so the thread makes one
// weighted sum over the ROI's footprint with the summed rows and columns
// and writes only the mean, one value a channel. Sample positions follow
// the plain version's f32 operation order, each step rounded on its own.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace runia {

constexpr int kRoiThreads = 128;  // channels a block covers

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);
template <>
__device__ __forceinline__ float load_f32<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

struct RoiAxis {
  float start, bin;
  int grid;
};

// Accumulate the interpolation weights of bin `p` along one axis into
// `row` (size entries, zeroed), and return its footprint [lo, hi] (lo > hi:
// no sample). The plain version's arithmetic (ops/roi_align.py::_axis_weights).
__device__ void axis_row(const RoiAxis ax, int p, int size, float* row, int* lo, int* hi) {
  const float grid_div = fmaxf(static_cast<float>(ax.grid), 1.0f);
  const float w = __fdiv_rn(1.0f, grid_div);
  const float origin = __fadd_rn(ax.start, __fmul_rn(static_cast<float>(p), ax.bin));
  int first = size, last = -1;
  for (int i = 0; i < ax.grid; ++i) {
    const float pos = __fadd_rn(origin, __fdiv_rn(__fmul_rn(ax.bin, static_cast<float>(i) + 0.5f), grid_div));
    if (!isfinite(pos) || pos < -1.0f || pos > static_cast<float>(size)) continue;
    float q = fmaxf(pos, 0.0f);
    int low = static_cast<int>(floorf(q));
    if (low >= size - 1) {
      low = size - 1;
      q = static_cast<float>(low);
    }
    const int high = min(low + 1, size - 1);
    const float frac = __fsub_rn(q, static_cast<float>(low));
    row[low] = __fadd_rn(row[low], __fmul_rn(w, __fsub_rn(1.0f, frac)));
    row[high] = __fadd_rn(row[high], __fmul_rn(w, frac));
    first = min(first, low);
    last = max(last, high);
  }
  *lo = first;
  *hi = last;
}

__device__ RoiAxis roi_axis(float a, float b, float scale, float offset, int aligned, int out, int sampling_ratio,
                            int max_samples) {
  const float lo = __fsub_rn(__fmul_rn(a, scale), offset);
  const float hi = __fsub_rn(__fmul_rn(b, scale), offset);
  float extent = __fsub_rn(hi, lo);
  if (!aligned) extent = fmaxf(extent, 1.0f);
  const float bin = __fdiv_rn(extent, static_cast<float>(out));
  int grid = sampling_ratio;
  if (sampling_ratio <= 0) {
    const float g = ceilf(bin);
    grid = g != g ? 0 : static_cast<int>(fminf(fmaxf(g, 0.0f), static_cast<float>(max_samples)));
  }
  return {lo, bin, grid};
}

// Shared memory: ay (oh * H), ax (ow * W), wy (H), wx (W) floats, the bins'
// footprints (2 * oh + 2 * ow ints), and for the pooled output a tile of
// blockDim.x * oh * ow floats.
template <typename T, bool kMean>
__global__ void __launch_bounds__(kRoiThreads)
roi_align_kernel(const T* __restrict__ fmap, const float* __restrict__ boxes, T* __restrict__ out, int rois_per_image,
                 int H, int W, int C, int oh, int ow, float scale, float offset, int aligned, int sampling_ratio,
                 int max_samples) {
  extern __shared__ float smem[];
  float* ay = smem;
  float* ax = ay + oh * H;
  float* wy = ax + ow * W;
  float* wx = wy + H;
  int* ylo = reinterpret_cast<int*>(wx + W);
  int* yhi = ylo + oh;
  int* xlo = yhi + oh;
  int* xhi = xlo + ow;
  float* tile = reinterpret_cast<float*>(xhi + ow);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < oh * H + ow * W; i += blockDim.x) ay[i] = 0.0f;
  __syncthreads();
  const float* box = boxes + 4 * static_cast<size_t>(k);
  const RoiAxis ry = roi_axis(box[1], box[3], scale, offset, aligned, oh, sampling_ratio, max_samples);
  const RoiAxis rx = roi_axis(box[0], box[2], scale, offset, aligned, ow, sampling_ratio, max_samples);
  for (int r = tid; r < oh + ow; r += blockDim.x) {
    if (r < oh) axis_row(ry, r, H, ay + r * H, ylo + r, yhi + r);
    else axis_row(rx, r - oh, W, ax + (r - oh) * W, xlo + r - oh, xhi + r - oh);
  }
  __syncthreads();

  const int c0 = blockIdx.y * blockDim.x;
  const int c = c0 + tid;
  const T* img = fmap + static_cast<size_t>(k / rois_per_image) * H * W * C;
  if constexpr (kMean) {
    // Summed rows and columns; the ROI's footprint is the union of its bins'.
    for (int y = tid; y < H; y += blockDim.x) {
      float s = 0.0f;
      for (int p = 0; p < oh; ++p) s = __fadd_rn(s, ay[p * H + y]);
      wy[y] = s;
    }
    for (int x = tid; x < W; x += blockDim.x) {
      float s = 0.0f;
      for (int p = 0; p < ow; ++p) s = __fadd_rn(s, ax[p * W + x]);
      wx[x] = s;
    }
    __syncthreads();
    if (c >= C) return;
    int y0 = H, y1 = -1, x0 = W, x1 = -1;
    for (int p = 0; p < oh; ++p) y0 = min(y0, ylo[p]), y1 = max(y1, yhi[p]);
    for (int p = 0; p < ow; ++p) x0 = min(x0, xlo[p]), x1 = max(x1, xhi[p]);
    float acc = 0.0f;
    for (int y = y0; y <= y1; ++y) {
      const T* src = img + static_cast<size_t>(y) * W * C + c;
      float row = 0.0f;
      for (int x = x0; x <= x1; ++x) row = fmaf(wx[x], load_f32(src + static_cast<size_t>(x) * C), row);
      acc = fmaf(wy[y], row, acc);
    }
    out[static_cast<size_t>(k) * C + c] = store_as<T>(acc / static_cast<float>(oh * ow));
  } else {
    const int bins = oh * ow;
    if (c < C) {
      for (int ph = 0; ph < oh; ++ph) {
        for (int pw = 0; pw < ow; ++pw) {
          float acc = 0.0f;
          for (int y = ylo[ph]; y <= yhi[ph]; ++y) {
            const T* src = img + static_cast<size_t>(y) * W * C + c;
            float row = 0.0f;
            for (int x = xlo[pw]; x <= xhi[pw]; ++x) {
              row = fmaf(ax[pw * W + x], load_f32(src + static_cast<size_t>(x) * C), row);
            }
            acc = fmaf(ay[ph * H + y], row, acc);
          }
          tile[tid * bins + ph * ow + pw] = acc;
        }
      }
    }
    __syncthreads();
    // The block's channels are one contiguous stretch of the output.
    const int valid = min(C - c0, static_cast<int>(blockDim.x)) * bins;
    T* dst = out + (static_cast<size_t>(k) * C + c0) * bins;
    for (int i = tid; i < valid; i += blockDim.x) dst[i] = store_as<T>(tile[i]);
  }
}

template <typename T, bool kMean>
int launch_roi_align(const void* fmap, const void* boxes, void* out, int K, int rois_per_image, int H, int W, int C,
                     int oh, int ow, float scale, float offset, int aligned, int sampling_ratio, int max_samples,
                     int threads, size_t smem, cudaStream_t stream) {
  auto kernel = roi_align_kernel<T, kMean>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(K, (C + threads - 1) / threads);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(fmap), static_cast<const float*>(boxes),
                                          static_cast<T*>(out), rois_per_image, H, W, C, oh, ow, scale, offset,
                                          aligned, sampling_ratio, max_samples);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace runia

// fmap: (B, H, W, C) contiguous, bf16 = 1 for __nv_bfloat16 else f32; boxes:
// (K, 4) f32, K = B * rois_per_image; out: (K, C) with mean = 1, else
// (K, C, oh, ow), in the map's dtype. threads: the block width (a multiple
// of 32, at most 128), smem: the dynamic shared memory the wrapper computed.
extern "C" int runia_roi_align(const void* fmap, const void* boxes, void* out, int K, int rois_per_image, int H,
                               int W, int C, int oh, int ow, float scale, int aligned, int sampling_ratio,
                               int max_samples, int bf16, int mean, int threads, int smem, void* stream) {
  using namespace runia;
  if (K <= 0 || rois_per_image <= 0 || H <= 0 || W <= 0 || C <= 0 || oh <= 0 || ow <= 0 || threads < 32 ||
      threads > kRoiThreads || threads % 32 || smem <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float offset = aligned ? 0.5f : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (bf16) {
    return mean ? launch_roi_align<__nv_bfloat16, true>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale,
                                                        offset, aligned, sampling_ratio, max_samples, threads, bytes, s)
                : launch_roi_align<__nv_bfloat16, false>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale,
                                                         offset, aligned, sampling_ratio, max_samples, threads, bytes,
                                                         s);
  }
  return mean ? launch_roi_align<float, true>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                              aligned, sampling_ratio, max_samples, threads, bytes, s)
              : launch_roi_align<float, false>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                               aligned, sampling_ratio, max_samples, threads, bytes, s);
}
