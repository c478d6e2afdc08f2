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
// back to average it. DETR's 100 pooled ROIs write 40 MB.
//
// What held the first design back was latency, not bytes: one thread a
// channel walked a ROI's taps on one dependent chain, one 4- or 2-byte
// load in flight, and a ROI's whole footprint (6,400 cells for a whole-image
// box on an 80 x 80 map) sat on one thread.
//
// Design: one block per (ROI, channel tile). A thread takes a vector of
// V channels with one 16-byte load a tap (4 f32 or 8 bf16; V = 1, scalar
// loads, where C is not a multiple of it or the map's base is not 16-byte
// aligned), neighbouring threads neighbouring vectors, so each map tap is
// one coalesced row of channels in the NHWC order the forward leaves. The
// block's threads are (vector j, group g) pairs, j fastest: ops/roi_align.py
// ::_plan picks the tile's width and the groups from (K, C, H, W, bins), so
// that the grid fills the card and no tile is left half idle. The block
// first builds its ROI's separable interpolation weights in shared memory,
// as the JAX form does: Ay (oh, H) and Ax (ow, W), row r by thread r,
// summing the bilinear weights of the row's samples in order, and each bin's
// footprint (its first and last map row and column with a sample). Then:
// * pooled: group g takes bins g, g + groups, ...; for each it sums
//   sum_y Ay[ph, y] sum_x Ax[pw, x] F[y, x, c] over the bin's footprint,
//   the x loop unrolled so that several loads are in flight, into a
//   shared-memory tile in output order (channel-major, the tile one
//   contiguous stretch of the (K, C, oh, ow) output), written out
//   coalesced.
// * means: the bins' sum is separable, sum_{ph,pw} Ay Ax = (sum_ph Ay)
//   (sum_pw Ax), so one weighted sum over the ROI's footprint with the
//   summed rows and columns gives it; group g takes footprint rows g,
//   g + groups, ..., and the block adds the groups' partial sums in shared
//   memory in group order, a fixed order, so two runs agree bit for bit.
// Sample positions follow the plain version's f32 operation order, each
// step rounded on its own.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace runia {

constexpr int kRoiMaxThreads = 512;

// V channels from p (16-byte aligned where V > 1) as floats.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]);
template <>
__device__ __forceinline__ void load_vec<float, 1>(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
template <>
__device__ __forceinline__ void load_vec<float, 4>(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 1>(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, 8>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
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

// acc[i] += wy * sum_{x in [x0, x1]} wx[x] * src[x * C + i], src V channels
// of one map row.
template <typename T, int V>
__device__ __forceinline__ void row_taps(const T* src, int C, const float* wx, int x0, int x1, float wy,
                                         float (&acc)[V]) {
  float row[V];
#pragma unroll
  for (int i = 0; i < V; ++i) row[i] = 0.0f;
#pragma unroll 4
  for (int x = x0; x <= x1; ++x) {
    float v[V];
    load_vec<T, V>(src + static_cast<size_t>(x) * C, v);
    const float w = wx[x];
#pragma unroll
    for (int i = 0; i < V; ++i) row[i] = fmaf(w, v[i], row[i]);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(wy, row[i], acc[i]);
}

// Shared memory: ay (oh * H), ax (ow * W), wy (H), wx (W) floats, the bins'
// footprints (2 * oh + 2 * ow ints), then for the pooled output a tile of
// tile * V * oh * ow values of T, for the means groups * tile * V floats.
// tile: channel vectors a block covers; groups: bins (pooled) or footprint
// rows (means) split over that many thread groups.
template <typename T, int V, bool kMean>
__global__ void __launch_bounds__(kRoiMaxThreads)
roi_align_kernel(const T* __restrict__ fmap, const float* __restrict__ boxes, T* __restrict__ out, int rois_per_image,
                 int H, int W, int C, int oh, int ow, float scale, float offset, int aligned, int sampling_ratio,
                 int max_samples, int tile, int groups) {
  extern __shared__ float smem[];
  float* ay = smem;
  float* ax = ay + oh * H;
  float* wy = ax + ow * W;
  float* wx = wy + H;
  int* ylo = reinterpret_cast<int*>(wx + W);
  int* yhi = ylo + oh;
  int* xlo = yhi + oh;
  int* xhi = xlo + ow;

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

  const int c0 = blockIdx.y * tile * V;       // the tile's first channel
  const int tile_c = min(C - c0, tile * V);   // its channels
  const int j = tid % tile, g = tid / tile;   // vector j, group g
  const bool active = g < groups && j * V < tile_c;
  const int c = c0 + j * V;
  const T* img = fmap + static_cast<size_t>(k / rois_per_image) * H * W * C + c;
  float acc[V];
  if constexpr (kMean) {
    float* part = reinterpret_cast<float*>(xhi + ow);  // groups x tile * V
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
    if (active) {
      int y0 = H, y1 = -1, x0 = W, x1 = -1;
      for (int p = 0; p < oh; ++p) y0 = min(y0, ylo[p]), y1 = max(y1, yhi[p]);
      for (int p = 0; p < ow; ++p) x0 = min(x0, xlo[p]), x1 = max(x1, xhi[p]);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      for (int y = y0 + g; y <= y1; y += groups) {
        row_taps<T, V>(img + static_cast<size_t>(y) * W * C, C, wx, x0, x1, wy[y], acc);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) part[g * tile * V + j * V + i] = acc[i];
    }
    __syncthreads();
    const float bins = static_cast<float>(oh * ow);
    for (int ch = tid; ch < tile_c; ch += blockDim.x) {
      float s = 0.0f;
      for (int q = 0; q < groups; ++q) s = __fadd_rn(s, part[q * tile * V + ch]);
      out[static_cast<size_t>(k) * C + c0 + ch] = store_as<T>(s / bins);
    }
  } else {
    T* staged = reinterpret_cast<T*>(xhi + ow);  // tile * V channels x bins, output order
    const int bins = oh * ow;
    if (active) {
      for (int p = g; p < bins; p += groups) {
        const int ph = p / ow, pw = p - ph * ow;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
        for (int y = ylo[ph]; y <= yhi[ph]; ++y) {
          row_taps<T, V>(img + static_cast<size_t>(y) * W * C, C, ax + pw * W, xlo[pw], xhi[pw], ay[ph * H + y], acc);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) staged[(j * V + i) * bins + p] = store_as<T>(acc[i]);
      }
    }
    __syncthreads();
    // The block's channels are one contiguous stretch of the output.
    const int valid = tile_c * bins;
    T* dst = out + (static_cast<size_t>(k) * C + c0) * bins;
    for (int i = tid; i < valid; i += blockDim.x) dst[i] = staged[i];
  }
}

template <typename T, int V, bool kMean>
int launch_roi_align(const void* fmap, const void* boxes, void* out, int K, int rois_per_image, int H, int W, int C,
                     int oh, int ow, float scale, float offset, int aligned, int sampling_ratio, int max_samples,
                     int tile, int groups, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = roi_align_kernel<T, V, kMean>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vectors = (C + V - 1) / V;
  const dim3 grid(K, (vectors + tile - 1) / tile);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(fmap), static_cast<const float*>(boxes),
                                          static_cast<T*>(out), rois_per_image, H, W, C, oh, ow, scale, offset,
                                          aligned, sampling_ratio, max_samples, tile, groups);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_mode(int mean, const void* fmap, const void* boxes, void* out, int K, int rois_per_image, int H, int W,
                int C, int oh, int ow, float scale, float offset, int aligned, int sampling_ratio, int max_samples,
                int tile, int groups, int threads, size_t smem, cudaStream_t stream) {
  return mean ? launch_roi_align<T, V, true>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                             aligned, sampling_ratio, max_samples, tile, groups, threads, smem, stream)
              : launch_roi_align<T, V, false>(fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                              aligned, sampling_ratio, max_samples, tile, groups, threads, smem,
                                              stream);
}

}  // namespace runia

// fmap: (B, H, W, C) contiguous, bf16 = 1 for __nv_bfloat16 else f32; boxes:
// (K, 4) f32, K = B * rois_per_image; out: (K, C) with mean = 1, else
// (K, C, oh, ow), in the map's dtype. vec = 1: 16-byte loads (C a multiple
// of 4 f32 or 8 bf16, the map 16-byte aligned). tile (channel vectors a
// block), groups, threads (>= tile * groups, at most 512) and smem (its
// dynamic shared bytes): ops/roi_align.py::_plan.
extern "C" int runia_roi_align(const void* fmap, const void* boxes, void* out, int K, int rois_per_image, int H,
                               int W, int C, int oh, int ow, float scale, int aligned, int sampling_ratio,
                               int max_samples, int bf16, int mean, int vec, int tile, int groups, int threads,
                               int smem, void* stream) {
  using namespace runia;
  const int width = vec ? (bf16 ? 8 : 4) : 1;
  if (K <= 0 || rois_per_image <= 0 || H <= 0 || W <= 0 || C <= 0 || oh <= 0 || ow <= 0 || tile <= 0 ||
      groups <= 0 || threads > kRoiMaxThreads || threads < tile * groups || smem <= 0 || C % width ||
      reinterpret_cast<uintptr_t>(fmap) % (vec ? 16 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float offset = aligned ? 0.5f : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (bf16) {
    return vec ? launch_mode<__nv_bfloat16, 8>(mean, fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale,
                                                offset, aligned, sampling_ratio, max_samples, tile, groups, threads,
                                                bytes, s)
               : launch_mode<__nv_bfloat16, 1>(mean, fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale,
                                                offset, aligned, sampling_ratio, max_samples, tile, groups, threads,
                                                bytes, s);
  }
  return vec ? launch_mode<float, 4>(mean, fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                     aligned, sampling_ratio, max_samples, tile, groups, threads, bytes, s)
             : launch_mode<float, 1>(mean, fmap, boxes, out, K, rois_per_image, H, W, C, oh, ow, scale, offset,
                                     aligned, sampling_ratio, max_samples, tile, groups, threads, bytes, s);
}
