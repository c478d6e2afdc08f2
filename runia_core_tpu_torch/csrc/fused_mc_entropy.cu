// Fused MC-DropBlock channel means + marginal KL entropy:
// keep-weights (B, S, HW) f32 and feature map (B, HW, C) f32 or bf16 -> (B, C) f32.
//
// Replaces: runia_core_tpu/ops/mc_entropy_pallas.py::fused_mc_entropy
// (kernel body _kernel), the TPU kernel that forms each image's
// (S, HW) @ (HW, C_tile) / HW sample block on the MXU and runs the
// min-and-mask entropy on it in VMEM. The keep-weights are made outside the
// kernel (ops/mc_entropy_cuda.py::mc_dropblock_weights), as on the TPU.
//
// Bound on the H100: one read of the feature map, B*HW*C elements (16.8 MB
// in f32, 8.4 MB in bf16 for the scorer's (512, 4, 4, 512) tap); the
// (B, S, C) samples never reach device memory. The per-image product is
// (16 x 16) @ (16 x C), 0.13 GFLOP in all at that tap: FMAs on the f32 units
// take less time than the read. No tensor cores: f32 inputs would go
// through TF32, which changes the result, and the product is too small for
// them to matter.
//
// Design: one block per (image, tile of up to 128 channels), one thread per
// channel. The thread walks p over HW, p ascending, reading x[b, p, c] once
// (coalesced over c; a bf16 map is widened in registers, which is exact) and
// accumulates up to 64 sample sums in registers. For S <= 64 the block's
// keep-weights are staged sample-minor (w_s[p][s], rows padded with zeros to
// the 8, 16, 32 or 64 sums a thread holds), so one 16-byte broadcast read
// feeds four FMAs and nothing but the weights touches shared memory before
// the window pass.
// For S > 64, or where the padded rows would not fit beside the samples,
// the weights keep their (S, HW) layout, one broadcast read per FMA, and
// the samples are formed 64 at a time, the map's HW values re-read per
// chunk from L1. The sums are divided by HW (a division, as the plain
// version divides) and are then the unsorted column: sorted in registers,
// merged and windowed as in marginal_entropy.cu (kl_entropy.cuh). The
// wrapper narrows the block to 64 or 32 channels where the weights and S
// sorted samples per channel would pass the 227 KB a block may opt into, so
// S runs to 512 at the scorer's taps. Layout: the caller passes the NHWC
// tap, which is already (B, HW, C) contiguous when the forward ran
// channels_last, so no copy is made for it.
#include <cuda_bf16.h>

#include "kl_entropy.cuh"

namespace runia {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Floats of the staged keep-weights: HW sample-minor rows of W, or (S, HW) as it lies.
template <int W, bool SAMPLE_MINOR>
__host__ __device__ inline int weight_floats(int S, int HW) {
  return SAMPLE_MINOR ? HW * W : S * HW;
}

// W: samples formed and sorted in registers at a time (W >= S where
// SAMPLE_MINOR). K > 0 (only with SAMPLE_MINOR): k is that constant, the
// samples never leave registers and shared memory holds the weights alone.
// The launcher grants all of it.
template <int W, bool SAMPLE_MINOR, int K, typename T>
__global__ void __launch_bounds__(kBlock)
fused_mc_entropy_kernel(const float* __restrict__ w, const T* __restrict__ x,
                        float* __restrict__ out, int S, int HW, int C, int k,
                        float min_dist, float cnst) {
  extern __shared__ float4 smem4[];  // 16-byte aligned: the weight rows are read as float4
  float* w_s = reinterpret_cast<float*>(smem4);
  float* samples = w_s + weight_floats<W, SAMPLE_MINOR>(S, HW);  // K = 0: S * width sorted sample values
  const int b = blockIdx.x;
  const int width = blockDim.x;
  const int c = blockIdx.y * width + threadIdx.x;

  const float* wb = w + static_cast<size_t>(b) * S * HW;
  if constexpr (SAMPLE_MINOR) {
    // Read as it lies, (S, HW), and written transposed; the rows' padding is zeroed.
    for (int idx = threadIdx.x; idx < S * HW; idx += width) {
      const int s = idx / HW, p = idx - s * HW;
      w_s[p * W + s] = wb[idx];
    }
    for (int idx = threadIdx.x; idx < HW * (W - S); idx += width) {
      const int p = idx / (W - S), s = S + idx - p * (W - S);
      w_s[p * W + s] = 0.f;
    }
  } else {
    for (int idx = threadIdx.x; idx < S * HW; idx += width) w_s[idx] = wb[idx];
  }
  __syncthreads();
  if (c >= C) return;  // ragged channel edge; no barrier follows

  float* col = samples + threadIdx.x;
  float sum = 0.f;
  const T* xb = x + static_cast<size_t>(b) * HW * C + c;
  const float hw = static_cast<float>(HW);
  const int end = W < kChunk ? 1 : S;  // a narrower instance holds all S samples: one pass
  for (int base = 0; base < end; base += W) {
    const int valid = min(W, S - base);
    float acc[W];
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] = 0.f;
#pragma unroll 4
    for (int p = 0; p < HW; ++p) {
      const float xv = widen(xb[static_cast<size_t>(p) * C]);
      if constexpr (SAMPLE_MINOR) {
        const float4* wp = reinterpret_cast<const float4*>(w_s + p * W);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const float4 w4 = wp[q];
          acc[4 * q + 0] = fmaf(w4.x, xv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(w4.y, xv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(w4.z, xv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(w4.w, xv, acc[4 * q + 3]);
        }
      } else {
        const float* wp = w_s + base * HW + p;
#pragma unroll
        for (int s = 0; s < W; ++s)
          if (s < valid) acc[s] = fmaf(wp[s * HW], xv, acc[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] = s < valid ? acc[s] / hw : kBig;
    if constexpr (K > 0) {
      sort_registers<W>(acc);
      sum = kl_log_sum_registers<W, K>(acc, S, min_dist);
    } else {
      sort_into_column<W>(acc, valid, col + base * width, width);
    }
  }
  if constexpr (K == 0) {
    if constexpr (W == kChunk) merge_sorted_chunks(col, S, width, W);
    sum = kl_log_sum(col, S, width, k, min_dist);
  }
  out[static_cast<size_t>(b) * C + c] = cnst + sum / static_cast<float>(S);
}

template <int W, bool SAMPLE_MINOR, int K, typename T>
int launch_fused(const float* w, const void* x, float* out, int B, int S, int HW, int C, int k,
                 int width, float min_dist, float cnst, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(weight_floats<W, SAMPLE_MINOR>(S, HW)) +
                       (K > 0 ? 0 : static_cast<size_t>(S) * width)) * sizeof(float);
  const cudaError_t err = allow_smem(fused_mc_entropy_kernel<W, SAMPLE_MINOR, K, T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (C + width - 1) / width);
  fused_mc_entropy_kernel<W, SAMPLE_MINOR, K, T><<<grid, width, smem, stream>>>(
      w, static_cast<const T*>(x), out, S, HW, C, k, min_dist, cnst);
  return static_cast<int>(cudaGetLastError());
}

template <int W, typename T>
int dispatch_sample_minor(bool static_k, const float* w, const void* x, float* out, int B, int S,
                          int HW, int C, int k, int width, float min_dist, float cnst,
                          cudaStream_t stream) {
  if (static_k)
    return launch_fused<W, true, kStaticK, T>(w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
  return launch_fused<W, true, 0, T>(w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
}

template <typename T>
int dispatch_fused(const float* w, const void* x, float* out, int B, int S, int HW, int C, int k,
                   int register_width, int sample_minor, int static_k, int width, float min_dist,
                   float cnst, cudaStream_t stream) {
  if (!sample_minor) {
    if (register_width != kChunk || static_k) return static_cast<int>(cudaErrorInvalidValue);
    return launch_fused<kChunk, false, 0, T>(w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
  }
  if (S > register_width || (static_k && k != kStaticK)) return static_cast<int>(cudaErrorInvalidValue);
  switch (register_width) {
    case 8: return dispatch_sample_minor<8, T>(static_k, w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
    case 16: return dispatch_sample_minor<16, T>(static_k, w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
    case 32: return dispatch_sample_minor<32, T>(static_k, w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
    case 64: return dispatch_sample_minor<64, T>(static_k, w, x, out, B, S, HW, C, k, width, min_dist, cnst, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace runia

// static_k: 1 takes the instance with k = 5 compiled in (needs k == 5 and
// sample-minor weights), 0 the one that takes k at run time. map_bf16: the
// feature map's element type, 0 for f32 and 1 for bf16.
extern "C" int runia_fused_mc_entropy(const void* w, const void* x, void* out, int B, int S,
                                      int HW, int C, int k, int register_width, int sample_minor,
                                      int static_k, int width, int map_bf16, float min_dist,
                                      float cnst, void* stream) {
  using namespace runia;
  if (!valid_width(width) || k < 1 || k >= S) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_bf16)
    return dispatch_fused<__nv_bfloat16>(wf, x, o, B, S, HW, C, k, register_width, sample_minor,
                                         static_k, width, min_dist, cnst, s);
  return dispatch_fused<float>(wf, x, o, B, S, HW, C, k, register_width, sample_minor, static_k,
                               width, min_dist, cnst, s);
}
