// Fused MC-DropBlock channel means + marginal KL entropy:
// keep-weights (B, S, HW) f32 and feature map (B, HW, C) f32 -> (B, C) f32.
//
// Replaces: runia_core_tpu/ops/mc_entropy_pallas.py::fused_mc_entropy
// (kernel body _kernel), the TPU kernel that forms each image's
// (S, HW) @ (HW, C_tile) / HW sample block on the MXU and runs the
// min-and-mask entropy on it in VMEM. The keep-weights are made outside the
// kernel (ops/mc_entropy_cuda.py::mc_dropblock_weights), as on the TPU.
//
// Bound on the H100: one read of the feature map, B*HW*C*4 bytes (16.8 MB
// for the scorer's (512, 4, 4, 512) tap); the (B, S, C) samples never
// reach device memory. The per-image product is (16 x 16) @ (16 x C): far
// too small for tensor cores to matter, so it runs as FMAs (wgmma and TMA
// are later work).
//
// Design: one block per (image, tile of up to 128 channels). The block
// stages w[b] (S*HW floats) in dynamic shared memory; each thread owns one
// channel, walks p over HW reading x[b, p, c] once (coalesced over c) and
// accumulates its S sample values in shared memory (stride = block width,
// no bank conflicts; the weight reads are warp-wide broadcasts). The
// wrapper narrows the block to 64 or 32 channels where S * (HW + 128) floats
// would pass the 227 KB a block may opt into, so S runs to 512 at the
// scorer's taps. The samples are divided by HW, as the
// TPU kernel does, and go through the same entropy function as
// marginal_entropy.cu. Layout: the caller passes the NHWC tap, which is
// already (B, HW, C) contiguous when the forward ran channels_last, so no
// copy is made for it.
#include "kl_entropy.cuh"

namespace runia {

template <int K>
__global__ void __launch_bounds__(kBlock)
fused_mc_entropy_kernel(const float* __restrict__ w, const float* __restrict__ x,
                        float* __restrict__ out, int S, int HW, int C,
                        float min_dist, float cnst) {
  extern __shared__ float smem[];
  float* w_s = smem;                // S * HW keep-weights of image b
  float* samples = smem + S * HW;   // S * width sample values
  const int b = blockIdx.x;
  const int width = blockDim.x;
  const int c = blockIdx.y * width + threadIdx.x;

  const float* wb = w + static_cast<size_t>(b) * S * HW;
  for (int idx = threadIdx.x; idx < S * HW; idx += width) w_s[idx] = wb[idx];
  __syncthreads();
  if (c >= C) return;  // ragged channel edge; no barrier follows

  float* col = samples + threadIdx.x;
  for (int s = 0; s < S; ++s) col[s * width] = 0.f;
  const float* xb = x + static_cast<size_t>(b) * HW * C + c;
  for (int p = 0; p < HW; ++p) {
    const float xv = xb[static_cast<size_t>(p) * C];
    for (int s = 0; s < S; ++s) col[s * width] = fmaf(w_s[s * HW + p], xv, col[s * width]);
  }
  const float hw = static_cast<float>(HW);
  for (int s = 0; s < S; ++s) col[s * width] = col[s * width] / hw;

  out[static_cast<size_t>(b) * C + c] =
      cnst + kl_log_sum<K>(col, S, width, min_dist) / static_cast<float>(S);
}

template <int K>
int launch_fused_mc_entropy(const float* w, const float* x, float* out, int B, int S, int HW,
                            int C, int width, float min_dist, float cnst, cudaStream_t stream) {
  if (!valid_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(S) * (HW + width) * sizeof(float);
  const cudaError_t err = allow_smem(fused_mc_entropy_kernel<K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (C + width - 1) / width);
  fused_mc_entropy_kernel<K><<<grid, width, smem, stream>>>(w, x, out, S, HW, C, min_dist, cnst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace runia

extern "C" int runia_fused_mc_entropy(const void* w, const void* x, void* out, int B, int S,
                                      int HW, int C, int k, int width, float min_dist,
                                      float cnst, void* stream) {
  RUNIA_DISPATCH_K(k, runia::launch_fused_mc_entropy, static_cast<const float*>(w),
                   static_cast<const float*>(x), static_cast<float*>(out), B, S, HW, C, width,
                   min_dist, cnst, static_cast<cudaStream_t>(stream));
}
