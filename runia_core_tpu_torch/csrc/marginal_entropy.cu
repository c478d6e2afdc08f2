// Marginal Kozachenko-Leonenko entropy: clouds (B, n, d) f32 -> (B, d) f32.
//
// Replaces: runia_core_tpu/ops/entropy_pallas.py::marginal_entropy_pallas
// (kernel body _entropy_kernel), the TPU kernel that holds 8 clouds x a
// 512-wide dimension tile in VMEM and takes the k-th neighbour by k+1
// min-and-mask passes over the (n, n) distance block.
//
// Bound on the H100: the input is read once, B*n*d*4 bytes (16.8 MB at the
// scorer's (512, 16, 512)), and the selection costs about 2*(k+1)*n^2 min/max
// operations per column. At n = 16, k = 5 both are small; which one limits
// depends on occupancy, so the design keeps the read at one coalesced pass
// and the selection in registers.
//
// Design: one thread per (image, dimension) column, up to 128 threads along
// d, so each of the n loads of a column is one coalesced row across the
// block. The column is staged in dynamic shared memory (stride = block
// width, no bank conflicts; opted in above 48 KB, so n runs past the 64 the
// TPU kernel's callers use: the wrapper narrows the block from 128 threads
// to 64 where n columns would not fit) and the K+1 smallest distances per
// point live in registers (kl_entropy.cuh). The ragged d edge is masked by
// returning early; the TPU's +inf sentinel padding of n and d is an
// (8, 128)-tiling artefact and is not copied. The digamma constant comes
// from the host in float64, rounded once to f32, exactly as the plain
// version adds it.
#include "kl_entropy.cuh"

namespace runia {

template <int K>
__global__ void __launch_bounds__(kBlock)
marginal_entropy_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int n, int d, float min_dist, float cnst) {
  extern __shared__ float cols[];  // n * blockDim.x floats
  const int b = blockIdx.x;
  const int width = blockDim.x;
  const int dim = blockIdx.y * width + threadIdx.x;
  // Each thread reads only its own column, so there is no barrier and the
  // threads past the ragged edge may leave at once.
  if (dim >= d) return;
  const float* src = x + static_cast<size_t>(b) * n * d + dim;
  float* col = cols + threadIdx.x;
  for (int i = 0; i < n; ++i) col[i * width] = src[static_cast<size_t>(i) * d];
  out[static_cast<size_t>(b) * d + dim] =
      cnst + kl_log_sum<K>(col, n, width, min_dist) / static_cast<float>(n);
}

template <int K>
int launch_marginal_entropy(const float* x, float* out, int B, int n, int d, int width,
                            float min_dist, float cnst, cudaStream_t stream) {
  if (!valid_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n) * width * sizeof(float);
  const cudaError_t err = allow_smem(marginal_entropy_kernel<K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (d + width - 1) / width);
  marginal_entropy_kernel<K><<<grid, width, smem, stream>>>(x, out, n, d, min_dist, cnst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace runia

extern "C" int runia_marginal_entropy(const void* x, void* out, int B, int n, int d, int k,
                                      int width, float min_dist, float cnst, void* stream) {
  RUNIA_DISPATCH_K(k, runia::launch_marginal_entropy, static_cast<const float*>(x),
                   static_cast<float*>(out), B, n, d, width, min_dist, cnst,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* runia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
