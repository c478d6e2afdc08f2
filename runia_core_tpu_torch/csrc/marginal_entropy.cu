// Marginal Kozachenko-Leonenko entropy: clouds (B, n, d) f32 -> (B, d) f32.
//
// Replaces: runia_core_tpu/ops/entropy_pallas.py::marginal_entropy_pallas
// (kernel body _entropy_kernel), the TPU kernel that holds 8 clouds x a
// 512-wide dimension tile in VMEM and takes the k-th neighbour by k+1
// min-and-mask passes over the (n, n) distance block.
//
// Bound on the H100: the one read of the input, B*n*d*4 bytes (16.8 MB at
// the scorer's (512, 16, 512): 0.005 ms at 3.35 TB/s). The function itself
// needs one sort and a window per column, about 620 operations at n = 16,
// k = 5, which is less time than the read; the n^2 selection of the TPU
// kernel's block is not needed and not copied.
//
// Design: one thread per (image, dimension) column, up to 128 threads along
// d, so each of the n loads of a column is one coalesced row across the
// block, and a thread has up to 64 independent loads in flight. The values
// are sorted in registers (n <= 64: once, padded to 8, 16, 32 or 64 with
// 1e30; longer columns 64 at a time, merged in shared memory). With the
// estimator's usual k = 5 and n <= 64 the k-th neighbour distances are taken
// from those registers by an instance with k compiled in, and no shared
// memory is used; for any other k they are taken from the sorted column in
// shared memory with k at run time (kl_entropy.cuh). Each thread touches only its own column,
// so there is no barrier and the ragged d edge leaves at once; the TPU's
// +inf sentinel padding of d is an (8, 128)-tiling artefact and is not
// copied. The digamma constant comes from the host in float64, rounded once
// to f32, exactly as the plain version adds it.
#include "kl_entropy.cuh"

namespace runia {

// W: values sorted in registers at a time. K > 0: k is that constant and
// n <= W, the whole column stays in registers and no shared memory is used.
// K = 0: k is taken at run time, W >= n where n <= 64 and W = 64 for longer
// columns. The launcher grants all of it.
template <int W, int K>
__global__ void __launch_bounds__(kBlock)
marginal_entropy_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int n, int d, int k, float min_dist, float cnst) {
  extern __shared__ float cols[];  // K = 0: n * blockDim.x floats
  const int b = blockIdx.x;
  const int width = blockDim.x;
  const int dim = blockIdx.y * width + threadIdx.x;
  if (dim >= d) return;
  const float* src = x + static_cast<size_t>(b) * n * d + dim;
  float sum;
  if constexpr (K > 0) {
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i, src += d) v[i] = i < n ? *src : kBig;
    sort_registers<W>(v);
    sum = kl_log_sum_registers<W, K>(v, n, min_dist);
  } else {
    float* col = cols + threadIdx.x;
    const int end = W < kChunk ? 1 : n;  // a narrower instance holds the whole column: one pass
    for (int base = 0; base < end; base += W) {
      const int valid = min(W, n - base);
      float v[W];
#pragma unroll
      for (int i = 0; i < W; ++i, src += d) v[i] = i < valid ? *src : kBig;
      sort_into_column<W>(v, valid, col + base * width, width);
    }
    if constexpr (W == kChunk) merge_sorted_chunks(col, n, width, W);
    sum = kl_log_sum(col, n, width, k, min_dist);
  }
  out[static_cast<size_t>(b) * d + dim] = cnst + sum / static_cast<float>(n);
}

template <int W, int K>
int launch_marginal_entropy(const float* x, float* out, int B, int n, int d, int k, int width,
                            float min_dist, float cnst, cudaStream_t stream) {
  const size_t smem = K > 0 ? 0 : static_cast<size_t>(n) * width * sizeof(float);
  const cudaError_t err = allow_smem(marginal_entropy_kernel<W, K>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, (d + width - 1) / width);
  marginal_entropy_kernel<W, K><<<grid, width, smem, stream>>>(x, out, n, d, k, min_dist, cnst);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int dispatch_marginal_entropy(bool static_k, const float* x, float* out, int B, int n, int d, int k,
                              int width, float min_dist, float cnst, cudaStream_t stream) {
  if (static_k) return launch_marginal_entropy<W, kStaticK>(x, out, B, n, d, k, width, min_dist, cnst, stream);
  return launch_marginal_entropy<W, 0>(x, out, B, n, d, k, width, min_dist, cnst, stream);
}

}  // namespace runia

// static_k: 1 takes the instance with k = 5 compiled in (needs k == 5 and
// n <= register_width), 0 the one that takes k at run time.
extern "C" int runia_marginal_entropy(const void* x, void* out, int B, int n, int d, int k,
                                      int register_width, int static_k, int width, float min_dist,
                                      float cnst, void* stream) {
  using namespace runia;
  const bool fits = static_k ? (k == kStaticK && n <= register_width)
                             : (register_width == kChunk || n <= register_width);
  if (!valid_width(width) || k < 1 || k >= n || !fits) return static_cast<int>(cudaErrorInvalidValue);
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (register_width) {
    case 8: return dispatch_marginal_entropy<8>(static_k, in, o, B, n, d, k, width, min_dist, cnst, s);
    case 16: return dispatch_marginal_entropy<16>(static_k, in, o, B, n, d, k, width, min_dist, cnst, s);
    case 32: return dispatch_marginal_entropy<32>(static_k, in, o, B, n, d, k, width, min_dist, cnst, s);
    case 64: return dispatch_marginal_entropy<64>(static_k, in, o, B, n, d, k, width, min_dist, cnst, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* runia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
