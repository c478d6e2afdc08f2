// Kozachenko-Leonenko entropy of one scalar sample cloud, shared by
// marginal_entropy.cu and fused_mc_entropy.cu.
//
// One thread owns one cloud (one (image, dimension) column). The cloud sits
// in dynamic shared memory with a stride of one word per thread of the block,
// so the threads of a warp read neighbouring words and no bank is hit twice.
// A block is at most kBlock threads wide; the caller picks the width that
// fits the block's shared memory (ops/entropy_cuda.py::block_width, the one
// place the limits are decided) and passes it in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace runia {

constexpr int kBlock = 128;  // widest block, one column per thread

// A block width the kernels take: a whole number of warps up to kBlock.
inline bool valid_width(int width) { return width >= 32 && width <= kBlock && width % 32 == 0; }

// Launch configuration for `smem` bytes of dynamic shared memory: above the
// default 48 KB a kernel has to opt in first, and CUDA refuses more than the
// device allows (227 KB on sm_90).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Sum over i of log(2 * max(eps_i, min_dist)), where eps_i is the distance
// from col[i * stride] to its K-th nearest neighbour among the n values.
// The n logs are summed with Kahan compensation: a plain f32 running sum
// loses up to n * 2^-24 of the result (DropBlock's exact zeros make many
// equal terms, whose rounding does not cancel), which at n = 512 is more
// than the 1e-5 the kernel is held to; the compensated sum's error does not
// grow with n.
//
// For every i the K+1 smallest |x_i - x_j| (j = i included, which gives the
// self-distance 0) are kept sorted in registers by a fixed insertion
// network. Duplicates each keep their own slot, so best[K] is the (K+1)-th
// order statistic of the multiset: the value the TPU kernel reaches by
// masking one occurrence of the minimum per pass. A kernel that dropped all
// copies of a minimum at once would be wrong on DropBlock's exact zeros.
template <int K>
__device__ __forceinline__ float kl_log_sum(const float* col, int n, int stride, float min_dist) {
  float acc = 0.f, carry = 0.f;  // carry: the low-order part acc has lost
  for (int i = 0; i < n; ++i) {
    const float xi = col[i * stride];
    float best[K + 1];
#pragma unroll
    for (int t = 0; t <= K; ++t) best[t] = INFINITY;
    for (int j = 0; j < n; ++j) {
      float v = fabsf(xi - col[j * stride]);
#pragma unroll
      for (int t = 0; t <= K; ++t) {
        const float lo = fminf(best[t], v);
        v = fmaxf(best[t], v);
        best[t] = lo;
      }
    }
    const float term = logf(2.f * fmaxf(best[K], min_dist)) - carry;
    const float next = acc + term;
    carry = (next - acc) - term;
    acc = next;
  }
  return acc;
}

}  // namespace runia

// Expands to one switch case per supported k, each calling FN<k>(ARGS).
#define RUNIA_DISPATCH_K(k, FN, ...)            \
  switch (k) {                                  \
    case 1: return FN<1>(__VA_ARGS__);          \
    case 2: return FN<2>(__VA_ARGS__);          \
    case 3: return FN<3>(__VA_ARGS__);          \
    case 4: return FN<4>(__VA_ARGS__);          \
    case 5: return FN<5>(__VA_ARGS__);          \
    case 6: return FN<6>(__VA_ARGS__);          \
    case 7: return FN<7>(__VA_ARGS__);          \
    case 8: return FN<8>(__VA_ARGS__);          \
    case 9: return FN<9>(__VA_ARGS__);          \
    case 10: return FN<10>(__VA_ARGS__);        \
    case 11: return FN<11>(__VA_ARGS__);        \
    case 12: return FN<12>(__VA_ARGS__);        \
    case 13: return FN<13>(__VA_ARGS__);        \
    case 14: return FN<14>(__VA_ARGS__);        \
    case 15: return FN<15>(__VA_ARGS__);        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
