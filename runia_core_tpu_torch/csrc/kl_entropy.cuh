// Kozachenko-Leonenko entropy of one scalar sample cloud, shared by
// marginal_entropy.cu and fused_mc_entropy.cu.
//
// One thread owns one cloud (one (image, dimension) column). The cloud sits
// in shared memory with a stride of kBlock floats, so the threads of a warp
// read neighbouring words and no bank is hit twice.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace runia {

constexpr int kBlock = 128;  // threads per block, one column each
constexpr int kMaxK = 15;    // largest k the kernels are instantiated for

// Sum over i of log(2 * max(eps_i, min_dist)), where eps_i is the distance
// from col[i] to its K-th nearest neighbour among col[0..n-1].
//
// For every i the K+1 smallest |x_i - x_j| (j = i included, which gives the
// self-distance 0) are kept sorted in registers by a fixed insertion
// network. Duplicates each keep their own slot, so best[K] is the (K+1)-th
// order statistic of the multiset: the value the TPU kernel reaches by
// masking one occurrence of the minimum per pass. A kernel that dropped all
// copies of a minimum at once would be wrong on DropBlock's exact zeros.
template <int K>
__device__ __forceinline__ float kl_log_sum(const float* col, int n, float min_dist) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const float xi = col[i * kBlock];
    float best[K + 1];
#pragma unroll
    for (int t = 0; t <= K; ++t) best[t] = INFINITY;
    for (int j = 0; j < n; ++j) {
      float v = fabsf(xi - col[j * kBlock]);
#pragma unroll
      for (int t = 0; t <= K; ++t) {
        const float lo = fminf(best[t], v);
        v = fmaxf(best[t], v);
        best[t] = lo;
      }
    }
    acc += logf(2.f * fmaxf(best[K], min_dist));
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
