// Kozachenko-Leonenko entropy of one scalar sample cloud, shared by
// marginal_entropy.cu and fused_mc_entropy.cu.
//
// One thread owns one cloud (one (image, dimension) column) and sorts it
// once: the clouds are scalar, so in the ascending column the k nearest
// neighbours of a point are a contiguous window around it, and its k-th
// neighbour distance is the least, over the windows of k + 1 neighbours that
// hold it, of the larger distance to the window's two ends. That is the
// sorted-window form of ops/entropy.py (_marginal_entropy_sorted): it selects
// the same f32 differences as a selection over all n^2 pairs, and duplicates
// keep a slot each without any tie logic (DropBlock's exact zeros).
//
// Up to 64 values are sorted in registers by a Batcher odd-even merge
// network with constant indices (kl_sort_networks.cuh, generated from
// ops/entropy_cuda.py::batcher_pairs), and with the estimator's usual k = 5
// compiled in the window pass runs on those registers too. A longer column
// is sorted 64 values at a time on its way into shared memory, and the
// sorted chunks are merged there by the network's later passes in run-time
// loops. The sorted column lies in dynamic shared memory with a stride of
// one word per thread of the block, so the threads of a warp read
// neighbouring words and no bank is hit twice; the window pass reads it back
// with k taken at run time. A block is at most kBlock threads wide; the caller picks the width that fits the
// block's shared memory (ops/entropy_cuda.py::entropy_plan, the one place
// the limits are decided) and passes it in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "kl_sort_networks.cuh"

namespace runia {

constexpr int kBlock = 128;   // widest block, one column per thread
constexpr float kBig = 1e30f;  // padding that sorts last; never inf (inf - inf is NaN)
constexpr int kChunk = 64;     // the most values sorted in registers at a time
constexpr int kStaticK = 5;    // the estimator's usual k (min(5, n - 1)): also compiled in as a constant

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

// Sorts v ascending, in registers: every index is a constant.
template <int W>
__device__ __forceinline__ void sort_registers(float (&v)[W]);

#define RUNIA_CX(i, j)                     \
  {                                        \
    const float lo = fminf(v[i], v[j]);    \
    v[j] = fmaxf(v[i], v[j]);              \
    v[i] = lo;                             \
  }
template <>
__device__ __forceinline__ void sort_registers<8>(float (&v)[8]) { RUNIA_SORT_NETWORK_8(RUNIA_CX) }
template <>
__device__ __forceinline__ void sort_registers<16>(float (&v)[16]) { RUNIA_SORT_NETWORK_16(RUNIA_CX) }
template <>
__device__ __forceinline__ void sort_registers<32>(float (&v)[32]) { RUNIA_SORT_NETWORK_32(RUNIA_CX) }
template <>
__device__ __forceinline__ void sort_registers<64>(float (&v)[64]) { RUNIA_SORT_NETWORK_64(RUNIA_CX) }
#undef RUNIA_CX

// The log sum of kl_log_sum() below for a column of n <= W values that lies
// sorted in registers, padded with kBig from n on, with K < n a constant:
// every index is a constant, so nothing is loaded and no loop remains. The
// padding is the missing upper end of the windows that pass the column's
// end, and windows that would start before it are left out.
template <int W, int K>
__device__ __forceinline__ float kl_log_sum_registers(const float (&v)[W], int n, float min_dist) {
  float acc = 0.f, carry = 0.f;  // carry: the low-order part acc has lost
#pragma unroll
  for (int i = 0; i < W; ++i) {
    float kth = kBig;
#pragma unroll
    for (int start = i - K; start <= i; ++start)
      if (start >= 0 && start + K < W) kth = fminf(kth, fmaxf(v[i] - v[start], v[start + K] - v[i]));
    if (i < n) {
      const float term = logf(2.f * fmaxf(kth, min_dist)) - carry;
      const float next = acc + term;
      carry = (next - acc) - term;
      acc = next;
    }
  }
  return acc;
}

// Sorts v (padded with kBig from `valid` on) and writes its first `valid`
// values to col[0], col[stride], ...
template <int W>
__device__ __forceinline__ void sort_into_column(float (&v)[W], int valid, float* col, int stride) {
  sort_registers<W>(v);
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < valid) col[i * stride] = v[i];
}

// col[0], col[stride], ... holds n values in ascending runs of `run` (a power
// of two; the last run may be shorter). Merges them into one ascending
// column: the passes p = run, 2 run, ... of Batcher's merge exchange, the
// loops of ops/entropy_cuda.py::batcher_pairs(n, first_p=run). Nothing
// happens for n <= run.
__device__ __forceinline__ void merge_sorted_chunks(float* col, int n, int stride, int run) {
  for (int p = run; p < n; p <<= 1) {
    const int group_shift = 32 - __clz(p);  // log2(2 p)
    for (int k = p; k >= 1; k >>= 1) {
      const int span = k * stride;
      for (int j = (k == p) ? 0 : k; j + k < n; j += 2 * k) {
        // Wires j .. j + k - 1 lie in one group of 2 p, and so do their
        // partners: one test serves the whole run.
        if ((j >> group_shift) != ((j + k) >> group_shift)) continue;
        float* lo = col + j * stride;
        for (int i = min(k, n - j - k); i > 0; --i, lo += stride) {
          const float va = lo[0], vb = lo[span];
          lo[0] = fminf(va, vb);
          lo[span] = fmaxf(va, vb);
        }
      }
    }
  }
}

// Sum over i of log(2 * max(eps_i, min_dist)), where eps_i is the distance
// from col[i * stride] to its k-th nearest neighbour among the n ascending
// values of the column, 1 <= k < n. Only the windows that lie inside the
// column are visited: one always does, and any other would lose the minimum
// with a distance of 1e30 to its missing end.
// The n logs are summed with Kahan compensation: a plain f32 running sum
// loses up to n * 2^-24 of the result (DropBlock's exact zeros make many
// equal terms, whose rounding does not cancel), which at n = 512 is more
// than the 1e-5 the kernel is held to; the compensated sum's error does not
// grow with n.
__device__ __forceinline__ float kl_log_sum(const float* col, int n, int stride, int k,
                                            float min_dist) {
  float acc = 0.f, carry = 0.f;  // carry: the low-order part acc has lost
  const int span = k * stride;
  for (int i = 0; i < n; ++i) {
    const float xi = col[i * stride];
    const int first = max(0, i - k), last = min(i, n - 1 - k);
    const float* lo = col + first * stride;  // the window's lower end; its upper is lo[span]
    float kth = kBig;
    for (int start = first; start <= last; ++start, lo += stride)
      kth = fminf(kth, fmaxf(xi - lo[0], lo[span] - xi));
    const float term = logf(2.f * fmaxf(kth, min_dist)) - carry;
    const float next = acc + term;
    carry = (next - acc) - term;
    acc = next;
  }
  return acc;
}

}  // namespace runia
