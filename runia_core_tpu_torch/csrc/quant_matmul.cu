// Weight-only int8 matrix product (W8A16):
// x (rows, K) bf16/f32, wq (K, N) int8, scale (N,) f32 -> (rows, N) x's type,
// out = round_to_T((x @ wq) accumulated in f32 * scale).
//
// Replaces: runia_core_tpu/ops/quant_matmul.py::quant_matmul (kernel body
// _kernel), the TPU kernel that keeps a (rows, K) x block resident in VMEM,
// streams (K, block_n) int8 weight tiles, converts them to x's type and
// feeds the MXU with an f32 accumulator, then multiplies by the scale once.
//
// Bound on the H100: at decode (rows = batch = 16) the int8 weight stream,
// K * N bytes per call, about 1.1 GB per step over the 1.17 B model's
// projections: 0.33 ms at 3.35 TB/s. The products are 16 FMAs per weight
// byte, about 0.6 ms per step at the card's 67 TFLOP/s of f32 FMA, so a
// CUDA-core kernel sits between the two bounds; tensor cores (mma/wgmma on
// bf16 after an in-register dequant) are later work.
//
// Design: one block of 256 threads per (32-column, 16-row) output tile; a
// thread owns 4 adjacent columns (one 4-byte int8 load per weight row,
// coalesced along N) and 16 rows of f32 accumulators. The block's 8 warps
// and the 4 lane groups of each warp split K 32 ways, so even the o
// projection (N = 2048) has 64 blocks of 256 threads streaming its weights.
// K is walked in chunks of 256: a thread first issues the loads of all 8
// of its weight rows in the chunk (8 in flight, the stream's memory-level
// parallelism) and of its 16 values of the chunk's x, then stages x in
// shared memory, transposed to (k, row) so one thread's 16 row values of a
// k are four float4 loads (broadcast across the 8 threads of a slice). int8 -> f32 and bf16 -> f32
// are exact, so every product is taken in f32; the 32 partial sums are
// reduced with shuffles and shared memory (reusing the x buffer), the sum is
// multiplied by the scale and rounded once to x's type, as the TPU kernel
// does. Registers are capped so that two blocks share an SM (16 warps to
// hide the loads' latency). Ragged rows, K and N are masked inside the kernel; the TPU's
// k % 128 and VMEM budget (_pick_block_n) do not apply, and the wrapper's
// only limit is rows <= 1024 (rows past 16 are further 16-row tiles that
// read the weight tile again, mostly from L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runia {
namespace qmm {

constexpr int kThreads = 256;
constexpr int kRows = 16;       // output rows per block
constexpr int kColsPer = 4;     // adjacent columns per thread
constexpr int kColThreads = 8;  // threads along N in a warp
constexpr int kCols = kColThreads * kColsPer;  // 32 output columns per block
constexpr int kSlices = kThreads / kColThreads;  // 32 slices of K
constexpr int kChunk = 256;     // values of K staged at a time
constexpr int kPer = kChunk / kSlices;  // weight rows per thread per chunk
constexpr int kStage = kChunk * kRows / kThreads;  // x values each thread stages per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int rows, int K, int N) {
  // x of the chunk as (k, row); after the K loop, one partial sum per warp.
  __shared__ __align__(16) float xs[kChunk * kRows];
  static_assert((kThreads / 32) * kRows * kCols <= kChunk * kRows, "partials fit the x buffer");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_thread = lane & (kColThreads - 1);
  const int slice = warp * (32 / kColThreads) + lane / kColThreads;  // 0..31
  const int n0 = blockIdx.x * kCols + col_thread * kColsPer;
  const int r0 = blockIdx.y * kRows;
  const bool vec = (N % 4 == 0) && (n0 + kColsPer <= N) &&
                   (reinterpret_cast<uintptr_t>(wq) % 4 == 0);

  float acc[kRows][kColsPer];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    // This thread's weight rows k0 + slice + 32 j of the chunk, all loads
    // issued before any is used; rows past K read as zero.
    char4 wrows[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = k0 + slice + j * kSlices;
      const int8_t* wrow = wq + static_cast<size_t>(k) * N + n0;
      if (k >= K) {
        wrows[j] = make_char4(0, 0, 0, 0);
      } else if (vec) {
        wrows[j] = *reinterpret_cast<const char4*>(wrow);
      } else {
        wrows[j] = make_char4(n0 < N ? wrow[0] : 0, n0 + 1 < N ? wrow[1] : 0,
                              n0 + 2 < N ? wrow[2] : 0, n0 + 3 < N ? wrow[3] : 0);
      }
    }
    // The chunk's x, all loads issued before any store (a loop that stored
    // each value as it arrived would wait out one L2 round trip per value).
    // x is small and read by every block of the grid, so it comes from L2.
    // Neighbouring threads take neighbouring rows: the stores below then
    // fill neighbouring words.
    float xv[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = tid + u * kThreads;
      const int row = r0 + idx % kRows, k = k0 + idx / kRows;
      xv[u] = (row < rows && k < K) ? to_f32(x[static_cast<size_t>(row) * K + k]) : 0.f;
    }
    __syncthreads();  // the previous chunk's x is no longer read
#pragma unroll
    for (int u = 0; u < kStage; ++u) xs[tid + u * kThreads] = xv[u];  // (k, row) order
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float w[kColsPer] = {static_cast<float>(wrows[j].x), static_cast<float>(wrows[j].y),
                                 static_cast<float>(wrows[j].z), static_cast<float>(wrows[j].w)};
      const float4* xv = reinterpret_cast<const float4*>(xs + (slice + j * kSlices) * kRows);
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 x4 = xv[q];
#pragma unroll
        for (int c = 0; c < kColsPer; ++c) {
          acc[4 * q + 0][c] = fmaf(x4.x, w[c], acc[4 * q + 0][c]);
          acc[4 * q + 1][c] = fmaf(x4.y, w[c], acc[4 * q + 1][c]);
          acc[4 * q + 2][c] = fmaf(x4.z, w[c], acc[4 * q + 2][c]);
          acc[4 * q + 3][c] = fmaf(x4.w, w[c], acc[4 * q + 3][c]);
        }
      }
    }
  }

  // The 4 slices of a warp hold lanes col_thread, +8, +16, +24: fold them.
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      float v = acc[r][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][c] = v;
    }
  __syncthreads();  // every thread is done with x: the buffer takes the partials
  float* partial = xs;  // [warp][row][column]
  if (lane < kColThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kColsPer; ++c)
        partial[(warp * kRows + r) * kCols + col_thread * kColsPer + c] = acc[r][c];
  }
  __syncthreads();
  for (int idx = tid; idx < kRows * kCols; idx += kThreads) {
    const int r = idx / kCols, c = idx % kCols;
    const int row = r0 + r, col = blockIdx.x * kCols + c;
    if (row >= rows || col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += partial[(w * kRows + r) * kCols + c];
    out[static_cast<size_t>(row) * N + col] = from_f32<T>(sum * scale[col]);
  }
}

template <typename T>
int launch(const void* x, const void* wq, const void* scale, void* out, int rows, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols, (rows + kRows - 1) / kRows);
  quant_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qmm
}  // namespace runia

// dtype: 0 = float32, 1 = bfloat16 (x and out).
extern "C" int runia_quant_matmul(const void* x, const void* wq, const void* scale, void* out,
                                  int rows, int K, int N, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return runia::qmm::launch<float>(x, wq, scale, out, rows, K, N, s);
  if (dtype == 1) return runia::qmm::launch<__nv_bfloat16>(x, wq, scale, out, rows, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
