// Greedy non-maximum suppression: score-sorted xyxy boxes (N, 4) f32 ->
// keep (N,) bool, keep[i] = no kept earlier box has IoU > thr with box i.
//
// Replaces: runia_core_tpu/ops/nms.py::nms_mask, which is no Pallas kernel
// but one XLA program: the (N, N) suppression matrix, iterated inside a
// lax.while_loop to the recurrence's fixed point. In PyTorch that loop
// needs a host read each round to test convergence, which stalls the
// stream and cannot be captured in a CUDA graph; this kernel pair runs on
// the current stream with no host sync.
//
// Bound on the H100: the IoUs. Each pair needs about 13 f32 operations
// (two max and two min for the intersection's corners, two subtractions,
// two clamps, a product, the union's add and subtract, a divide, the
// compare); the data needs the IoUs of each kept box with the boxes after
// it, at most N^2 / 2 pairs (5.9 G operations, 0.087 ms at 67 TFLOP/s, for
// N = 30,000). The inputs and the output are 17 bytes a box.
//
// Design, torchvision's CUDA NMS with the greedy scan moved onto the card:
// * pass 1 (nms_mask_kernel): a block of 64 threads takes 64 rows x 64
//   columns of the upper triangle; each thread writes, for its row i, one
//   u64 word whose bit t says "IoU(i, j) > thr" for the later box j of the
//   column block. Blocks below the diagonal return at once: only later
//   boxes are ever suppressed by a row. The mask is N x ceil(N / 64) words
//   (113 MB at N = 30,000), scratch the wrapper allocates.
// * pass 2 (nms_scan_kernel): one block walks the 64-box column blocks in
//   score order. A `removed` bit vector lives in shared memory. For a
//   block, warp 0 decides its 64 boxes in order from `removed` and the
//   diagonal words (each lane holds two rows' words; the 64 steps pass them
//   around by shuffle), then every thread ORs the rows of the boxes just
//   kept into the later words of `removed`. Two barriers a block of 64.
//
// The IoU is computed with the plain version's operation order, each step
// rounded on its own (__fmul_rn and friends: nvcc would otherwise contract
// a * b + c into an FMA), so the kernel and the plain version decide every
// pair alike, bit for bit:
//   area = (x2 - x1) * (y2 - y1); inter = max(w, 0) * max(h, 0);
//   iou = inter / ((area_a + area_b) - inter).
// A zero-area pair gives 0 / 0 = NaN, which suppresses nothing (NaN > thr
// is false), as in JAX.
#include <cstdint>

#include <cuda_runtime.h>

namespace runia {

constexpr int kNmsBlock = 64;  // boxes a word covers; threads of a pass-1 block

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool iou_above(const float4 a, float area_a, const float4 b, float area_b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
  return iou > thr;
}

__global__ void __launch_bounds__(kNmsBlock)
nms_mask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask, int n, int col_blocks,
                float thr) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;
  __shared__ float4 cols[kNmsBlock];
  __shared__ float col_area[kNmsBlock];
  const int col_start = col_block * kNmsBlock;
  const int col_count = min(n - col_start, kNmsBlock);
  if (threadIdx.x < col_count) {
    const float4 b = boxes[col_start + threadIdx.x];
    cols[threadIdx.x] = b;
    col_area[threadIdx.x] = box_area(b);
  }
  __syncthreads();
  const int row = row_block * kNmsBlock + threadIdx.x;
  if (row >= n) return;
  const float4 a = boxes[row];
  const float area_a = box_area(a);
  unsigned long long bits = 0;
  const int first = col_block == row_block ? threadIdx.x + 1 : 0;  // only later boxes
  for (int t = first; t < col_count; ++t) {
    if (iou_above(a, area_a, cols[t], col_area[t], thr)) bits |= 1ull << t;
  }
  mask[static_cast<size_t>(row) * col_blocks + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask, bool* __restrict__ keep, int n,
                                int col_blocks) {
  extern __shared__ unsigned long long removed[];  // col_blocks words
  __shared__ unsigned long long kept_bits;
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) removed[w] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int block = 0; block < col_blocks; ++block) {
    const int base = block * kNmsBlock;
    if (threadIdx.x < 32) {
      // Lane l holds the diagonal words of rows base + l and base + 32 + l.
      const int r0 = base + lane, r1 = base + 32 + lane;
      const unsigned long long d0 = r0 < n ? mask[static_cast<size_t>(r0) * col_blocks + block] : 0;
      const unsigned long long d1 = r1 < n ? mask[static_cast<size_t>(r1) * col_blocks + block] : 0;
      unsigned long long word = removed[block];
      unsigned long long kept = 0;
      for (int t = 0; t < kNmsBlock; ++t) {
        const unsigned long long row = __shfl_sync(0xffffffffu, t < 32 ? d0 : d1, t & 31);
        if (base + t < n && !((word >> t) & 1ull)) {
          kept |= 1ull << t;
          word |= row;
        }
      }
      if (r0 < n) keep[r0] = (kept >> lane) & 1ull;
      if (r1 < n) keep[r1] = (kept >> (lane + 32)) & 1ull;
      if (lane == 0) kept_bits = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (kept != 0) {
      for (int w = block + 1 + threadIdx.x; w < col_blocks; w += blockDim.x) {
        unsigned long long acc = removed[w];
        for (unsigned long long bits = kept; bits; bits &= bits - 1) {
          const int t = __ffsll(static_cast<long long>(bits)) - 1;
          acc |= mask[static_cast<size_t>(base + t) * col_blocks + w];
        }
        removed[w] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace runia

// boxes: (n, 4) f32 sorted by descending score, 16-byte aligned; mask:
// n * ceil(n / 64) u64 scratch; keep: (n,) bool. scan_threads: the scan
// block's width, a multiple of 32.
extern "C" int runia_nms(const void* boxes, void* mask, void* keep, int n, float thr, int scan_threads,
                         void* stream) {
  using namespace runia;
  if (n <= 0 || scan_threads < 32 || scan_threads % 32 || scan_threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int col_blocks = (n + kNmsBlock - 1) / kNmsBlock;
  const size_t scan_smem = static_cast<size_t>(col_blocks) * sizeof(unsigned long long);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scan_smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(scan_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(col_blocks, col_blocks);
  nms_mask_kernel<<<grid, kNmsBlock, 0, s>>>(static_cast<const float4*>(boxes),
                                             static_cast<unsigned long long*>(mask), n, col_blocks, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<1, scan_threads, scan_smem, s>>>(static_cast<const unsigned long long*>(mask),
                                                      static_cast<bool*>(keep), n, col_blocks);
  return static_cast<int>(cudaGetLastError());
}
