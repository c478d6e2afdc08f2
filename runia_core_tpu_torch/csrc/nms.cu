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
// Serial floor: the greedy recurrence decides a 64-box column block only
// once every earlier block is decided, so any design pays, per column
// block, one hand-off between threads (a barrier, or a counter in shared
// memory) and one shared-memory round trip (the decision publishing what
// it removed): ceil(N / 64) x (hand-off + shared round), about 60 cycles a
// block, 4 us at N = 8,400 and 14 us at 30,000 at 1.98 GHz.
//
// Design:
// * pass 1 (nms_mask_kernel): a block of 256 threads takes 64 rows x 256
//   columns (four 64-box column blocks) of the upper triangle, one thread a
//   (row, column block); it writes the u64 word whose bit t says "IoU(i,
//   j) > thr" for box j = 64 c + t of the later column block c. In the
//   row's own column block it writes instead the row's column word: bit t
//   says "IoU(j, i) > thr" for the earlier box j of the block (the IoU is
//   symmetric bit for bit: min, max, the product and the areas' sum
//   commute). The mask is N x ceil(N / 64) words (113 MB at N = 30,000),
//   scratch the wrapper allocates; words below the diagonal are never
//   written or read, and blocks wholly below it return at once. The IEEE
//   division is taken, after the loop, only for a pair whose quotient lies
//   within 2^-18 of thr or that has a box that is not tame (tame: well
//   formed, its area in [2^-120, 2^120]); the loop decides every other pair
//   by a 2-ulp quotient, with the same answer and without a branch.
// * pass 2 (nms_scan_kernel): one block walks the column blocks in score
//   order, with a `removed` bit vector (a word a column block) in shared
//   memory, and two roles that meet through counters in shared memory
//   (release and acquire fences), not barriers: a bar.sync orders memory
//   like membar.cta and so waits for every warp's outstanding loads, which
//   made each column block cost an L2 round trip of the slowest warp
//   (~1,000-2,000 cycles a block, clock64 probes on the H100).
//   - warp 0 decides column block b. Its words of a block (the column
//     words and the next four words of its 64 rows) are staged into shared
//     memory by cp.async two blocks ahead, so no load is on its path. The
//     decision is the recurrence's fixed point over the block's
//     candidates, found in parallel: kept = candidates; repeat kept' = {t
//     candidate : column word of t & kept = 0} (two ballots) until kept' =
//     kept. A box whose chain of earlier candidates suppressing it is r
//     long is settled after r rounds, so at most 65 rounds; the candidates
//     left after the earlier blocks rarely suppress each other, and
//     1.01-1.13 rounds a block is the mean at 8,400 random or class-offset
//     boxes, where walking the kept boxes one at a time (find the lowest,
//     shuffle its row in) took 20-63 dependent steps of ~150 cycles a
//     block. The kept boxes' next four words are OR-reduced across the
//     warp into register carries, which the next four decisions read
//     beside `removed`; their list goes to a ring of eight in shared memory
//     and the count of decided blocks is published.
//   - the OR warps, those on the three schedulers warp 0 does not use
//     (warp % 4 != 0; the rest only wait at the last barrier), form four
//     groups that take the decided blocks in turn: group g ORs block bp's
//     kept rows into removed[bp + 5 ...] for bp = g, g + 4, ..., and has
//     five decisions' time for its loads. A warp takes 32
//     consecutive words, one a lane, so that a kept row's words are one
//     coalesced 256-byte load, and every slices-th kept row (several warps
//     a word when the words are few); a lane ORs in registers, with no
//     exchange between lanes (a design that reduced each word across a
//     warp with __reduce_or_sync spent ~250 cycles a word on it). Words
//     meet in shared-memory atomicOr on 32-bit halves; integer OR is exact
//     and order-free, so the result does not depend on scheduling.
//   Warp 0 decides block b once block b - 5 is ORed in: blocks up to b - 5
//   are in `removed`, blocks b - 4 ... b - 1 in the carries. The keep
//   flags are written at the end, from the kept bits.
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

using u64 = unsigned long long;

constexpr int kNmsBlock = 64;      // boxes a word covers
constexpr int kMaskCols = 4;       // column blocks a pass-1 block covers, one thread a (row, column block)
constexpr int kOrBatch = 16;       // row words a scan lane keeps in flight
constexpr int kOrGroups = 4;       // groups of OR warps, taking the column blocks in turn
constexpr int kCarry = 4;          // words after its own that a block's kept rows reach through warp 0
constexpr int kRing = 8;           // column blocks whose kept lists are kept (> kCarry + 1)
constexpr int kScanMaxThreads = 1024;
constexpr int kStages = 3;         // warp 0's staged blocks: block b is staged at block b - kStages + 1

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The intersection and union of two boxes, each step rounded on its own.
__device__ __forceinline__ void overlap(const float4 a, float area_a, const float4 b, float area_b, float& inter,
                                        float& uni) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  inter = __fmul_rn(w, h);
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

// IoU(a, b) > thr as the plain version decides it: fl(inter / union) > thr,
// fl the IEEE division.
__device__ __forceinline__ bool iou_above(const float4 a, float area_a, const float4 b, float area_b, float thr) {
  float inter, uni;
  overlap(a, area_a, b, area_b, inter, uni);
  return __fdiv_rn(inter, uni) > thr;
}

// A box whose pairs the 2-ulp quotient may decide: x2 >= x1, y2 >= y1 and
// its area in [2^-120, 2^120] (so no NaN or infinity). For two such boxes
// the intersection is at most the smaller area and the union at least the
// larger, so the union lies in [2^-120, 2^121], where __fdividef is within
// 2 ulp.
__device__ __forceinline__ bool tame(const float4 b, float area) {
  return b.z >= b.x && b.w >= b.y && area >= 0x1p-120f && area <= 0x1p120f;
}

__global__ void __launch_bounds__(kNmsBlock * kMaskCols)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int n, int col_blocks, float thr) {
  const int row_block = blockIdx.y;
  const int first_col = blockIdx.x * kMaskCols;
  if (first_col + kMaskCols - 1 < row_block) return;  // wholly below the diagonal
  __shared__ float4 cols[kMaskCols * kNmsBlock];
  __shared__ float col_area[kMaskCols * kNmsBlock];
  __shared__ bool col_tame[kMaskCols * kNmsBlock];
  const int col_start = first_col * kNmsBlock;
  const int col_count = min(n - col_start, kMaskCols * kNmsBlock);
  const int tid = threadIdx.x;
  if (tid < col_count) {
    const float4 b = boxes[col_start + tid];
    const float area = box_area(b);
    cols[tid] = b;
    col_area[tid] = area;
    col_tame[tid] = tame(b, area);
  }
  __syncthreads();
  const int j = tid / kNmsBlock;  // the column block within the group; lanes of a warp share it
  const int row = row_block * kNmsBlock + tid % kNmsBlock;
  const int col_block = first_col + j;
  if (row >= n || col_block >= col_blocks || col_block < row_block) return;
  // A quotient within 2 ulp decides every pair it puts outside [lo, hi] =
  // thr -/+ (|thr| 2^-18 + 2^-100): there the exact quotient, and its
  // rounding, lie on the same side of thr. The rest (and any pair with a
  // box that is not tame) go to the IEEE division after the loop.
  const float margin = fmaf(fabsf(thr), 0x1p-18f, 0x1p-100f);
  const float lo = thr - margin, hi = thr + margin;
  const float4 a = boxes[row];
  const float area_a = box_area(a);
  const bool row_tame = tame(a, area_a) && isfinite(thr);  // a threshold of +-inf or NaN: every pair exact
  const int base = j * kNmsBlock;
  // The diagonal: the earlier boxes of the row's block (its column word);
  // else every box of the column block (its row word).
  const int count = col_block == row_block ? row - row_block * kNmsBlock : min(col_count - base, kNmsBlock);
  // One pair: bit t of `bits` where the quotient decides "above", of
  // `unsure` where it cannot. With t known at compile time (a full column
  // block, unrolled) each bit is one predicated OR of a constant.
  u64 bits = 0, unsure = 0;
  const auto pair = [&](int t) {
    float inter, uni;
    overlap(a, area_a, cols[base + t], col_area[base + t], inter, uni);
    const float q = __fdividef(inter, uni);
    const bool sure = row_tame && col_tame[base + t];
    if (sure && q > hi) bits |= 1ull << t;
    if (!sure || (q >= lo && q <= hi)) unsure |= 1ull << t;
  };
  if (count == kNmsBlock) {
#pragma unroll
    for (int t = 0; t < kNmsBlock; ++t) pair(t);
  } else {
    for (int t = 0; t < count; ++t) pair(t);
  }
  for (; unsure; unsure &= unsure - 1) {
    const int t = __ffsll(static_cast<long long>(unsure)) - 1;
    if (iou_above(a, area_a, cols[base + t], col_area[base + t], thr)) bits |= 1ull << t;
  }
  mask[static_cast<size_t>(row) * col_blocks + col_block] = bits;
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

__device__ __forceinline__ void atomic_or(u64* word, u64 v) {
  unsigned* half = reinterpret_cast<unsigned*>(word);
  if (static_cast<unsigned>(v)) atomicOr(half, static_cast<unsigned>(v));
  if (v >> 32) atomicOr(half + 1, static_cast<unsigned>(v >> 32));
}

// 8 bytes from global `src` to shared `dst` without the registers: zeros
// where !valid (no byte read).
__device__ __forceinline__ void cp_async8(u64* dst, const u64* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(to), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// Warp 0's words of column block `blk` into stage `st`: each box's column
// word (its word blk) and its words blk + 1 ... blk + kCarry. One cp.async
// group, committed even when empty, so that the groups count blocks.
__device__ __forceinline__ void stage_block(u64 (*st)[kNmsBlock], const u64* mask, int blk, int lane, int n,
                                            int col_blocks) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    const int row = blk * kNmsBlock + t;
#pragma unroll
    for (int k = 0; k <= kCarry; ++k) {
      const bool in = row < n && blk + k < col_blocks;
      cp_async8(&st[k][t], in ? mask + static_cast<size_t>(row) * col_blocks + blk + k : mask, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ int load_volatile(const int* p) { return *reinterpret_cast<const volatile int*>(p); }

// Spins until *p >= want; traps (a launch error) instead of hanging should
// the scan's invariants ever break.
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  for (unsigned spins = 0; load_volatile(p) < want; ++spins) {
    if (spins > (1u << 30)) __trap();
  }
  __threadfence_block();  // acquire: what was written before the count is seen
}

// The scan's dynamic shared memory: removed and kept, a u64 each a column
// block.
__global__ void __launch_bounds__(kScanMaxThreads)
nms_scan_kernel(const u64* __restrict__ mask, bool* __restrict__ keep, int n, int col_blocks) {
  extern __shared__ u64 removed[];
  u64* kept_all = removed + col_blocks;
  __shared__ u64 ahead[kStages][kCarry + 1][kNmsBlock];  // warp 0's staged blocks: column words, next words
  __shared__ int kept_count[kRing];
  __shared__ unsigned char kept_idx[kRing][kNmsBlock];  // kept boxes of a column block, in order
  __shared__ int or_done[kRing];  // OR warps done with a column block
  __shared__ int decided;         // column blocks decided
  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) removed[w] = 0;
  if (threadIdx.x < kRing) or_done[threadIdx.x] = 0;
  if (threadIdx.x == 0) decided = 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    for (int blk = 0; blk < kStages - 1; ++blk) stage_block(ahead[blk], mask, blk, lane, n, col_blocks);
  }
  __syncthreads();
  // The OR warps, those off warp 0's scheduler (warp % 4 != 0), in `groups`
  // groups; group g takes column blocks g, g + groups, ...
  const int or_warps = (blockDim.x >> 5) - ((blockDim.x >> 5) + 3) / 4;
  const int groups = min(kOrGroups, or_warps);
  if (warp == 0) {
    // carry[i]: what the kept boxes of blocks b - kCarry ... b - 1 remove
    // from block b + i (the rest of `removed`, blocks up to b - kCarry - 1,
    // comes from the OR warps).
    u64 carry[kCarry];
#pragma unroll
    for (int i = 0; i < kCarry; ++i) carry[i] = 0;
    for (int b = 0; b < col_blocks; ++b) {
      if (b > kCarry) {  // block b - kCarry - 1 ORed into removed by its group
        const int done = b - kCarry - 1;
        wait_at_least(&or_done[done % kRing], (or_warps - done % groups + groups - 1) / groups);
        __syncwarp();
        if (lane == 0) or_done[done % kRing] = 0;  // for block done + kRing, counted once it is decided
      }
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");  // block b's stage has landed
      __syncwarp();
      const u64(*st)[kNmsBlock] = ahead[b % kStages];
      const u64 c0 = st[0][lane], c1 = st[0][lane + 32];
      const int count = min(n - b * kNmsBlock, kNmsBlock);
      const u64 valid = count == kNmsBlock ? ~0ull : (1ull << count) - 1;
      const u64 cand = valid & ~(removed[b] | carry[0]);
      const bool can0 = (cand >> lane) & 1ull, can1 = (cand >> (lane + 32)) & 1ull;
      u64 kept = cand;
      bool k0 = can0, k1 = can1;
      for (;;) {  // the fixed point; a chain of r suppressions settles in r rounds
        k0 = can0 && !(c0 & kept);
        k1 = can1 && !(c1 & kept);
        const u64 again = __ballot_sync(0xffffffffu, k0) | (static_cast<u64>(__ballot_sync(0xffffffffu, k1)) << 32);
        if (again == kept) break;
        kept = again;
      }
      const int slot = b % kRing;  // block b - kRing was ORed in (waited for at an earlier block)
      if (k0) kept_idx[slot][__popcll(kept & ((1ull << lane) - 1))] = static_cast<unsigned char>(lane);
      if (k1) kept_idx[slot][__popcll(kept & ((1ull << (lane + 32)) - 1))] = static_cast<unsigned char>(lane + 32);
      if (lane == 0) kept_count[slot] = __popcll(kept), kept_all[b] = kept;
      __syncwarp();
      __threadfence_block();  // release: the list before the count
      if (lane == 0) *reinterpret_cast<volatile int*>(&decided) = b + 1;
#pragma unroll
      for (int i = 0; i < kCarry; ++i) {
        const u64 reach = warp_or((k0 ? st[i + 1][lane] : 0ull) | (k1 ? st[i + 1][lane + 32] : 0ull));
        carry[i] = (i + 1 < kCarry ? carry[i + 1] : 0ull) | reach;
      }
      __syncwarp();
      stage_block(ahead[(b + kStages - 1) % kStages], mask, b + kStages - 1, lane, n, col_blocks);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (warp % 4) {
    // Block bp's kept rows into words bp + kCarry + 1 ... (warp 0's carries
    // take the words before): the group's warps take 32 consecutive words
    // each, a lane one word, and a slice of the kept rows (every
    // slices-th).
    const int or_warp = warp - warp / 4 - 1;
    const int group = or_warp % groups, member = or_warp / groups;
    const int members = (or_warps - group + groups - 1) / groups;
    for (int bp = group; bp < col_blocks; bp += groups) {
      wait_at_least(&decided, bp + 1);
      const int nk = kept_count[bp % kRing];
      const int first = bp + kCarry + 1;
      const int chunks = (col_blocks - first + 31) / 32;  // of 32 words
      if (nk > 0 && chunks > 0) {
        const int slices = max(1, min(nk, members / chunks));  // warps a chunk
        const u64* rows = mask + static_cast<size_t>(bp) * kNmsBlock * col_blocks;
        const unsigned char* idx = kept_idx[bp % kRing];
        for (int task = member; task < chunks * slices; task += members) {
          const int w = first + (task % chunks) * 32 + lane;
          if (w >= col_blocks) continue;
          u64 acc = 0;
          for (int j0 = task / chunks; j0 < nk; j0 += kOrBatch * slices) {
            u64 now[kOrBatch];
#pragma unroll
            for (int u = 0; u < kOrBatch; ++u) {
              const int j = j0 + u * slices;
              now[u] = j < nk ? __ldcg(rows + static_cast<size_t>(idx[j]) * col_blocks + w) : 0ull;
            }
#pragma unroll
            for (int u = 0; u < kOrBatch; ++u) acc |= now[u];
          }
          atomic_or(removed + w, acc);
        }
      }
      __syncwarp();
      __threadfence_block();  // release: the ORs before the count
      if (lane == 0) atomicAdd(&or_done[bp % kRing], 1);
    }
  }
  __syncthreads();
  // The keep flags, from the kept bits, in one pass at the end.
  for (int i = threadIdx.x; i < n; i += blockDim.x) keep[i] = (kept_all[i / kNmsBlock] >> (i % kNmsBlock)) & 1ull;
}

}  // namespace runia

// boxes: (n, 4) f32 sorted by descending score, 16-byte aligned; mask:
// n * ceil(n / 64) u64 scratch; keep: (n,) bool. scan_threads: the scan
// block's width, a multiple of 32 (warp 0 decides, warps 1-3, 5-7, ... OR
// rows in); scan_smem: its dynamic shared memory, 16 bytes a column block.
// Both from ops/nms.py::_scan_plan.
extern "C" int runia_nms(const void* boxes, void* mask, void* keep, int n, float thr, int scan_threads,
                         int scan_smem, void* stream) {
  using namespace runia;
  const int col_blocks = (n + kNmsBlock - 1) / kNmsBlock;
  if (n <= 0 || scan_threads < (col_blocks > 1 ? 64 : 32) || scan_threads % 32 || scan_threads > kScanMaxThreads ||
      scan_smem != 2 * col_blocks * static_cast<int>(sizeof(u64)) || scan_smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((col_blocks + kMaskCols - 1) / kMaskCols, col_blocks);
  nms_mask_kernel<<<grid, kNmsBlock * kMaskCols, 0, s>>>(static_cast<const float4*>(boxes), static_cast<u64*>(mask),
                                                         n, col_blocks, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<1, scan_threads, scan_smem, s>>>(static_cast<const u64*>(mask), static_cast<bool*>(keep), n,
                                                      col_blocks);
  return static_cast<int>(cudaGetLastError());
}
