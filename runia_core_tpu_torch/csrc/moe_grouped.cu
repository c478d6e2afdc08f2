// Routed sparse-MoE experts as one grouped kernel: for the (token, expert)
// pairs sorted by expert (tok[p]: the pair's token; offsets[e]: expert e's
// first pair), partial[s][p] = silu(x[tok[p]] W_gate[e][:, S_s]) *
// (x[tok[p]] W_up[e][:, S_s]) W_down[e][S_s, :] over slice S_s of the hidden
// width, in f32; the wrapper sums the slices in a fixed order.
//
// Replaces no TPU kernel: the JAX package's _moe_ffn is a dense einsum that
// XLA fuses, every expert over every token, and the port ran it as a loop of
// 3 E products over all tokens with the gates of the unpicked experts zero
// (E / k times the work). Here each expert runs over its own rows only.
//
// Bound on the H100: a decode step's 8 tokens x 8 experts touch about 41 of
// 64 experts, and those experts' 12.4 MB each (bf16, 2304 x 896 x 3) are the
// bytes to move: 0.15 ms a layer at 3.35 TB/s, against 0.0008 ms of
// operations. A 512-token prefill lane's 4,096 pairs still read all 64
// experts (0.24 ms) against 51 GFLOP (0.05 ms at 989 TFLOP/s): the expert
// layer is bound by its weights' bytes until each expert sees a few hundred
// rows.
//
// Design: one block per (tile of up to BM pairs of one expert, slice of the
// hidden width), a warp on each 16 pairs: BM = 64 (4 warps) where experts
// see few pairs (decode), 128 (8 warps: each weight tile serves twice the
// rows, and twice the warps hide its loads) where they see a hundred or
// more (prefill lanes); the wrapper picks BM from the pairs. The tile map is
// read on the device: a block walks the experts' tile counts (ceil(count /
// BM)) to find its expert and tile, and a block past the last tile returns,
// so the grid is a static bound (ceil(P / BM) + E tiles) and nothing comes
// back to the host; the launch is capturable. Phase 1 computes the tile's
// slice of the hidden product 64 columns at a time, gate and up side by
// side on the tensor cores (mma.sync m16n8k16 bf16 -> f32), over staged
// 64-deep tiles of the gathered rows and of both weights (16-byte cp.async
// into a ring of two stages for tiles of 64 pairs, three for tiles of 128:
// one or two jobs in flight while one is multiplied; rows of
// absent pairs filled with zeros); the SwiGLU runs in f32 on the
// accumulators and the product, rounded to bf16, stays in shared memory. Phase 2 multiplies it by the down projection's
// rows of the slice, 64 output columns at a time, and writes f32 partial
// rows. More slices give the card more blocks when few pairs fill few
// tiles (decode): the wrapper picks them. The block that owns an expert's
// first tile in slice 0 adds the expert's pairs and 1 to work[0..1] (the
// benchmark's count of pairs and touched experts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runia {
namespace moe {

constexpr int BT = 64;                // rows, depth and columns of a staged weight tile
constexpr int kPad = 8;               // bf16 padding per shared-memory row
constexpr int LD = BT + kPad;         // staged tile row stride

// Shared memory of a block of BM pairs whose slice is `slice` columns wide,
// with a ring of S stages.
template <int BM>
__host__ __device__ constexpr size_t stage_elems() { return static_cast<size_t>(BM + 2 * BT) * LD; }  // rows | gate | up
template <int BM, int S>
size_t smem_bytes(int slice) {
  return sizeof(__nv_bfloat16) * (S * stage_elems<BM>() + static_cast<size_t>(BM) * (slice + kPad));
}

struct Params {
  const __nv_bfloat16* x; const int* tok; const int* offsets;
  const __nv_bfloat16* wg; const __nv_bfloat16* wu; const __nv_bfloat16* wd;
  float* partial; unsigned long long* work;
  int P, d, I, E, slice;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = live ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most S - 2 groups are in flight: the oldest job has landed.
template <int S>
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments (16 x 16 at column k0) of this warp's rows of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* rows, int ld, int k0) {
  a[0] = *reinterpret_cast<const uint32_t*>(rows + k0);
  a[1] = *reinterpret_cast<const uint32_t*>(rows + 8 * ld + k0);
  a[2] = *reinterpret_cast<const uint32_t*>(rows + k0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(rows + 8 * ld + k0 + 8);
}

// acc[nt] (16 x 8 each, 64 columns) += A (this warp's 16 rows, 64 deep) *
// B (a staged [k][n] 64 x 64 tile).
__device__ __forceinline__ void mma_tile(float (&acc)[8][4], const __nv_bfloat16* a_rows, int lda, int a_k0,
                                         const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_rows, lda, a_k0 + kk * 16);
#pragma unroll
    for (int np = 0; np < BT / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// Stage a 64 x 64 bf16 tile whose row r starts at src + r * ld (all live).
template <int kThreads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, long long ld, int tid) {
#pragma unroll
  for (int u = 0; u < BT * BT / 8 / kThreads; ++u) {
    const int c = tid + u * kThreads;
    const int r = c / (BT / 8), col = (c % (BT / 8)) * 8;
    cp_async16(dst + r * LD + col, src + r * ld + col, true);
  }
}

// BM pairs a tile, a warp on each 16 of them; a ring of kStages stages.
template <int BM, int kStages>
__global__ void __launch_bounds__(BM * 2) moe_grouped_kernel(const Params p) {
  constexpr int kThreads = BM * 2;
  constexpr size_t kStage = stage_elems<BM>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][rows | gate | up]
  __nv_bfloat16* hs = ring + kStages * kStage;                        // [BM][slice + kPad]
  __shared__ int tok_s[BM];
  const int ldh = p.slice + kPad;

  // This block's expert and tile, from the experts' tile counts.
  int e = 0, tile = blockIdx.x, count = 0;
  for (; e < p.E; ++e) {
    count = p.offsets[e + 1] - p.offsets[e];
    const int tiles = (count + BM - 1) / BM;
    if (tile < tiles) break;
    tile -= tiles;
  }
  if (e == p.E) return;  // past the last tile: the grid is a static bound
  const int row0 = p.offsets[e] + tile * BM;
  const int rows = min(BM, p.offsets[e + 1] - row0);
  const int s = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0 && tile == 0 && s == 0) {
    atomicAdd(p.work, static_cast<unsigned long long>(count));
    atomicAdd(p.work + 1, 1ull);
  }
  if (tid < BM) tok_s[tid] = tid < rows ? p.tok[row0 + tid] : -1;
  __syncthreads();

  const long long dI = static_cast<long long>(p.d) * p.I;
  const __nv_bfloat16* wg = p.wg + e * dI + static_cast<long long>(s) * p.slice;
  const __nv_bfloat16* wu = p.wu + e * dI + static_cast<long long>(s) * p.slice;
  const __nv_bfloat16* wd = p.wd + e * dI + static_cast<long long>(s) * p.slice * p.d;
  const int ksteps = p.d / BT;  // phase 1: depth tiles a 64-column chunk of the slice
  const int chunks = p.slice / BT;

  // Phase 1: job j = (chunk j / ksteps, depth tile j % ksteps).
  const int jobs1 = chunks * ksteps;
  auto load1 = [&](int j) {
    if (j < jobs1) {
      const int c = j / ksteps, k0 = (j % ksteps) * BT;
      __nv_bfloat16* dst = ring + (j % kStages) * kStage;
#pragma unroll
      for (int u = 0; u < BM * BT / 8 / kThreads; ++u) {
        const int q = tid + u * kThreads;
        const int r = q / (BT / 8), col = (q % (BT / 8)) * 8;
        const int t = tok_s[r];
        cp_async16(dst + r * LD + col, t >= 0 ? p.x + static_cast<long long>(t) * p.d + k0 + col : p.x, t >= 0);
      }
      stage_tile<kThreads>(dst + BM * LD, wg + static_cast<long long>(k0) * p.I + c * BT, p.I, tid);
      stage_tile<kThreads>(dst + (BM + BT) * LD, wu + static_cast<long long>(k0) * p.I + c * BT, p.I, tid);
    }
    cp_async_commit();  // a group every job, empty past the last, so the waits count alike
  };
  float acc_g[8][4], acc_u[8][4];
  zero(acc_g);
  zero(acc_u);
  for (int j = 0; j < kStages - 1; ++j) load1(j);
  for (int j = 0; j < jobs1; ++j) {
    cp_async_wait_oldest<kStages>();
    __syncthreads();  // job j has landed; every warp is done with job j - 1's stage
    load1(j + kStages - 1);
    const __nv_bfloat16* st = ring + (j % kStages) * kStage;
    const __nv_bfloat16* a_rows = st + (warp * 16 + gid) * LD + 2 * tig;
    mma_tile(acc_g, a_rows, LD, 0, st + BM * LD, lane);
    mma_tile(acc_u, a_rows, LD, 0, st + (BM + BT) * LD, lane);
    if (j % ksteps == ksteps - 1) {  // the chunk's SwiGLU into the hidden rows
      const int c = j / ksteps;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float g = acc_g[nt][q];
          h[q] = g / (1.f + __expf(-g)) * acc_u[nt][q];
        }
        __nv_bfloat16* dst = hs + (warp * 16 + gid) * ldh + c * BT + nt * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(h[0], h[1]);
        *reinterpret_cast<uint32_t*>(dst + 8 * ldh) = pack_bf16(h[2], h[3]);
      }
      zero(acc_g);
      zero(acc_u);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free and every hidden row is written

  // Phase 2: job j = (output tile j / chunks, depth tile j % chunks of the slice).
  const int jobs2 = (p.d / BT) * chunks;
  auto load2 = [&](int j) {
    if (j < jobs2) {
      const int n0 = (j / chunks) * BT, i0 = (j % chunks) * BT;
      stage_tile<kThreads>(ring + (j % kStages) * kStage, wd + static_cast<long long>(i0) * p.d + n0, p.d, tid);
    }
    cp_async_commit();
  };
  float acc[8][4];
  zero(acc);
  const __nv_bfloat16* h_rows = hs + (warp * 16 + gid) * ldh + 2 * tig;
  for (int j = 0; j < kStages - 1; ++j) load2(j);
  for (int j = 0; j < jobs2; ++j) {
    cp_async_wait_oldest<kStages>();
    __syncthreads();
    load2(j + kStages - 1);
    mma_tile(acc, h_rows, ldh, (j % chunks) * BT, ring + (j % kStages) * kStage, lane);
    if (j % chunks == chunks - 1) {
      const int n0 = (j / chunks) * BT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + gid + 8 * half;
        if (r < rows) {
          float* out = p.partial + (static_cast<long long>(s) * p.P + row0 + r) * p.d + n0 + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(out + nt * 8) = make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
      }
      zero(acc);
    }
  }
}

template <int BM, int S>
int launch(const Params& p, int splits, int tiles, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM, S>(p.slice);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(moe_grouped_kernel<BM, S>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_grouped_kernel<BM, S><<<dim3(tiles, splits), BM * 2, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace moe
}  // namespace runia

// x (T, d), w_gate / w_up (E, d, I), w_down (E, I, d): bf16, contiguous, d
// and I / splits multiples of 64; tok (P,), offsets (E + 1,) int32;
// partial (splits, P, d) f32; work: 2 uint64 counters; (bm, stages): pairs
// a tile and ring stages, (64, 2) or (128, 3); tiles: the grid's
// static bound on the tiles.
extern "C" int runia_moe_grouped(const void* x, const void* tok, const void* offsets, const void* w_gate,
                                 const void* w_up, const void* w_down, void* partial, void* work, int P, int d,
                                 int I, int E, int splits, int bm, int stages, int tiles, void* stream) {
  using namespace runia::moe;
  if (P <= 0 || d % BT || splits <= 0 || I % (splits * BT) || tiles <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.tok = static_cast<const int*>(tok);
  p.offsets = static_cast<const int*>(offsets);
  p.wg = static_cast<const __nv_bfloat16*>(w_gate);
  p.wu = static_cast<const __nv_bfloat16*>(w_up);
  p.wd = static_cast<const __nv_bfloat16*>(w_down);
  p.partial = static_cast<float*>(partial);
  p.work = static_cast<unsigned long long*>(work);
  p.P = P; p.d = d; p.I = I; p.E = E; p.slice = I / splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64 && stages == 2) return launch<64, 2>(p, splits, tiles, s);
  if (bm == 128 && stages == 3) return launch<128, 3>(p, splits, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
