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
// K * N bytes per call: 8.39 MB (qkv), 23.07 MB (gate|up), 4.19 MB (o),
// 11.53 MB (down) and 65.5 MB (lm_head) of the production Llama need 0.0025,
// 0.0069, 0.0013, 0.0034 and 0.0196 ms at 3.35 TB/s, about 1.1 GB and
// 0.33 ms per decode step. The products (16 FMAs a byte) need a tenth of
// that on the bf16 tensor cores. Only from about 300 rows up do operations
// bound it.
//
// Design: a split-K weight stream. The grid is (N / 128 column tiles, K
// splits, row blocks): the split count is chosen by the wrapper's planner so
// that every decode shape has about two blocks for each of the 132 SMs, and
// each split's K range is a multiple of the 64-row stage. A block of 4 warps
// walks its K range through a ring of 4 shared-memory stages filled by
// 16-byte cp.async: a (64 x 128) int8 weight tile, read as 128-byte row
// segments, and the (block rows x 64) tile of x. Loads of three stages are
// in flight per block while the fourth is multiplied, with one barrier per
// stage. Rows are padded by 16 bytes, so fragment loads meet no bank
// conflicts. A warp owns 32 columns: thread (g, t) of the mma fragment reads
// the word of columns 4 g .. 4 g + 3 from weight rows 2 t, 2 t + 1, 2 t + 8,
// 2 t + 9, converts the int8 to bf16 in registers (exact: byte b becomes the
// f32 2^23 + (b ^ 0x80), minus 2^23 + 128, whose upper half is the bf16) and
// permutes them with prmt into the B fragments of four
// mma.sync.m16n8k16 bf16 x bf16 -> f32 products, one for each column of the
// word; the thread then holds 8 adjacent output columns. bf16 x bf16
// products are exact in f32, so the function is the TPU kernel's: f32 sum,
// times scale, one rounding. 16 decode rows are one m16 tile; more rows are
// 2 or 4 m16 tiles against the same converted weights, so the weights are
// read once per 64 rows. Partial sums of a split go to an f32 scratch tensor;
// the last block to arrive at an output tile (an integer counter taken after
// __threadfence(), set back to zero by that block) adds the partials in
// split order, so the result does not depend on the order blocks ran in,
// then applies scale and rounds once. Ragged rows, K and N are masked inside
// the kernel (zero-filled loads, guarded stores); an N, K or pointer that
// does not allow 16-byte loads takes an element-wise staging path inside the
// same kernel.
//
// f32 x is the same stream with the products as f32 FMAs on the CUDA cores
// (TF32 would not hold its 1e-5 bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runia {
namespace qmm {

constexpr int kThreads = 128;
constexpr int BN = 128;        // output columns per block
constexpr int KT = 64;         // rows of K per stage
constexpr int kStages = 4;
constexpr int WS = BN + 16;    // bytes per weight row in shared memory

// Elements per x row in shared memory: 16 bytes of padding.
template <typename T> __host__ __device__ constexpr int x_stride() { return KT + 16 / static_cast<int>(sizeof(T)); }
template <typename T, int MT>
__host__ __device__ constexpr size_t stage_bytes() { return KT * WS + 16 * MT * x_stride<T>() * sizeof(T); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = live ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Byte J of the words lo and hi (already ^ 0x80808080) as a bf16 pair, lo in
// the low half.
template <int J>
__device__ __forceinline__ uint32_t int8_pair_to_bf16(uint32_t lo, uint32_t hi) {
  const float a = __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7440 | J)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
__device__ __forceinline__ float byte_to_f32(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xffu));
}

__device__ __forceinline__ void store_row8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The 8 adjacent columns of `v`, scaled, rounded once to T and stored from
// column col0 of one output row (col0 is a multiple of 8).
__device__ __forceinline__ void store_out8(float* dst, const float (&v)[8], int col0, int N, bool vec) {
  if (vec && col0 + 8 <= N) {
    store_row8(dst, v);
  } else {
    for (int i = 0; i < 8 && col0 + i < N; ++i) dst[i] = v[i];
  }
}
__device__ __forceinline__ void store_out8(__nv_bfloat16* dst, const float (&v)[8], int col0, int N, bool vec) {
  if (vec && col0 + 8 <= N) {
    uint4 packed;
    __nv_bfloat162 h;
    h = __floats2bfloat162_rn(v[0], v[1]); packed.x = *reinterpret_cast<uint32_t*>(&h);
    h = __floats2bfloat162_rn(v[2], v[3]); packed.y = *reinterpret_cast<uint32_t*>(&h);
    h = __floats2bfloat162_rn(v[4], v[5]); packed.z = *reinterpret_cast<uint32_t*>(&h);
    h = __floats2bfloat162_rn(v[6], v[7]); packed.w = *reinterpret_cast<uint32_t*>(&h);
    *reinterpret_cast<uint4*>(dst) = packed;
  } else {
    for (int i = 0; i < 8 && col0 + i < N; ++i) dst[i] = __float2bfloat16(v[i]);  // round to nearest even
  }
}

struct Args {
  const void* x; const int8_t* wq; const float* scale; void* out;
  float* scratch;   // (splits, row blocks * block rows, column tiles * BN) f32 partial sums
  int* counters;    // one per (column tile, row block), zero between launches
  int rows, K, N, k_per_split;
  int w_vec, x_vec, out_vec;  // 16-byte accesses are aligned
};

// MT: m16 row tiles per block (block rows = 16 * MT).
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(const Args a) {
  constexpr int XS = x_stride<T>();
  constexpr int BM = 16 * MT;
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int r0 = blockIdx.z * BM;
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int ntiles = (k_end - k_begin + KT - 1) / KT;
  const T* x = static_cast<const T*>(a.x);

  auto w_stage = [&](int s) { return reinterpret_cast<int8_t*>(smem + s * stage_bytes<T, MT>()); };
  auto x_stage = [&](int s) { return reinterpret_cast<T*>(smem + s * stage_bytes<T, MT>() + KT * WS); };

  // Fetch tile `t` of this block's K range into its ring slot; everything
  // past k_end, rows and N arrives as zeros.
  auto load_tile = [&](int t) {
    const int k0 = k_begin + t * KT;
    int8_t* ws = w_stage(t % kStages);
    T* xs = x_stage(t % kStages);
    for (int c = tid; c < KT * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + col;
      int8_t* dst = ws + r * WS + col;
      if (a.w_vec) {
        const bool live = k < k_end && n < a.N;
        cp_async16(dst, live ? a.wq + static_cast<size_t>(k) * a.N + n : a.wq, live);
      } else {
        for (int i = 0; i < 16; ++i)
          dst[i] = (k < k_end && n + i < a.N) ? a.wq[static_cast<size_t>(k) * a.N + n + i] : int8_t(0);
      }
    }
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
    for (int c = tid; c < BM * (KT / kPer); c += kThreads) {
      const int r = c / (KT / kPer), col = (c % (KT / kPer)) * kPer;
      const int row = r0 + r, k = k0 + col;
      T* dst = xs + r * XS + col;
      if (a.x_vec) {
        const bool live = row < a.rows && k < k_end;
        cp_async16(dst, live ? x + static_cast<size_t>(row) * a.K + k : x, live);
      } else {
        for (int i = 0; i < kPer; ++i)
          dst[i] = (row < a.rows && k + i < k_end) ? x[static_cast<size_t>(row) * a.K + k + i] : T(0.f);
      }
    }
  };

  // acc[mt][j]: the m16n8 accumulator of row tile mt and column j of the
  // thread's weight words: [0], [1] row gid, columns 8 tig + j and 8 tig + 4
  // + j of the warp's 32; [2], [3] the same columns of row gid + 8.
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }
  // The thread's 8 adjacent output columns, and their scales: fetched now, so
  // that the block that finishes a tile does not wait for them at the end.
  const int col0 = n0 + warp * 32 + 8 * tig;
  float sc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[i] = col0 + i < a.N ? a.scale[col0 + i] : 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);  // into tile t - 1's slot
    cp_async_commit();
    const int8_t* ws = w_stage(t % kStages);
    const T* xs = x_stage(t % kStages);
    if (kMma) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        const uint32_t* wrow = reinterpret_cast<const uint32_t*>(ws + (kk + 2 * tig) * WS + warp * 32 + 4 * gid);
        const uint32_t w0 = wrow[0] ^ 0x80808080u, w1 = wrow[WS / 4] ^ 0x80808080u;
        const uint32_t w8 = wrow[8 * WS / 4] ^ 0x80808080u, w9 = wrow[9 * WS / 4] ^ 0x80808080u;
        uint32_t bf[4][2];
        bf[0][0] = int8_pair_to_bf16<0>(w0, w1); bf[0][1] = int8_pair_to_bf16<0>(w8, w9);
        bf[1][0] = int8_pair_to_bf16<1>(w0, w1); bf[1][1] = int8_pair_to_bf16<1>(w8, w9);
        bf[2][0] = int8_pair_to_bf16<2>(w0, w1); bf[2][1] = int8_pair_to_bf16<2>(w8, w9);
        bf[3][0] = int8_pair_to_bf16<3>(w0, w1); bf[3][1] = int8_pair_to_bf16<3>(w8, w9);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t* xr = reinterpret_cast<const uint32_t*>(xs + (mt * 16 + gid) * XS + kk + 2 * tig);
          const uint32_t af[4] = {xr[0], xr[8 * XS / 2], xr[4], xr[8 * XS / 2 + 4]};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, bf[j][0], bf[j][1]);
        }
      }
    } else {
      const float* xf = reinterpret_cast<const float*>(xs);
#pragma unroll 4
      for (int k = 0; k < KT; ++k) {
        const uint32_t* wrow = reinterpret_cast<const uint32_t*>(ws + k * WS + warp * 32 + 8 * tig);
        const uint32_t wlo = wrow[0], whi = wrow[1];  // columns 8 tig .. + 3 and + 4 .. + 7
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) { lo[j] = byte_to_f32(wlo, j); hi[j] = byte_to_f32(whi, j); }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float xa = xf[(mt * 16 + gid) * XS + k], xb = xf[(mt * 16 + gid + 8) * XS + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[mt][j][0] = fmaf(xa, lo[j], acc[mt][j][0]);
            acc[mt][j][1] = fmaf(xa, hi[j], acc[mt][j][1]);
            acc[mt][j][2] = fmaf(xb, lo[j], acc[mt][j][2]);
            acc[mt][j][3] = fmaf(xb, hi[j], acc[mt][j][3]);
          }
        }
      }
    }
  }

  // The thread's 8 adjacent columns of the two rows of each row tile.
  const size_t mpad = static_cast<size_t>(gridDim.z) * BM, npad = static_cast<size_t>(gridDim.x) * BN;
  if (splits > 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v[8] = {acc[mt][0][2 * half], acc[mt][1][2 * half], acc[mt][2][2 * half], acc[mt][3][2 * half],
                            acc[mt][0][2 * half + 1], acc[mt][1][2 * half + 1], acc[mt][2][2 * half + 1],
                            acc[mt][3][2 * half + 1]};
        const size_t row = r0 + mt * 16 + gid + 8 * half;
        store_row8(a.scratch + (split * mpad + row) * npad + col0, v);
      }
    __threadfence();  // the partial sums are visible before the count rises
    __syncthreads();
    if (tid == 0) {
      int* counter = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
      is_last = atomicAdd(counter, 1) == splits - 1;
      if (is_last) *counter = 0;  // ready for the next launch on this stream
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();  // the count was read before any partial sum is
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = r0 + mt * 16 + gid;  // and row + 8
    float v[2][8];
    if (splits > 1) {
      // The partial sums of both rows, added in split order whichever block
      // arrived last. The loads of kBatch splits are issued together: one
      // round trip to the L2 per batch, not one per split.
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int i = 0; i < 8; ++i) v[half][i] = 0.f;
      constexpr int kBatch = 8;
      for (int s0 = 0; s0 < splits; s0 += kBatch) {
        float4 part[kBatch][2][2];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (s0 + i < splits) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float4* src =
                  reinterpret_cast<const float4*>(a.scratch + ((s0 + i) * mpad + row + 8 * half) * npad + col0);
              part[i][half][0] = __ldcg(src);
              part[i][half][1] = __ldcg(src + 1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          if (s0 + i < splits) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              v[half][0] += part[i][half][0].x; v[half][1] += part[i][half][0].y;
              v[half][2] += part[i][half][0].z; v[half][3] += part[i][half][0].w;
              v[half][4] += part[i][half][1].x; v[half][5] += part[i][half][1].y;
              v[half][6] += part[i][half][1].z; v[half][7] += part[i][half][1].w;
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[half][j] = acc[mt][j][2 * half];
          v[half][4 + j] = acc[mt][j][2 * half + 1];
        }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (row + 8 * half >= a.rows || col0 >= a.N) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[half][i] *= sc[i];
      store_out8(out + static_cast<size_t>(row + 8 * half) * a.N + col0, v[half], col0, a.N, a.out_vec);
    }
  }
}

template <typename T, int MT>
int launch(const Args& a, int splits, cudaStream_t stream) {
  constexpr size_t smem = kStages * stage_bytes<T, MT>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_matmul_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.N + BN - 1) / BN, splits, (a.rows + 16 * MT - 1) / (16 * MT));
  quant_matmul_kernel<T, MT><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(Args a, int block_rows, int splits, cudaStream_t stream) {
  const auto at16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  a.w_vec = a.N % 16 == 0 && at16(a.wq);
  a.x_vec = a.K % kPer == 0 && at16(a.x);
  a.out_vec = a.N % 8 == 0 && at16(a.out);
  if (block_rows == 16) return launch<T, 1>(a, splits, stream);
  if (block_rows == 32) return launch<T, 2>(a, splits, stream);
  if (block_rows == 64) return launch<T, 4>(a, splits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace qmm
}  // namespace runia

// dtype: 0 = float32, 1 = bfloat16 (x and out). block_rows (16, 32 or 64),
// splits and k_per_split (a multiple of 64) come from the wrapper's planner;
// scratch holds splits * ceil(rows / block_rows) * block_rows * ceil(N / 128)
// * 128 floats when splits > 1, and counters ceil(N / 128) * ceil(rows /
// block_rows) zeroed ints.
extern "C" int runia_quant_matmul(const void* x, const void* wq, const void* scale, void* out,
                                  void* scratch, void* counters, int rows, int K, int N,
                                  int block_rows, int splits, int k_per_split, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || k_per_split < 1 || k_per_split % runia::qmm::KT != 0 ||
      static_cast<long long>(splits) * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  runia::qmm::Args a;
  a.x = x; a.wq = static_cast<const int8_t*>(wq); a.scale = static_cast<const float*>(scale); a.out = out;
  a.scratch = static_cast<float*>(scratch); a.counters = static_cast<int*>(counters);
  a.rows = rows; a.K = K; a.N = N; a.k_per_split = k_per_split;
  a.w_vec = a.x_vec = a.out_vec = 0;
  if (dtype == 0) return runia::qmm::dispatch<float>(a, block_rows, splits, s);
  if (dtype == 1) return runia::qmm::dispatch<__nv_bfloat16>(a, block_rows, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
