// Flash attention of a query chunk over a KV cache prefix, with per-row
// windows: q (B, Hq, Tq, D) bf16/f32; k, v (B, G, K, D) in q's type or int8
// (KV8, with per-key scales k_scale, v_scale (B, K, G) f32); query i of row b
// sits at position q_start[b] + i and attends keys kv_start[b] <= j <=
// q_start[b] + i. Out (B, Hq, Tq, D) in q's type; a row with an empty window
// is written as zeros.
//
// Replaces: runia_core_tpu/ops/flash_prefill.py::flash_prefix_attention
// (kernel bodies _kernel and _kernel_kv8), the TPU kernel whose sequential
// grid axis over key blocks carries the running max, denominator and output
// accumulator in VMEM scratch, and whose index maps clamp past each row's
// last live key block so those blocks are neither fetched nor computed.
// With q_start = 0 it also stands for the stock Pallas causal flash prefill
// that models/llama.py calls on the TPU.
//
// Bound on the H100: at the production prefill (B 8, Hq 16, Tq 1024, D 128)
// the causal work is 4 * B * Hq * Tq^2 / 2 * D = 34.4 GFLOP per layer
// against about 0.1 GB of q, k, v and out: bound by operations, 0.035 ms at
// the 989 TFLOP/s of the bf16 tensor cores (0.030 ms of memory traffic at
// 3.35 TB/s).
//
// Design for bf16 q (flash_mma_kernel): both products run on the tensor
// cores, mma.sync.m16n8k16 bf16 x bf16 -> f32. One block of 4 warps per (64
// queries, query head, batch row); the head reads kv group h / (Hq / G), so
// K/V stay at GQA width. A warp owns 16 query rows: its Q fragments are
// loaded once and stay in registers, its logits S (16 x 64) and its output
// accumulator (16 x D) stay in f32 registers, the running max and
// denominator of a row live in the four lanes of a quad (shuffles), and P
// goes from the S accumulator layout straight into the A operand of P.V
// without touching shared memory. As in the TPU kernel, P (p * v_scale in
// KV8) is rounded to bf16 before P.V while the denominator sums p unrounded,
// and KV8 logits are scaled by k_scale after the product; the softmax runs
// in base 2 with sm_scale * log2(e) folded into the logit scale. K/V tiles
// of 64 keys sit in shared memory as bf16 rows padded by 16 bytes, which
// keeps ldmatrix (plain for K, .trans for V) free of bank conflicts, in a
// ring of two stages: tile i + 1 is fetched while tile i is multiplied, by
// 16-byte cp.async, for a bf16 cache straight into the ring and for KV8 into
// an int8 buffer, from which each thread converts the chunks it fetched to
// bf16 (exact, |v| <= 127) into the ring after the products. The per-key scales are staged with their tile. The Q tile
// shares its shared memory with the second stage: it is dead once the
// fragments are in registers. A block visits only the key tiles that meet
// [kv_start, q_start + last query]; keys outside that range are staged as
// zeros, so garbage past the written prefix never reaches a product; the
// mask is computed only on tiles that cross a window edge, and a warp skips
// a tile that lies wholly after its rows. A fully masked row keeps m = -1e30
// and p = 0, so an empty window gives exact zeros. Late query tiles, which
// see the most keys, are launched first. Pointers or strides that are not
// 16-byte aligned take an element-wise staging path inside the same kernel.
// The output goes through the warp's own shared-memory rows to leave as
// 16-byte stores.
//
// f32 q (flash_kernel) keeps the CUDA-core body: Q, K, V staged as f32,
// scalar FMAs, a 64 x 32 tile. TF32 would not hold its 2e-5 bound.
//
// Tq, K and the windows are masked inside the kernels, so any Tq and K are
// taken. k, v, q and out are read through strides, so the model passes its
// (B, K, G, D) cache as a transposed view with no copy. D is a template
// parameter: 32, 64, 128 or 256, the head sizes of the port's models (at 256
// the tensor-core kernel's accumulators and Q fragments take most of its
// registers).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace runia {
namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; void* out;
  const int* q_start; const int* kv_start;
  const float* k_scale; const float* v_scale;
  int B, Hq, G, Tq, K;
  long long q_sb, q_sh, q_st, k_sb, k_sg, k_sk, v_sb, v_sg, v_sk, o_sb, o_sh, o_st;
  long long s_sb, s_sk, s_sg;
  float sm_scale;
  int q_vec, kv_vec, o_vec;  // 16-byte loads/stores are aligned (bf16 q only)
};

// ---------------------------------------------------------------------------
// bf16 q: tensor cores.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int BQ = kWarps * 16;  // queries per block
constexpr int BK = 64;           // keys per tile
constexpr int kPad = 8;          // bf16 elements of padding per shared-memory row

template <int D, bool KV8>
constexpr size_t smem_bytes() {
  // two stages of (K tile, V tile), then the staged scales [stage][k|v][BK],
  // then (KV8) the int8 K and V tiles as they arrive
  return sizeof(__nv_bfloat16) * 4 * BK * (D + kPad) + sizeof(float) * 4 * BK + (KV8 ? 2 * BK * D : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = live ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
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
// Four int8 of a word -> four bf16 (two words), exactly: byte b becomes the
// f32 2^23 + (b ^ 0x80), minus 2^23 + 128, whose upper half is the bf16.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  w ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_bf16(int8_t v) { return __float2bfloat16(static_cast<float>(v)); }

template <int D, bool KV8>
__global__ void __launch_bounds__(kThreads, 2) flash_mma_kernel(const Params p) {
  using KV = typename std::conditional<KV8, int8_t, __nv_bfloat16>::type;
  constexpr int LD = D + kPad;  // shared-memory row stride, bf16 elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [stage][k|v][BK][LD]
  float* scale_s = reinterpret_cast<float*>(kv_s + 4 * BK * LD);     // [stage][k|v][BK]
  int8_t* raw_s = reinterpret_cast<int8_t*>(scale_s + 4 * BK);       // KV8: [k|v][BK][D] int8
  __nv_bfloat16* q_s = kv_s + 2 * BK * LD;  // the Q tile borrows stage 1
  static_assert(BQ <= 2 * BK, "the Q tile fits one stage");

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // late tiles first: they see the most keys
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.Hq / p.G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragment's row group and thread in group
  const int qstart = p.q_start[b];
  const int kvstart = p.kv_start[b];
  const float scale_log2 = p.sm_scale * kLog2e;

  // Keys any row of this block may see: [lo, hi].
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  const int lo = max(kvstart, 0);
  const int hi = min(p.K - 1, qstart + q_last);
  const int tile0 = lo / BK;
  const int ntiles = hi >= lo ? hi / BK - tile0 + 1 : 0;
  const KV* kg = static_cast<const KV*>(p.k) + b * p.k_sb + g * p.k_sg;
  const KV* vg = static_cast<const KV*>(p.v) + b * p.v_sb + g * p.v_sg;

  // Start fetching key tile `tile` into `stage`. Returns (KV8) what the thread
  // carries to kv_end: the k_scale (threads 0..63) or v_scale (64..127) of its key.
  auto kv_begin = [&](int tile, int stage) -> float {
    const int k0 = tile * BK;
    __nv_bfloat16* ks = kv_s + stage * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    float scale = 0.f;
    if (KV8) {
      const int key = k0 + (tid & (BK - 1));
      const float* src = tid < BK ? p.k_scale : p.v_scale;
      if (key >= lo && key <= hi) scale = src[b * p.s_sb + key * p.s_sk + g * p.s_sg];
    }
    if (!p.kv_vec) {
      for (int idx = tid; idx < BK * D; idx += kThreads) {
        const int j = idx / D, d = idx % D;
        const int key = k0 + j;
        const bool live = key >= lo && key <= hi;
        ks[j * LD + d] = live ? to_bf16(kg[key * p.k_sk + d]) : __float2bfloat16(0.f);
        vs[j * LD + d] = live ? to_bf16(vg[key * p.v_sk + d]) : __float2bfloat16(0.f);
      }
    } else if (KV8) {
      constexpr int kChunks = D / 16;  // 16-byte chunks of int8 per key
#pragma unroll
      for (int u = 0; u < D / 32; ++u) {
        const int c = tid + u * kThreads;
        const int j = c / kChunks, d = (c % kChunks) * 16;
        const int key = k0 + j;
        const bool live = key >= lo && key <= hi;
        cp_async16(raw_s + c * 16, live ? kg + key * p.k_sk + d : kg, live);
        cp_async16(raw_s + BK * D + c * 16, live ? vg + key * p.v_sk + d : vg, live);
      }
    } else {
      constexpr int kChunks = D / 8;  // 16-byte chunks of bf16 per key
#pragma unroll
      for (int u = 0; u < BK * kChunks / kThreads; ++u) {
        const int c = tid + u * kThreads;
        const int j = c / kChunks, d = (c % kChunks) * 8;
        const int key = k0 + j;
        const bool live = key >= lo && key <= hi;
        cp_async16(ks + j * LD + d, live ? kg + key * p.k_sk + d : kg, live);
        cp_async16(vs + j * LD + d, live ? vg + key * p.v_sk + d : vg, live);
      }
    }
    cp_async_commit();
    return scale;
  };
  // Finish it (KV8): the scale and the converted int8 chunks go into the ring.
  auto kv_end = [&](int stage, float scale) {
    if (!KV8) return;
    scale_s[stage * 2 * BK + tid] = tid < BK ? scale * scale_log2 : scale;
    if (!p.kv_vec) return;
    // int8 -> bf16 of the chunks this thread fetched itself: its own
    // cp.async group is all it waits for.
    cp_async_wait_all();
    __nv_bfloat16* ks = kv_s + stage * 2 * BK * LD;
    __nv_bfloat16* vs = ks + BK * LD;
    constexpr int kChunks = D / 16;
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const int c = tid + u * kThreads;
      const int j = c / kChunks, d = (c % kChunks) * 16;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const uint4 raw = *reinterpret_cast<const uint4*>(raw_s + which * BK * D + c * 16);
        uint4 a, bq;
        int8x4_to_bf16x4(raw.x, a.x, a.y);
        int8x4_to_bf16x4(raw.y, a.z, a.w);
        int8x4_to_bf16x4(raw.z, bq.x, bq.y);
        int8x4_to_bf16x4(raw.w, bq.z, bq.w);
        __nv_bfloat16* dst = (which ? vs : ks) + j * LD + d;
        *reinterpret_cast<uint4*>(dst) = a;
        *reinterpret_cast<uint4*>(dst + 8) = bq;
      }
    }
  };

  float m_run[2] = {kNegInf, kNegInf};  // rows gid and gid + 8 of this warp, base-2 logits
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row's denominator
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  if (ntiles > 0) {
    // The Q tile (rows past Tq as zeros) and the first key tile.
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    if (p.q_vec) {
      constexpr int kChunks = D / 8;
      for (int c = tid; c < BQ * kChunks; c += kThreads) {
        const int r = c / kChunks, d = (c % kChunks) * 8;
        const bool live = q0 + r < p.Tq;
        cp_async16(q_s + r * LD + d, live ? qg + (q0 + r) * p.q_st + d : qg, live);
      }
    } else {
      for (int idx = tid; idx < BQ * D; idx += kThreads) {
        const int r = idx / D, d = idx % D;
        q_s[r * LD + d] = (q0 + r < p.Tq) ? qg[(q0 + r) * p.q_st + d] : __float2bfloat16(0.f);
      }
    }
    kv_end(0, kv_begin(tile0, 0));
    cp_async_wait_all();
    __syncthreads();

    // Q fragments of this warp's 16 rows: a[0] (row gid, d 2 tig..), a[1] (row
    // gid + 8), a[2], a[3] the same rows at d + 8.
    uint32_t qf[D / 16][4];
    {
      const __nv_bfloat16* qw = q_s + (warp * 16 + gid) * LD + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qw + kk * 16);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qw + 8 * LD + kk * 16);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qw + kk * 16 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(qw + 8 * LD + kk * 16 + 8);
      }
    }
    __syncthreads();  // the Q tile is in registers: stage 1 may be filled

    const int row_first = q0 + warp * 16;            // this warp's first query row
    const int pos_first = qstart + row_first;        // and its position
    const int pos_row[2] = {pos_first + gid, pos_first + gid + 8};

    for (int i = 0; i < ntiles; ++i) {
      const int stage = i & 1;
      if (i > 0) {
        cp_async_wait_all();
        __syncthreads();  // tile i has landed; every warp is done with tile i - 1
      }
      const bool more = i + 1 < ntiles;
      const float next_scale = more ? kv_begin(tile0 + i + 1, stage ^ 1) : 0.f;

      const int k0 = (tile0 + i) * BK;
      if (k0 <= pos_first + 15) {  // else the tile lies after every row of this warp
        const __nv_bfloat16* ks = kv_s + stage * 2 * BK * LD;
        const __nv_bfloat16* vs = ks + BK * LD;
        const float* kscale = scale_s + stage * 2 * BK;
        const float* vscale = kscale + BK;

        // S = Q K^T: 8 tiles of 16 x 8 logits.
        float s[BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            // matrices: (keys 16 np + 0..7, d lo), (same keys, d hi), (keys + 8, d lo), (keys + 8, d hi)
            uint32_t bf[4];
            ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
            mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          }
        }

        // Base-2 logits, masked where the tile crosses a window edge.
        const bool edge = k0 < kvstart || k0 + BK - 1 > min(pos_first, p.K - 1);
        float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * tig + (e & 1);
            float val = s[nt][e] * (KV8 ? kscale[col] : scale_log2);
            if (edge) {
              const int key = k0 + col;
              const bool valid = key >= kvstart && key <= pos_row[e >> 1] && key < p.K;
              val = valid ? val : kNegInf;
            }
            s[nt][e] = val;
            row_max[e >> 1] = fmaxf(row_max[e >> 1], val);
          }
        }
        float alpha[2], m_next[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
          row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
          m_next[r] = fmaxf(m_run[r], row_max[r]);
          alpha[r] = exp2f(m_run[r] - m_next[r]);  // both -1e30: 1, on zeros
          m_run[r] = m_next[r];
        }
        float row_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pj = s[nt][e] == kNegInf ? 0.f : exp2f(s[nt][e] - m_next[e >> 1]);
            row_sum[e >> 1] += pj;  // the denominator sums p unrounded
            s[nt][e] = KV8 ? pj * vscale[nt * 8 + 2 * tig + (e & 1)] : pj;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + row_sum[r];
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[dt][0] *= alpha[0]; acc[dt][1] *= alpha[0];
          acc[dt][2] *= alpha[1]; acc[dt][3] *= alpha[1];
        }

        // O += P V: the S accumulators of key tiles 2 kk and 2 kk + 1 are the
        // A operand of key step kk, rounded to bf16.
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            // matrices (transposed on load): (keys lo, d 16 dp..), (keys hi, same d), (keys lo, d + 8), (keys hi, d + 8)
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
            mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
          }
        }
      }
      if (more) kv_end(stage ^ 1, next_scale);
    }
  }
  __syncthreads();  // every warp is done with the ring: its rows take the output

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* o_s = kv_s + warp * 16 * LD;  // 16 rows of stage 0's K tile
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(o_s + gid * LD + dt * 8 + 2 * tig) = pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o_s + (gid + 8) * LD + dt * 8 + 2 * tig) = pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, d = (c % kChunks) * 8;
    const int row = q0 + warp * 16 + r;
    if (row >= p.Tq) continue;
    if (p.o_vec) {
      *reinterpret_cast<uint4*>(og + row * p.o_st + d) = *reinterpret_cast<const uint4*>(o_s + r * LD + d);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) og[row * p.o_st + d + e] = o_s[r * LD + d + e];
    }
  }
}

__host__ inline bool aligned16(const void* ptr, long long s0, long long s1, long long s2, int item) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (s0 * item) % 16 == 0 && (s1 * item) % 16 == 0 &&
         (s2 * item) % 16 == 0;
}

template <int D, bool KV8>
int launch(Params p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, KV8>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D, KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int kv_item = KV8 ? 1 : 2;
  p.q_vec = aligned16(p.q, p.q_sb, p.q_sh, p.q_st, 2);
  p.kv_vec = aligned16(p.k, p.k_sb, p.k_sg, p.k_sk, kv_item) && aligned16(p.v, p.v_sb, p.v_sg, p.v_sk, kv_item);
  p.o_vec = aligned16(p.out, p.o_sb, p.o_sh, p.o_st, 2);
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_mma_kernel<D, KV8><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ---------------------------------------------------------------------------
// f32 q: CUDA cores.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int BQ = 64;  // queries per block
constexpr int BK = 32;  // keys per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4) + 2 * BK);
}

// One block of 256 threads per (64-query tile, query head, batch row), 32-key
// tiles staged as f32. Thread (ty, tx) owns query rows ty + 16 i (i < 4):
// its logits for keys tx + 16 j (j < 2), and its output columns tx * D/16 ..
// + D/16. A row's 32 logits live in the 16 lanes of one half-warp, so its
// max and sum are shuffles; P goes through shared memory.
template <typename KV, int D, bool KV8>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // BQ x (D + 4)
  float* ks = qs + BQ * (D + 4);      // BK x (D + 4)
  float* vs = ks + BK * (D + 4);      // BK x D
  float* ps = vs + BK * D;            // BQ x (BK + 4)
  float* kscale = ps + BQ * (BK + 4);  // BK
  float* vscale = kscale + BK;        // BK
  constexpr int DC = D / 16;          // output columns per thread

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.Hq / p.G);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qstart = p.q_start[b];
  const int kvstart = p.kv_start[b];

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * (D + 4) + d] = (q0 + r < p.Tq) ? qg[(q0 + r) * p.q_st + d] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this tile may see: [lo, hi].
  const int q_last = min(q0 + BQ, p.Tq) - 1;
  const int lo = max(kvstart, 0);
  const int hi = min(p.K - 1, qstart + q_last);
  const KV* kg = static_cast<const KV*>(p.k) + b * p.k_sb + g * p.k_sg;
  const KV* vg = static_cast<const KV*>(p.v) + b * p.v_sb + g * p.v_sg;

  for (int k0 = (lo / BK) * BK; k0 <= hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int key = k0 + j;
      const bool live = key >= lo && key <= hi;
      ks[j * (D + 4) + d] = live ? to_f32(kg[key * p.k_sk + d]) : 0.f;
      vs[j * D + d] = live ? to_f32(vg[key * p.v_sk + d]) : 0.f;
    }
    if (KV8 && tid < BK) {
      const int key = k0 + tid;
      const bool live = key >= lo && key <= hi;
      const long long at = b * p.s_sb + key * p.s_sk + g * p.s_sg;
      kscale[tid] = live ? p.k_scale[at] : 0.f;
      vscale[tid] = live ? p.v_scale[at] : 0.f;
    }
    __syncthreads();

    // Logits of rows ty + 16 i against keys tx + 16 j.
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 q4[4], k4[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) q4[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * (D + 4) + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) k4[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(q4[i].x, k4[j].x, s[i][j]);
          s[i][j] = fmaf(q4[i].y, k4[j].y, s[i][j]);
          s[i][j] = fmaf(q4[i].z, k4[j].z, s[i][j]);
          s[i][j] = fmaf(q4[i].w, k4[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int pos = qstart + q0 + row;  // the query's position
      bool valid[2];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + tx + 16 * j;
        valid[j] = (q0 + row < p.Tq) && key >= kvstart && key <= pos && key < p.K;
        float val = s[i][j] * p.sm_scale;
        if (KV8) val *= kscale[tx + 16 * j];
        s[i][j] = valid[j] ? val : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_next = fmaxf(m[i], row_max);
      alpha[i] = expf(m[i] - m_next);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pj = valid[j] ? expf(s[i][j] - m_next) : 0.f;
        row_sum += pj;
        ps[row * (BK + 4) + tx + 16 * j] = KV8 ? pj * vscale[tx + 16 * j] : pj;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = alpha[i] * l[i] + row_sum;
      m[i] = m_next;
    }
    __syncthreads();  // P of the tile is complete

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * (BK + 4) + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vrow[DC];
        if constexpr (DC % 4 == 0) {
#pragma unroll
          for (int c = 0; c < DC; c += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(vs + (kk + u) * D + tx * DC + c);
            vrow[c] = v4.x; vrow[c + 1] = v4.y; vrow[c + 2] = v4.z; vrow[c + 3] = v4.w;
          }
        } else {  // D = 32: two columns a thread, 8-byte aligned
#pragma unroll
          for (int c = 0; c < DC; ++c) vrow[c] = vs[(kk + u) * D + tx * DC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pu, vrow[c], acc[i][c]);
        }
      }
    }
  }

  float* og = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= p.Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) og[(q0 + row) * p.o_st + tx * DC + c] = acc[i][c] * inv;
  }
}

template <typename KV, int D, bool KV8>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<KV, D, KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_kernel<KV, D, KV8><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
template <int D>
int dispatch(const Params& p, int dtype, int kv8, cudaStream_t stream) {
  if (dtype == 0) return kv8 ? launch<int8_t, D, true>(p, stream) : launch<float, D, false>(p, stream);
  if (dtype == 1) return kv8 ? mma::launch<D, true>(p, stream) : mma::launch<D, false>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flash
}  // namespace runia

// dims: B, Hq, G, Tq, K, D, then the element strides q (b, h, t), k (b, g, j),
// v (b, g, j), out (b, h, t) and the scales (b, j, g); the last dimension of
// q, k, v and out is contiguous. dtype: 0 = float32, 1 = bfloat16 (q, out and
// non-KV8 k, v); kv8: k and v are int8 with per-key scales.
extern "C" int runia_flash_prefix_attention(const void* q, const void* k, const void* v, void* out,
                                            const void* q_start, const void* kv_start,
                                            const void* k_scale, const void* v_scale,
                                            const long long* dims, float sm_scale, int dtype, int kv8,
                                            void* stream) {
  runia::flash::Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.q_start = static_cast<const int*>(q_start);
  p.kv_start = static_cast<const int*>(kv_start);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.B = static_cast<int>(dims[0]); p.Hq = static_cast<int>(dims[1]); p.G = static_cast<int>(dims[2]);
  p.Tq = static_cast<int>(dims[3]); p.K = static_cast<int>(dims[4]);
  const int d = static_cast<int>(dims[5]);
  p.q_sb = dims[6]; p.q_sh = dims[7]; p.q_st = dims[8];
  p.k_sb = dims[9]; p.k_sg = dims[10]; p.k_sk = dims[11];
  p.v_sb = dims[12]; p.v_sg = dims[13]; p.v_sk = dims[14];
  p.o_sb = dims[15]; p.o_sh = dims[16]; p.o_st = dims[17];
  p.s_sb = dims[18]; p.s_sk = dims[19]; p.s_sg = dims[20];
  p.sm_scale = sm_scale;
  p.q_vec = p.kv_vec = p.o_vec = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.G <= 0 || p.Hq % p.G != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 32) return runia::flash::dispatch<32>(p, dtype, kv8, s);
  if (d == 64) return runia::flash::dispatch<64>(p, dtype, kv8, s);
  if (d == 128) return runia::flash::dispatch<128>(p, dtype, kv8, s);
  if (d == 256) return runia::flash::dispatch<256>(p, dtype, kv8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
