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
// Bound on the H100: at the slice's prefill (B 8, Hq 16, Tq 1024, D 128) the
// causal work is 4 * B * Hq * Tq^2 / 2 * D = 34 GFLOP per layer against
// 0.1 GB of q, k, v and out: compute-bound. This first kernel computes on
// the CUDA cores in f32 (67 TFLOP/s of FMA at the most; both products are
// limited by shared-memory loads, which the float4 layout below keeps at one
// 16-byte load per 8 FMAs); bf16 tensor cores through mma/wgmma, at 989
// TFLOP/s, are the later redesign.
//
// Design: one block of 256 threads per (64-query tile, query head, batch
// row); the head reads kv group h / (Hq / G), so K/V stay at GQA width. The
// block loops only over the 32-key tiles that meet [kv_start, q_start +
// last query of the tile] (a block's loop replaces the TPU's sequential grid
// axis; blocks run in no order and share nothing). Q, K and V tiles are
// staged in shared memory as f32 (bf16 and int8 convert exactly); keys
// outside the tile's window are staged as zeros, so garbage in the cache
// past the written prefix never reaches a product. Thread (ty, tx) owns
// query rows ty + 16 i (i < 4): its logits for keys tx + 16 j (j < 2), and
// its output columns tx * D/16 .. + D/16. A row's 32 logits live in the 16
// lanes of one half-warp, so its max and sum are shuffles; the running max
// and denominator stay in registers (f32). As in the TPU kernel: logits =
// q.k * sm_scale (* k_scale), p = exp(s - m) zeroed where masked, the
// denominator sums p unrounded, and P (in KV8, p * v_scale) is rounded to
// q's type before the P.V product; out = acc / max(l, 1e-30). Tq, K and the
// windows are masked inside the kernel, so any Tq and K are taken (the TPU
// version's block divisibility does not apply). k and v are read through
// strides, so the model passes its (B, K, G, D) cache as a transposed view
// with no copy; q and out are strided the same way. D is a template
// parameter (64 or 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runia {
namespace flash {

constexpr int kThreads = 256;
constexpr int BQ = 64;  // queries per block
constexpr int BK = 32;  // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// Round an f32 to T and back (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Params {
  const void* q; const void* k; const void* v; void* out;
  const int* q_start; const int* kv_start;
  const float* k_scale; const float* v_scale;
  int B, Hq, G, Tq, K;
  long long q_sb, q_sh, q_st, k_sb, k_sg, k_sk, v_sb, v_sg, v_sk, o_sb, o_sh, o_st;
  long long s_sb, s_sk, s_sg;
  float sm_scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 4) + 2 * BK);
}

template <typename T, typename KV, int D, bool KV8>
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

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[r * (D + 4) + d] = (q0 + r < p.Tq) ? to_f32(qg[(q0 + r) * p.q_st + d]) : 0.f;
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
        const float pv = KV8 ? pj * vscale[tx + 16 * j] : pj;
        ps[row * (BK + 4) + tx + 16 * j] = round_to<T>(pv);
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
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vs + (kk + u) * D + tx * DC + c);
          vrow[c] = v4.x; vrow[c + 1] = v4.y; vrow[c + 2] = v4.z; vrow[c + 3] = v4.w;
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

  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= p.Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) og[(q0 + row) * p.o_st + tx * DC + c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, typename KV, int D, bool KV8>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, KV, D, KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_kernel<T, KV, D, KV8><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_kv(const Params& p, int kv8, cudaStream_t stream) {
  return kv8 ? launch<T, int8_t, D, true>(p, stream) : launch<T, T, D, false>(p, stream);
}

template <typename T>
int dispatch_d(const Params& p, int d, int kv8, cudaStream_t stream) {
  if (d == 64) return dispatch_kv<T, 64>(p, kv8, stream);
  if (d == 128) return dispatch_kv<T, 128>(p, kv8, stream);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.G <= 0 || p.Hq % p.G != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return runia::flash::dispatch_d<float>(p, d, kv8, s);
  if (dtype == 1) return runia::flash::dispatch_d<__nv_bfloat16>(p, d, kv8, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
