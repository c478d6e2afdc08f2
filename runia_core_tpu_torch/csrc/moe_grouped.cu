// Routed sparse-MoE experts as grouped kernels: for the (token, expert) pairs
// sorted by expert (tok[p]: the pair's token; offsets[e]: expert e's first
// pair), out[p] = silu(x[tok[p]] W_gate[e]) * (x[tok[p]] W_up[e]) W_down[e]
// in f32, the hidden product rounded to bf16.
//
// Replaces no TPU kernel: the JAX package's _moe_ffn is a dense einsum that
// XLA fuses, every expert over every token, and the port ran it as a loop of
// 3 E products over all tokens with the gates of the unpicked experts zero
// (E / k times the work). Here each expert runs over its own rows only.
//
// Bound on the H100: the layer is bound by its weights' bytes until each
// expert sees a few hundred rows. A decode step's 8 tokens x 8 experts touch
// about 41 of 64 experts, and those experts' 12.4 MB each (bf16, 2304 x 896 x
// 3) take 0.15 ms a layer at 3.35 TB/s, against 0.0008 ms of operations. A
// 512-token prefill lane's 4,096 pairs read all 64 experts, each pair's row
// in and its f32 row out: 0.254 ms at one lane and 0.304 at four, against
// 0.05-0.2 ms of operations at 989 TFLOP/s.
//
// The hidden width is whole per tile and the work is two grouped products:
// moe_grouped_kernel_gateup writes h = silu(x W_gate) * (x W_up), rounded to
// bf16, as (P, I) rows in sorted order, and moe_grouped_kernel_down writes h
// W_down as the f32 output rows, each once (no slice partials to sum). A
// block owns up to 128 pairs of one expert and 256 columns of a wgmma (gate
// and up 128 each side by side, or 256 output columns): a producer warpgroup
// keeps a ring of four 48 KB stages filled and two consumer warpgroups, 64
// rows each, run wgmma m64n256k16 (bf16 -> f32) on the stages that have
// landed; a warpgroup whose rows hold no pair skips its products, so a
// decode step's tiles of a pair or two cost the weights' bytes and little
// else. The weights are contiguous (E, d, I) and (E, I, d), so plain 2-D
// tensor maps serve: TMA brings 64 x 64 boxes with the 128-byte swizzle that
// the wgmma descriptors name (B is N-major: four 64-column panels, the
// leading byte offset a panel, the stride one 8-row group); h is sorted, so
// TMA reads it too. TMA cannot gather rows, so the producer brings the
// pairs' token rows with 16-byte cp.async into the same swizzled layout,
// waits for its own copies a few stages behind, fences them for the async
// proxy and arrives on the stage's barrier beside the TMA's byte count. The
// maps are built on the host (cuTensorMapEncodeTiled from the runtime's
// driver entry point, so the library links only the runtime) and passed as
// __grid_constant__ parameters, which a captured graph keeps. Blocks walk
// the experts in order, an expert's column tiles in order and its row tiles
// innermost, so the blocks that share a weight tile run side by side and
// read it from HBM about once; each block finds its tile from the offsets on
// the device and a block past the last returns, so the grid is a static
// bound and nothing comes back to the host: the launch is capturable.
// Columns past the width come in as the maps' zeros and are not written, so
// any d and I in multiples of 64 are taken. The first block of each touched
// expert in the first kernel adds the expert's pairs and 1 to work[0..1]
// (the benchmark's count of pairs and touched experts).

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace runia {
namespace moe {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kRows = 128;                                  // pairs a tile: two consumer warpgroups of 64
constexpr int kDepth = 64;                                  // depth a stage: one 128-byte swizzled row of bf16
constexpr int kPanel = 64;                                  // columns of a TMA box
constexpr int kStages = 4;
constexpr int kLag = kStages - 2;                           // stages the producer's row copies run ahead of its arrival
constexpr int kThreads = 384;                               // the producer warpgroup, then two consumers
constexpr int kProducerRegs = 56, kConsumerRegs = 224;      // 168 a thread at launch, moved to the consumers
constexpr uint32_t kABytes = kRows * kDepth * 2;            // the stage's rows
constexpr uint32_t kPanelBytes = kDepth * kPanel * 2;       // one 64 x 64 box of a weight
constexpr uint32_t kStageBytes = kABytes + 4 * kPanelBytes;  // rows | four panels: 48 KB
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + kRows * sizeof(int);

struct Params {
  const __nv_bfloat16* x; const int* tok; const int* offsets;
  __nv_bfloat16* h; float* out; unsigned long long* work;
  int P, d, I, E;
};

struct Tile { int e, n, row0, rows, count; };

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// A 2-D box of a tensor map into shared memory, counted on `bar`: c0 the column, c1 the row.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <int N>
__device__ __forceinline__ void reg_dealloc() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N)); }
template <int N>
__device__ __forceinline__ void reg_alloc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N)); }

// A wgmma shared-memory descriptor with the 128-byte swizzle: the start, the
// leading and the stride byte offsets.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lead >> 4) << 16 |
         static_cast<uint64_t>(stride >> 4) << 32 | 1ull << 62;
}

// d (64 x 256 f32, the warpgroup's fragments) += A (64 x 16, K-major) * B
// (16 x 256, N-major).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void fence_acc(float (&acc)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// The consumer warpgroup cw's 64 rows of the tile against every stage: acc
// = rows (k-major, 128-byte rows) x the stage's four N-major panels, over
// `steps` stages of 64 deep. A stage's products stay in flight while the
// next stage's are issued; a stage is released when its products are done.
// Both warpgroups wait for each stage and release it, whether or not their
// rows hold pairs.
__device__ __forceinline__ void consume(float (&acc)[128], unsigned char* stages, uint64_t* full, uint64_t* empty,
                                        int steps, int cw, bool active) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int j = 0; j < steps; ++j) {
    const int st = j % kStages;
    mbar_wait(full + st, (j / kStages) & 1);
    if (active) {
      const uint32_t a = smem_u32(stages + st * kStageBytes) + cw * (kABytes / 2);
      const uint32_t b = smem_u32(stages + st * kStageBytes + kABytes);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        wgmma_256(acc, descriptor(a + kk * 32, 16, 1024), descriptor(b + kk * 16 * 128, kPanelBytes, 1024), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // stage j - 1's products are done
      fence_acc(acc);
    }
    if (j > 0) mbar_arrive(empty + (j - 1) % kStages);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

struct Shared { unsigned char* stages; uint64_t* full; uint64_t* empty; int* tok; };

// The ring at a 1,024-byte boundary (the swizzle's period), then the barriers and the tile's tokens.
__device__ __forceinline__ Shared carve(unsigned char* raw) {
  unsigned char* stages = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * kStageBytes);
  return Shared{stages, full, full + kStages, reinterpret_cast<int*>(full + 2 * kStages)};
}

// Warp 0 finds the block's tile: the experts in order, an expert's column
// tiles in order, its row tiles innermost (a prefix sum of the experts'
// tile counts, 32 experts a step). Lane 0 then sets the barriers up: full
// waits for full_count arrivals and the stage's bytes, empty for every
// consumer. A block past the last tile returns false.
__device__ __forceinline__ bool setup(const Params& p, int col_tiles, const Shared& s, uint32_t full_count, Tile& t) {
  __shared__ Tile tile_s;
  __shared__ int live_s;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    if (lane == 0) live_s = 0;
    __syncwarp();
    int idx = blockIdx.x;
    for (int e0 = 0; e0 < p.E && idx >= 0; e0 += 32) {
      const int e = e0 + lane;
      const int lo = e < p.E ? p.offsets[e] : 0, count = e < p.E ? p.offsets[e + 1] - lo : 0;
      const int row_tiles = (count + kRows - 1) / kRows, tiles = row_tiles * col_tiles;
      int end = tiles;  // this chunk's tiles up to and with expert e
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += v;
      }
      if (idx >= end - tiles && idx < end) {
        const int local = idx - (end - tiles), m = local % row_tiles;
        tile_s = Tile{e, local / row_tiles, lo + m * kRows, min(kRows, count - m * kRows), count};
        live_s = 1;
      }
      idx -= __shfl_sync(0xffffffffu, end, 31);
    }
    __syncwarp();
    if (lane == 0 && live_s) {
      for (int i = 0; i < kStages; ++i) {
        mbar_init(s.full + i, full_count);
        mbar_init(s.empty + i, kThreads - 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  t = tile_s;
  return live_s;
}

// h[p] = silu(x[tok[p]] W_gate[e][:, n]) * (x[tok[p]] W_up[e][:, n]) for
// the tile's pairs and 128 columns n.
__global__ void __launch_bounds__(kThreads, 1)
    moe_grouped_kernel_gateup(const __grid_constant__ CUtensorMap wg_map, const __grid_constant__ CUtensorMap wu_map,
                              const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Shared s = carve(smem_raw);
  Tile t;
  // The producer's 128 threads arrive when their rows have landed; thread 0 once more with the weights' bytes.
  if (!setup(p, (p.I + 127) / 128, s, 129, t)) return;
  const int tid = threadIdx.x, steps = p.d / kDepth, n0 = t.n * 128;
  if (tid < 128) {
    reg_dealloc<kProducerRegs>();
    if (tid == 0 && t.n == 0 && t.row0 == p.offsets[t.e]) {
      atomicAdd(p.work, static_cast<unsigned long long>(t.count));
      atomicAdd(p.work + 1, 1ull);
    }
    s.tok[tid] = tid < t.rows ? p.tok[t.row0 + tid] : -1;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    const int wrow = t.e * p.d, chunk = tid & 7;
    for (int j = 0; j < steps; ++j) {
      const int st = j % kStages, k0 = j * kDepth;
      mbar_wait(s.empty + st, ((j / kStages) & 1) ^ 1);
      unsigned char* a = s.stages + st * kStageBytes;
      unsigned char* b = a + kABytes;
      if (tid == 0) {
        mbar_arrive_expect_tx(s.full + st, 4 * kPanelBytes);
        tma_load(b, &wg_map, s.full + st, n0, wrow + k0);
        tma_load(b + kPanelBytes, &wg_map, s.full + st, n0 + kPanel, wrow + k0);
        tma_load(b + 2 * kPanelBytes, &wu_map, s.full + st, n0, wrow + k0);
        tma_load(b + 3 * kPanelBytes, &wu_map, s.full + st, n0 + kPanel, wrow + k0);
      }
#pragma unroll
      for (int u = 0; u < kRows / 16; ++u) {  // row r's 16-byte chunk c lands at chunk c ^ (r % 8)
        const int r = (tid >> 3) + 16 * u, token = s.tok[r];
        if (token >= 0)
          cp_async16(a + r * 128 + ((chunk ^ (r & 7)) << 4),
                     p.x + static_cast<long long>(token) * p.d + k0 + chunk * 8);
      }
      cp_async_commit();
      // Job j - kLag's rows have landed: fence them for wgmma, then arrive. The lag stays under kStages - 1, so
      // that the job the consumers wait for never waits on a stage they still hold.
      if (j >= kLag) {
        cp_async_wait<kLag>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(s.full + (j - kLag) % kStages);
      }
    }
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int j = max(0, steps - kLag); j < steps; ++j) mbar_arrive(s.full + j % kStages);
  } else {
    reg_alloc<kConsumerRegs>();
    const int cw = tid / 128 - 1;
    float acc[128];
    consume(acc, s.stages, s.full, s.empty, steps, cw, cw * 64 < t.rows);
    const int lane = tid & 31, r0 = cw * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < t.rows) {
        __nv_bfloat16* row = p.h + static_cast<long long>(t.row0 + r) * p.I + n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 16; ++j) {  // column group j: gate in acc[4j..], up in acc[4(j + 16)..]
          if (n0 + j * 8 < p.I) {
            float v[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float g = acc[4 * j + 2 * half + q];
              v[q] = g / (1.f + __expf(-g)) * acc[4 * (j + 16) + 2 * half + q];
            }
            *reinterpret_cast<uint32_t*>(row + j * 8) = pack_bf16(v[0], v[1]);
          }
        }
      }
    }
  }
}

// out[p][n] = h[p] W_down[e][:, n] for the tile's pairs and 256 columns n.
__global__ void __launch_bounds__(kThreads, 1)
    moe_grouped_kernel_down(const __grid_constant__ CUtensorMap h_map, const __grid_constant__ CUtensorMap wd_map,
                            const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Shared s = carve(smem_raw);
  Tile t;
  if (!setup(p, (p.d + 255) / 256, s, 1, t)) return;
  const int tid = threadIdx.x, steps = p.I / kDepth, n0 = t.n * 256;
  if (tid < 128) {
    reg_dealloc<kProducerRegs>();
    if (tid == 0) {
      const int wrow = t.e * p.I;
      for (int j = 0; j < steps; ++j) {
        const int st = j % kStages, k0 = j * kDepth;
        mbar_wait(s.empty + st, ((j / kStages) & 1) ^ 1);
        unsigned char* a = s.stages + st * kStageBytes;
        mbar_arrive_expect_tx(s.full + st, kStageBytes);
        tma_load(a, &h_map, s.full + st, k0, t.row0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load(a + kABytes + q * kPanelBytes, &wd_map, s.full + st, n0 + q * kPanel, wrow + k0);
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int cw = tid / 128 - 1;
    float acc[128];
    consume(acc, s.stages, s.full, s.empty, steps, cw, cw * 64 < t.rows);
    const int lane = tid & 31, r0 = cw * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < t.rows) {
        float* row = p.out + static_cast<long long>(t.row0 + r) * p.d + n0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (n0 + j * 8 < p.d)
            *reinterpret_cast<float2*>(row + j * 8) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix in boxes of 64 columns x box_rows,
// 128-byte swizzled; boxes past its edge read zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows, long long cols,
              uint32_t box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kPanel, box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace moe
}  // namespace runia

// x (T, d), w_gate / w_up (E, d, I), w_down (E, I, d):
// bf16, contiguous, d and I multiples of 64; tok (P,), offsets (E + 1,)
// int32; h (P, I) bf16 scratch; out (P, d) f32; work: 2 uint64 counters.
extern "C" int runia_moe_grouped(const void* x, const void* tok, const void* offsets, const void* w_gate,
                                 const void* w_up, const void* w_down, void* h, void* out, void* work, int P, int d,
                                 int I, int E, void* stream) {
  using namespace runia::moe;
  if (P <= 0 || E <= 0 || d % kDepth || I % kDepth) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap wg_map, wu_map, wd_map, h_map;
  const long long ed = static_cast<long long>(E) * d, ei = static_cast<long long>(E) * I;
  if (!make_map(encode, &wg_map, w_gate, ed, I, kDepth) || !make_map(encode, &wu_map, w_up, ed, I, kDepth) ||
      !make_map(encode, &wd_map, w_down, ei, d, kDepth) || !make_map(encode, &h_map, h, P, I, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.tok = static_cast<const int*>(tok);
  p.offsets = static_cast<const int*>(offsets);
  p.h = static_cast<__nv_bfloat16*>(h);
  p.out = static_cast<float*>(out);
  p.work = static_cast<unsigned long long*>(work);
  p.P = P; p.d = d; p.I = I; p.E = E;
  const void* kernels[2] = {reinterpret_cast<const void*>(moe_grouped_kernel_gateup),
                            reinterpret_cast<const void*>(moe_grouped_kernel_down)};
  for (const void* kernel : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_tiles = (P + kRows - 1) / kRows + E;  // a static bound: each expert's last tile may be partial
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  moe_grouped_kernel_gateup<<<row_tiles * ((I + 127) / 128), kThreads, kSmem, s>>>(wg_map, wu_map, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_grouped_kernel_down<<<row_tiles * ((d + 255) / 256), kThreads, kSmem, s>>>(h_map, wd_map, p);
  return static_cast<int>(cudaGetLastError());
}
