// The MoE FFN's expert pass over the kept rows only, and its combine, on
// Hopper (sm_90a), bf16.
//
// Replaces no TPU kernel: the JAX package's MoE (src/repro/models/moe.py) is
// plain jnp, a capacity-padded einsum over every expert's `capacity` rows.
// The port's plain path (models/moe.py::expert_ffn) keeps that layout; on the
// card at olmoe's prefill (T 32,768, 64 experts top-8, capacity 16,384) it
// multiplies 1,048,576 rows of which 262,144 hold a routed pair.  These
// kernels read a compact layout instead (models/moe.py's
// compact_dispatch): each (expert, shard) group takes its kept rows, in token
// order, from a row that is a multiple of the row tile; a tile past a group's
// last row holds no work.
//
// What bounds it: operations.  At olmoe's prefill the up and gate products
// are 2 x 262,144 x 2048 x 1024 multiply-adds and the down product half of
// that, 3.3e12 flops a layer, 3.3 ms at the 989 TFLOP/s of the bf16 tensor
// cores; the weights (12.6 MB an expert) and the rows stream from L2.
//
// moe_grouped_gemm: out[r, :] = epilogue(a[row(r), :] . W[expert(r)]), one
// launch for every group:
//   * a persistent grid (one block an SM) walks the (row tile, column tile)
//     pairs of the upper bound on row tiles in order; the true count, the
//     last entry of the tiles' prefix sum, is read on the device, so group
//     sizes never reach the host, and a block stops at the first tile past
//     it.  A row tile's group is the last group whose first tile is at or
//     before it (a binary search over the prefix sum);
//   * a producer warpgroup fills a ring of four stages.  Its 128 threads
//     gather the tile's 128 rows of a (64 columns a stage) with cp.async,
//     16 bytes a thread and row, into the 128-byte-swizzled K-major layout
//     that the wgmma descriptors name; a row of -1 (the tile's rows past its
//     group's last) reads zeros.  One thread loads the expert's 64 x 256
//     weight tile with TMA (four 64 x 64 boxes of the (E, K, N) weights, the
//     reference's layout, read as wgmma's transposed, MN-major, B operand).
//     A thread signals a stage one stage after issuing it, once its own
//     copies have landed (cp.async.wait_group, then a proxy fence so that
//     the tensor cores' reads see them).  Data movement, not the tensor
//     cores, sets the kernel's pace at olmoe's shapes (on an H100 the down
//     kernel with its products removed took ~90% of its time);
//     signalling after two stages instead of one cost ~15%, and a
//     two-block cluster that multicast the weight tile to two row tiles of
//     one expert was slower still (the blocks wait on each other's stages);
//   * two consumer warpgroups of 64 rows each run m64n128k16 wgmma into two
//     64 x 128 fp32 accumulators, keeping one stage's products in flight
//     while the next is issued; setmaxnreg gives them 224 registers and the
//     producer 56;
//   * each output element is one fixed-order sum over K (no split-K), so a
//     row's bits depend only on that row and its expert's weights, never on
//     where it sits in its group or what else the group holds;
//   * the epilogue rounds where models/moe.py::expert_ffn rounds:
//     kGated: bf16(silu(bf16(x.W_gate))) * bf16(x.W_up), rounded once
//     more; kPlain: bf16(h.W).  silu is x / (1 + exp(-x)) with __expf and
//     a fast division (a few fp32 ulps from PyTorch's expf and IEEE
//     division, far below the bf16 rounding that follows; the precise
//     forms cost ~7% of the up kernel).  Each warpgroup
//     writes 64 x 128 outputs at a time into a 128-byte-swizzled buffer of
//     its own and stores them with TMA: 4-byte stores straight from the
//     accumulators filled half of each 32-byte sector and took ~30% of the
//     down kernel.
//
// moe_combine: out[t] = the token's (at most k) weighted rows summed in the
// order given (ascending expert), one bf16 rounding a product and an add,
// exactly models/moe.py's gather-add: the first term taken as it is, a
// dropped pair adding +0.  Bound by bytes: the kept rows are read once.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                  // rows a tile: two warpgroups of 64
constexpr int kBK = 64;                   // contraction a stage: 128 bytes
constexpr int kStages = 4;
constexpr int kLag = 1;                   // stages in flight before a signal
constexpr int kThreads = 384;             // producer + two consumer warpgroups
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr uint32_t kSub = 64 * 128;       // one 64 x 64 bf16 swizzled block
constexpr uint32_t kATile = kBM * 128;    // 128 rows x 64 columns
constexpr uint32_t kBTile = 4 * kSub;     // 64 x 256 weights
constexpr uint32_t kStage = kATile + kBTile;
constexpr uint32_t kEpi = 2 * kSub;       // a warpgroup's 64 x 128 outputs
constexpr size_t kSmem = 1024 + kStages * kStage + 2 * kEpi +
                         2 * kStages * 8;
static_assert(kLag <= kStages - 2, "a stage is released one stage late");

enum Mode { kPlain = 0, kGated = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Spins until the phase of parity `parity` has completed; traps after
// ~2^34 clocks (about 10 s) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// -- copies --------------------------------------------------------------
// 16 bytes from global to shared memory; zeros where `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma's operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store2(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------
// Shared-memory operand descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
// K-major A (a row of 128 bytes along the contraction): 8-row groups 1024
// bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// MN-major B (a row per contraction index, 64 output columns along it):
// 8-row groups 1024 bytes apart, 64-column blocks kSub apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return sw128_desc(addr, kSub, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = or += A (64 x 16, smem, K-major) . B (16 x 128, smem,
// MN-major)
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// silu on a bf16 value, in fp32.
__device__ __forceinline__ float silu_f32(float x) {
  return __fdividef(x, 1.f + __expf(-x));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap w0map,
                const __grid_constant__ CUtensorMap w1map,
                const __grid_constant__ CUtensorMap omap,
                const __nv_bfloat16* __restrict__ a, long long lda,
                const int* __restrict__ a_rows,
                const int* __restrict__ tile_start, int G, int group_div,
                int K, int N) {
  constexpr int kBN = kMode == kGated ? 128 : 256;  // output columns a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;      // swizzle atoms: 1 KB
  const uint32_t epi = base + kStages * kStage;    // one buffer a warpgroup
  const uint32_t bar = epi + 2 * kEpi;
#define FULL(s) (bar + 8 * (s))
#define EMPTY(s) (bar + 8 * (kStages + (s)))

  const int NT = (N + kBN - 1) / kBN, nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(FULL(s), 128 + 1);     // each producer thread, and the TMA
      mbar_init(EMPTY(s), 8);          // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();
  const int total = tile_start[G] * NT;   // (row tile, column tile) pairs

  if (warp < 4) {
    // ---- producer warpgroup ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs) : "memory");
    const int r0 = tid / 8, c = tid % 8;   // rows r0 + 16 j, 16-byte chunk c
    int it = 0;                            // stages issued by this block
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int mt = t / NT, nt = t - mt * NT;
      int e = 0;
      if (tid == 0) {
        int lo = 0, hi = G - 1;            // the last group starting <= mt
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (tile_start[mid] <= mt) lo = mid;
          else hi = mid - 1;
        }
        e = lo / group_div;
      }
      const __nv_bfloat16* src[8];
      bool live[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long r = (long long)mt * kBM + r0 + 16 * j;
        const int row = a_rows ? a_rows[r] : (int)r;
        live[j] = row >= 0;
        src[j] = a + (live[j] ? (long long)row * lda : 0) + 8 * c;
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(EMPTY(s), (it / kStages - 1) & 1);
        const uint32_t sA = base + s * kStage, sB = sA + kATile;
        const int k0 = kt * kBK;
        const bool in_k = k0 + 8 * c < K;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = r0 + 16 * j;
          const bool ok = live[j] && in_k;
          cp_async16(sA + row * 128 + ((c ^ (row & 7)) << 4),
                     ok ? src[j] + k0 : a, ok);
        }
        cp_async_commit();
        if (tid == 0) {
          mbar_expect_tx(FULL(s), kBTile);
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const bool second = kMode == kGated && b >= 2;
            const int n = nt * kBN + 64 * (kMode == kGated ? (b & 1) : b);
            tma_load3(sB + b * kSub, second ? &w1map : &w0map, FULL(s), n,
                      k0, e);
          }
        }
        if (it >= kLag) {
          cp_async_wait<kLag>();
          fence_proxy_async();
          mbar_arrive(FULL((it - kLag) % kStages));
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    for (int i = it > kLag ? it - kLag : 0; i < it; ++i)
      mbar_arrive(FULL(i % kStages));
  } else {
    // ---- consumer warpgroups: 64 rows each --------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs) : "memory");
    const int wg = warp / 4 - 1, w = warp % 4;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int mt = t / NT, nt = t - mt * NT;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(FULL(s), (it / kStages) & 1);
        const uint32_t sA = base + s * kStage + wg * 64 * 128;
        const uint32_t sB = base + s * kStage + kATile;
        fence_regs(acc0);
        fence_regs(acc1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma128(acc0, kmajor(sA + 32 * kk), mnmajor(sB + kk * 2048),
                   kt + kk > 0);
          wgmma128(acc1, kmajor(sA + 32 * kk),
                   mnmajor(sB + 2 * kSub + kk * 2048), kt + kk > 0);
        }
        wg_commit();
        wg_wait<1>();                     // the previous stage is read out
        fence_regs(acc0);
        fence_regs(acc1);
        if (kt > 0 && lane == 0) mbar_arrive(EMPTY((it - 1) % kStages));
      }
      wg_wait<0>();
      fence_regs(acc0);
      fence_regs(acc1);
      if (lane == 0) mbar_arrive(EMPTY((it - 1) % kStages));

      // ---- epilogue: 128 columns at a time through shared memory ----------
      // acc[4j + e] is row 16 w + lane / 4 + 8 (e >> 1) of the warpgroup,
      // column 8 j + cq + (e & 1) of the accumulator; the values are
      // written into the warpgroup's buffer as two 128-byte-swizzled 64 x 64
      // boxes and stored by TMA, which clips columns past N
      const uint32_t buf = epi + wg * kEpi;
      uint8_t* const gbuf = smem_raw + (buf - raw);
      const int row0 = mt * kBM + 64 * wg;
#pragma unroll
      for (int h = 0; h < (kMode == kGated ? 1 : 2); ++h) {
        // the buffer's previous store has been read out
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r, row = 16 * w + lane / 4 + 8 * r;
            float v[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              if (kMode == kGated) {
                const float up = bf16_round(acc0[i + x]);
                v[x] = bf16_round(silu_f32(bf16_round(acc1[i + x]))) * up;
              } else {
                v[x] = h == 0 ? acc0[i + x] : acc1[i + x];
              }
            }
            const uint32_t off = (j / 8) * kSub + row * 128 +
                                 (((j % 8) ^ (row & 7)) << 4) + 4 * (lane % 4);
            *reinterpret_cast<uint32_t*>(gbuf + off) = pack_bf16(v[0], v[1]);
          }
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
        if (w == 0 && lane == 0) {
          const int n0 = nt * kBN + 128 * h;
          if (n0 < N) tma_store2(&omap, buf, n0, row0);
          if (n0 + 64 < N) tma_store2(&omap, buf + kSub, n0 + 64, row0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      }
    }
    if (w == 0 && lane == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
#undef FULL
#undef EMPTY
}

// One block a token: each thread 8 columns (16 bytes) at a time.
template <int kMaxK>
__global__ void moe_combine_kernel(const __nv_bfloat16* __restrict__ y,
                                   const int* __restrict__ rows,
                                   const float* __restrict__ gates, int k,
                                   __nv_bfloat16* __restrict__ out, int d) {
  const long long t = blockIdx.x;
  int row[kMaxK];
  float g[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    row[j] = j < k ? rows[t * k + j] : -1;
    g[j] = j < k ? bf16_round(gates[t * k + j]) : 0.f;
  }
  for (int c = threadIdx.x; c < d / 8; c += blockDim.x) {
    uint4 in[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      if (row[j] >= 0)
        in[j] = *reinterpret_cast<const uint4*>(y + (long long)row[j] * d +
                                                8 * c);
    float acc[8];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j >= k) break;
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&in[j]);
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const float term =
            row[j] >= 0 ? bf16_round(__bfloat162float(v[x]) * g[j]) : 0.f;
        acc[x] = j == 0 ? term : bf16_round(acc[x] + term);
      }
    }
    uint4 res;
    uint32_t* p = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int x = 0; x < 4; ++x) p[x] = pack_bf16(acc[2 * x], acc[2 * x + 1]);
    *reinterpret_cast<uint4*>(out + t * d + 8 * c) = res;
  }
}

// -- host side -----------------------------------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Contiguous (E, K, N) bf16 weights as a 3-d tensor map of 64 x 64 boxes
// (64 contraction rows, 64 output columns), 128-byte swizzle, zeros outside.
int encode(CUtensorMap* map, const void* w, int E, int K, int N) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(w), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A contiguous (rows, N) bf16 output as a 2-d tensor map of 64 x 64 boxes,
// 128-byte swizzle; a store clips what lies outside.
int encode_out(CUtensorMap* map, void* out, long long rows, int N) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
int launch(const CUtensorMap* maps, const void* a, long long lda,
           const int* a_rows, const int* tile_start, int G, int group_div,
           int K, int N, int grid, cudaStream_t stream) {
  auto kern = moe_gemm_kernel<kMode>;
  // setmaxnreg only moves registers within the block's allocation
  static const bool enough = [kern] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kern) == cudaSuccess &&
           attr.numRegs * kThreads >=
               kProducerRegs * 128 + kConsumerRegs * 256;
  }();
  if (!enough) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(a), lda,
      a_rows, tile_start, G, group_div, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows_out, N) bf16, contiguous, rows_out at least the row tiles' upper
// bound times 128: row r = the product of a's row a_rows[r] (r itself where a_rows
// is null; zeros for -1) and the weights of expert (group of r) / group_div,
// under the epilogue of `mode` (0 plain, 1 silu(a.w1) * (a.w0)).  a: rows
// of K bf16 at stride lda (a multiple of 8, the pointer 16-byte aligned);
// w0, w1: contiguous (E, K, N) bf16 (w1 only for mode 1); K and N multiples
// of 8.  tile_start: G + 1 non-decreasing int32 on
// the device, group g owning row tiles [tile_start[g], tile_start[g + 1]).
// `grid` blocks, at most one an SM.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error that refused the arguments.
extern "C" int moe_grouped_gemm(const void* a, long long lda,
                                const int* a_rows, const void* w0,
                                const void* w1, int E, void* out,
                                long long rows_out, const int* tile_start,
                                int G, int group_div, int K, int N, int mode,
                                int grid, cudaStream_t stream) {
  if (K < 8 || N < 8 || K % 8 || N % 8 || lda % 8 || E < 1 || G < 1 ||
      group_div < 1 || G > E * group_div || grid < 1 || rows_out < 1 ||
      mode < 0 || mode > 1 || (mode == kGated && w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  int err = encode(&maps[0], w0, E, K, N);
  if (!err) err = encode(&maps[1], mode == kGated ? w1 : w0, E, K, N);
  if (!err) err = encode_out(&maps[2], out, rows_out, N);
  if (err) return err;
  if (mode == kGated)
    return launch<kGated>(maps, a, lda, a_rows, tile_start, G, group_div, K,
                          N, grid, stream);
  return launch<kPlain>(maps, a, lda, a_rows, tile_start, G, group_div, K, N,
                        grid, stream);
}

// out (n_tok, d) bf16 = each token's k rows of y (d bf16 each, contiguous)
// named by rows (n_tok, k) int32 (-1: none), weighted by bf16(gates) (fp32,
// (n_tok, k)) and summed in the given order; d a multiple of 8, k <= 8.
extern "C" int moe_combine(const void* y, const int* rows, const float* gates,
                           int k, void* out, int n_tok, int d,
                           cudaStream_t stream) {
  if (k < 1 || k > 8 || d < 8 || d % 8 || n_tok < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tok == 0) return 0;
  const int threads = d / 8 < 256 ? ((d / 8 + 31) / 32) * 32 : 256;
  moe_combine_kernel<8><<<n_tok, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y), rows, gates, k,
      static_cast<__nv_bfloat16*>(out), d);
  return static_cast<int>(cudaGetLastError());
}
