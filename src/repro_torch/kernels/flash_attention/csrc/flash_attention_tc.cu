// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 only:
// causal, sliding-window, logit-softcap, GQA and non-causal modes, head dim
// a multiple of 16 up to 256.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (body _flash_kernel) for bf16 inputs; fp32, and bf16 at shapes this kernel
// does not take, stay on the CUDA-core kernel in flash_attention.cu.  The
// LM's prefill runs it causal, with gemma2's 4096-token window on the local
// layers, softcap 50, 8 query heads over 4 kv heads of 256.
//
// What bounds it: at wave A's layer (B 4, S 4608, hd 256, causal) the
// products Q.K^T and P.V take 4 * hd flops per visible (query, key) pair,
// 3.48e11 flops per local layer, 0.35 ms at the 989 TFLOP/s of the bf16
// tensor cores; the 226 MB of q, k, v and o take 0.07 ms at 3.35 TB/s.  So
// the tensor cores bound it, and the design keeps them fed:
//   * both products on wgmma: S = Q.K^T as m64n64k16 with Q and K in shared
//     memory (K-major), fp32 accumulators; O += P.V as m64n64k16 per 64
//     columns of hd, P from registers (the fp32 S fragment rounded to bf16
//     pairs in place is the A-fragment layout) and V from shared memory as
//     a transposed (MN-major) operand;
//   * one block per (128-row query tile, query head, batch): a producer
//     warpgroup whose one thread issues TMA loads, and two consumer
//     warpgroups of 64 query rows each; setmaxnreg moves registers from the
//     producer (24) to the consumers (240), which hold O (hd/64 x 32 fp32)
//     and S (32 fp32) per thread;
//   * Q is loaded once per block; K and V tiles of 64 keys stream through a
//     two-stage ring with an mbarrier per stage for "K full", "V full" and
//     "empty".  Tensor maps are built on the host per call (the encoder
//     comes through cudaGetDriverEntryPoint, so no -lcuda) and passed as
//     __grid_constant__ parameters; every tile is 64 rows x 64 elements
//     (128 bytes) with the 128-byte swizzle that the wgmma descriptors
//     name, four such blocks across hd 256.  TMA fills rows past S, and
//     columns past hd when hd is not a multiple of 64, with zeros;
//   * softmax in fp32 on the accumulators: scores are scaled by hd^-0.5
//     after the product, soft-capped as cap * tanh(s / cap) with
//     tanh(y) = 1 - 2 / (2^(2y log2 e) + 1) on ex2.approx and rcp.approx,
//     each within an ulp or two (tanh.approx's 2^-11 would be 0.024 in a
//     score at the cap; this is ~1e-5), and log2 e folded into the
//     exponent of ex2.approx.  These special-function instructions and the
//     arithmetic around them, not the tensor cores, set the kernel's pace
//     at gemma2's shapes; an IEEE reciprocal (rcp.rn, a sequence of
//     instructions per score) in the cap was its largest single cost;
//   * masks (key < Sk, causal key <= query, window key > query - window)
//     are applied only on the key tiles where they cut some row of the
//     warpgroup; a tile that cuts all of them is skipped; a masked score is
//     -1e30 and its probability exactly 0, so a row with nothing visible
//     yet keeps m = -1e30, alpha = 1, l = 0 and no NaN;
//   * the block's query tile and key-tile range [lo, hi) come from a work
//     list computed in Python (kernel.py::work_list), longest first, so the
//     heaviest causal tiles start first; a row's keys are never split
//     across blocks, so the result does not depend on the schedule;
//   * the output acc / max(l, 1e-30) is rounded once to bf16, written into
//     the warpgroup's (now free) Q tile in the swizzled layout and stored
//     with TMA, which clips rows past Sq and columns past hd.
// Shared memory at hd 256: Q 64 KB + K and V 2 x 2 x 32 KB = 192 KB, one
// block per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // query rows per block
constexpr int kBN = 64;                  // keys per tile
constexpr int kStages = 2;               // K/V ring depth
constexpr int kThreads = 384;            // producer + two consumer warpgroups
constexpr uint32_t kSub = 64 * 128;      // one 64 x 64 bf16 swizzled block
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
// Spins until the phase of parity `parity` has completed.  A pipeline that
// has not completed after ~2^34 clocks (about 10 s) traps, an error the host
// sees, instead of hanging the card.
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

// -- TMA -----------------------------------------------------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
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
// K-major tile (rows of 128 bytes along the contraction): 8-row groups
// 1024 bytes apart; the leading offset is unused within one swizzle row.
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}
// MN-major tile (V: a row per key, 64 columns of hd along the row): 8-key
// groups 1024 bytes apart, 64-column blocks kSub apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return sw128_desc(addr, kSub, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define ACC32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REGS32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, fp32) = or += A (64 x 16, smem, K-major) . B (16 x 64, smem,
// K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64,
// smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's scores, in place: scaled, soft-capped, masked and moved to the
// log2 domain; returns nothing, leaves each row's max in mx[0..1].
// Thread layout of the 64 x 64 fragment: s[4j + e] is row
// `qa + 8 * (e >> 1)`, column `8j + cq + (e & 1)`.
template <bool kCap, bool kMask>
__device__ __forceinline__ void scores(float (&s)[32], float (&mx)[2],
                                       float c_in, float c_out, int k0,
                                       int cq, int qa, int Sk, int causal,
                                       int window) {
  mx[0] = mx[1] = kNeg;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * c_in;
      if (kCap) x = fmaf(-2.f * c_out, rcp_approx(ex2_approx(x) + 1.f), c_out);
      if (kMask) {
        const int kp = k0 + 8 * j + cq + (e & 1), qp = qa + 8 * (e >> 1);
        const bool ok = kp < Sk && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        x = ok ? x : kNeg;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const int* __restrict__ work, int pairs, int Hq, int rep,
                    int Sq, int Sk, int causal, int window, float softcap,
                    float scale) {
  constexpr int NC = HDP / 64;                  // 64-column blocks of hd
  constexpr uint32_t kTile = NC * kSub;         // one K or V tile
  constexpr uint32_t kQ = 2 * kTile;            // the block's 128 Q rows
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;    // swizzle blocks: 1 KB aligned
  uint8_t* const gQ = smem_raw + (sQ - raw);
  const uint32_t sK = sQ + kQ, sV = sK + kStages * kTile;
  const uint32_t bar = sV + kStages * kTile;    // q_full, then per stage:
  const uint32_t q_full = bar;                  // k_full, v_full, empty
#define K_FULL(s) (bar + 8 + 24 * (s))
#define V_FULL(s) (bar + 16 + 24 * (s))
#define EMPTY(s) (bar + 24 + 24 * (s))

  const int item = blockIdx.x / pairs, pair = blockIdx.x - item * pairs;
  const int b = pair / Hq, h = pair - b * Hq, hk = h / rep;
  const int q0 = work[3 * item] * kBM, kt_lo = work[3 * item + 1];
  const int nt = work[3 * item + 2] - kt_lo;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(K_FULL(s), 1);
      mbar_init(V_FULL(s), 1);
      mbar_init(EMPTY(s), 8);                   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread keeps the ring full -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, kQ);
      for (int g = 0; g < 2; ++g)
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + (g * NC + c) * kSub, &qmap, q_full, 64 * c, h,
                   q0 + 64 * g, b);
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages, k0 = (kt_lo + i) * kBN;
        if (i >= kStages) mbar_wait(EMPTY(s), (i / kStages - 1) & 1);
        mbar_expect_tx(K_FULL(s), kTile);
        for (int c = 0; c < NC; ++c)
          tma_load(sK + s * kTile + c * kSub, &kmap, K_FULL(s), 64 * c, hk,
                   k0, b);
        mbar_expect_tx(V_FULL(s), kTile);
        for (int c = 0; c < NC; ++c)
          tma_load(sV + s * kTile + c * kSub, &vmap, V_FULL(s), 64 * c, hk,
                   k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4 - 1, w = warp % 4;
    const int row0 = q0 + 64 * wg;                // the warpgroup's first row
    const int qa = row0 + 16 * w + lane / 4;      // this thread's rows: qa, qa+8
    const int cq = 2 * (lane % 4);
    const uint32_t sQw = sQ + wg * kTile;
    const bool capped = softcap > 0.f;
    // scores enter the exponent (or tanh's) with these factors
    const float c_in = capped ? scale * 2.f * kLog2e / softcap : scale * kLog2e;
    const float c_out = softcap * kLog2e;

    float o[NC][32], s[32], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < nt; ++i) {
      const int st = i % kStages, k0 = (kt_lo + i) * kBN;
      const uint32_t parity = (i / kStages) & 1;
      // does the tile cut none, some or all of this warpgroup's 64 rows?
      const bool hidden = k0 >= Sk || (causal && k0 > row0 + 63) ||
                          (window > 0 && k0 + kBN - 1 <= row0 - window);
      const bool edge = k0 + kBN > Sk || (causal && k0 + kBN - 1 > row0) ||
                        (window > 0 && k0 <= row0 + 63 - window);
      mbar_wait(K_FULL(st), parity);
      if (!hidden) {
        const uint32_t sKt = sK + st * kTile;
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(s, kmajor(sQw + c * kSub + 32 * kk),
                     kmajor(sKt + c * kSub + 32 * kk), c + kk > 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);

        float mx[2];
        if (capped) {
          if (edge) scores<true, true>(s, mx, c_in, c_out, k0, cq, qa, Sk,
                                       causal, window);
          else scores<true, false>(s, mx, c_in, c_out, k0, cq, qa, Sk,
                                   causal, window);
        } else {
          if (edge) scores<false, true>(s, mx, c_in, c_out, k0, cq, qa, Sk,
                                        causal, window);
          else scores<false, false>(s, mx, c_in, c_out, k0, cq, qa, Sk,
                                    causal, window);
        }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = ex2_approx(m[r] - m_new);  // 1 while nothing is visible
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = (j >> 1) & 1;
          float p = ex2_approx(s[j] - m[r]);
          if (edge) p = s[j] == kNeg ? 0.f : p;  // a row with nothing seen
          s[j] = p;
          sum[r] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 32; ++j) o[c][j] *= alpha[(j >> 1) & 1];

        // P in bf16 as wgmma's A fragments, 16 keys each
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

        mbar_wait(V_FULL(st), parity);
        const uint32_t sVt = sV + st * kTile;
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs(o[c], a[kk], mnmajor(sVt + c * kSub + kk * 16 * 128));
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      } else {
        mbar_wait(V_FULL(st), parity);            // the stage is read out
      }
      if (lane == 0) mbar_arrive(EMPTY(st));
    }

    // ---- epilogue: O / l in bf16 into this warpgroup's Q tile, then TMA --
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    uint8_t* const out = gQ + wg * kTile;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * w + lane / 4 + 8 * r;  // within the 64 rows
          const uint32_t off = c * kSub + row * 128 +
                               ((j ^ (row & 7)) << 4) + 4 * (lane % 4);
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_bf16(o[c][4 * j + 2 * r] * inv[r],
                        o[c][4 * j + 2 * r + 1] * inv[r]);
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (w == 0 && lane == 0 && row0 < Sq) {
      for (int c = 0; c < NC; ++c)
        tma_store(&omap, sQw + c * kSub, 64 * c, h, row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
#undef K_FULL
#undef V_FULL
#undef EMPTY
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

// A (B, S, H, hd) bf16 view as a 4-d tensor map of 64 x 64 boxes (64 rows
// of one head, 64 elements of hd), 128-byte swizzle, zero fill outside.
int encode(CUtensorMap* map, const void* ptr, int hd, int H, int S, int B,
           long long sb, long long ss, long long sh) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, kBN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int launch(const CUtensorMap* maps, const int* work, int n_work, int B,
           int Hq, int Hkv, int Sq, int Sk, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  constexpr int NC = HDP / 64;
  constexpr size_t smem = 1024 + (2 + 2 * kStages) * NC * kSub + 64;
  auto kern = flash_fwd_tc_kernel<HDP>;
  // setmaxnreg only moves registers within the block's allocation: the
  // consumers' 240 must come out of what the launch gives, or they wait
  // for ever
  static const bool enough = [kern] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kern) == cudaSuccess &&
           attr.numRegs * kThreads >= 24 * 128 + 240 * 256;
  }();
  if (!enough) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (long long)n_work * B * Hq;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], work, B * Hq, Hq, Hq / Hkv, Sq, Sk,
      causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o: (B, Sq, Hq, hd) bf16 views, k/v: (B, Sk, Hkv, hd) bf16 views, given by
// their (batch, seq, head) strides in elements (each a positive multiple of
// 8), unit stride over hd, base pointers 16-byte aligned; hd a multiple of 16
// up to 256; Hq a multiple of Hkv.  causal 0/1, window 0 for none, softcap 0
// for none.  `work` (device memory) holds n_work (query tile, first key
// tile, end key tile) triples in launch order, 128-row query tiles and
// 64-key tiles.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or the error that refused the arguments or a tensor map.
extern "C" int flash_attention_tc_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd,
    int causal, int window, float softcap,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, const int* work, int n_work, cudaStream_t stream) {
  if (hd < 16 || hd > 256 || hd % 16 || Sq < 1 || Sk < 1 || B < 1 ||
      Hq < 1 || Hkv < 1 || Hq % Hkv || window < 0 || softcap < 0.f ||
      n_work < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  int err = encode(&maps[0], q, hd, Hq, Sq, B, qsb, qss, qsh);
  if (!err) err = encode(&maps[1], k, hd, Hkv, Sk, B, ksb, kss, ksh);
  if (!err) err = encode(&maps[2], v, hd, Hkv, Sk, B, vsb, vss, vsh);
  if (!err) err = encode(&maps[3], o, hd, Hq, Sq, B, osb, oss, osh);
  if (err) return err;
  if (hd <= 64)
    return launch<64>(maps, work, n_work, B, Hq, Hkv, Sq, Sk, causal, window,
                      softcap, scale, stream);
  if (hd <= 128)
    return launch<128>(maps, work, n_work, B, Hq, Hkv, Sq, Sk, causal,
                       window, softcap, scale, stream);
  if (hd <= 192)
    return launch<192>(maps, work, n_work, B, Hq, Hkv, Sq, Sk, causal,
                       window, softcap, scale, stream);
  return launch<256>(maps, work, n_work, B, Hq, Hkv, Sq, Sk, causal, window,
                     softcap, scale, stream);
}
