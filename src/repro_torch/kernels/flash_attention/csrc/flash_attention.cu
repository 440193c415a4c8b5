// Flash-attention forward on Hopper's CUDA cores (sm_90a), register-tiled
// like an SGEMM: causal, sliding-window, logit-softcap, GQA/MQA and
// non-causal modes, fp32 or bf16 inputs, fp32 arithmetic, head dim 1-256.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (body _flash_kernel) for every call that neither the short-sequence
// kernel (S <= 32) nor the tensor-core kernel (bf16, hd % 16 == 0) takes:
// the DiT at any image size above 16 px (S = (image / patch)^2 + 1; 3137 at
// the paper's 224 px), the LM in fp32 (gemma2's 4608-token prefill in
// chip_smoke.py's 8c: causal, window 4096, softcap 50, 8 query heads over 4
// kv heads of 256) and bf16 at head dims the tensor cores do not take.
//
// What bounds it on the H100: operations.  Each (query, visible key) pair
// costs 2 * hd FMAs (Q.K and P.V); at the DiT's (4, 3137, 4, 32) that is 20
// GFLOP on 6.4 MB, at 8c's layer 86 GFLOP on 113 MB: 0.30 and 1.28 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores.  TF32 would break the
// 2e-5 fp32 gate, so the FMAs run on the CUDA cores and the design is
// about feeding them:
//   * one block of 256 threads per (batch, kv head, group of G query heads,
//     tile of P query positions), BM = G * P query rows a block (GQA: the
//     G heads share every staged K/V tile; G is the largest power of two
//     dividing Hq / Hkv, at most BM / 16), key tiles of BN keys.  Per head-
//     dim class HDP (16, 32, 48, 64, 96, 128, 256; columns past hd are
//     zeros) the tiles are (BM, BN) = (128, 64) up to 32, (128, 32) at 48
//     and 64, (64, 64) at 96 and 128, (64, 32) at 256 (Tiles below);
//   * S = Q.K^T as register micro-tiles: the 256 threads form 32 row
//     groups x 8 key groups, each thread owns SR = BM / 32 rows x SC = BN / 8
//     keys (4 x 8 at the DiT's HDP 32, 2 x 4 at 256) and reads q and k as
//     float4 along hd: SR + SC shared loads for 4 * SR * SC FMAs.  Rows and
//     keys are interleaved (row rg + 32 i, key cg + 8 j) and Q, K, V rows
//     are HDP + 4 floats apart, so a warp's reads (4 rows, 8 keys) are free
//     of bank conflicts;
//   * online softmax in the log2 domain: q is scaled by hd^-0.5 * log2(e)
//     once when staged, exponentials are ex2.approx, the soft cap is
//     cap' * tanh(s / cap') with cap' = cap * log2(e) (before the masks),
//     masks only on tiles that a mask can touch (the sequence end, the
//     causal diagonal, the window's edge): a masked score is -1e30 and its
//     probability exactly 0, and a row that sees no key is written as 0.
//     The row max is taken over the 8 threads of a row by 3 shuffles; each
//     thread keeps its part of the row sum, rescaled by the same alpha, and
//     the parts are added once at the end in a fixed order (no atomics: the
//     kernel is bit-equal to itself);
//   * P.V: P goes to shared memory key-major, alpha per row beside it; the
//     threads then form TRO row groups x TCO column groups, each owning RO
//     consecutive rows x 4 * CV columns of O in registers (4 x 4 at HDP 32,
//     8 x 8 at 256), reading P as float4 along rows and V as float4 along
//     hd: no shuffle per FMA;
//   * K and V tiles are double-buffered: tile j + 1 is in flight (cp.async,
//     16-byte chunks where hd, the strides and the base pointer are whole
//     chunks, else 4-byte copies; bf16 is loaded and converted through
//     registers) while tile j computes, K and V in separate groups so Q.K
//     starts while V arrives; two barriers a tile (K in and the last tile
//     done; P and V in);
//   * what was measured slower on the card and left out: P kept in
//     registers with each thread accumulating O over its own keys (one
//     barrier a tile, but 200-255 registers), 128 threads with 8 x 8 score
//     tiles (254 registers, 4 warps an SM), and other (BM, BN).  Shared-
//     memory loads per FMA and the warps an SM holds bound this design at
//     ~35-40% of the fp32 rate; the tensor cores (3xTF32) are the next
//     step;
//   * key tiles that no row of the block sees are skipped, and blocks are
//     numbered so the query tiles that see the most keys (the last ones
//     under a causal mask, the first ones under a window alone) start
//     first.
// q, k and v are read through (batch, seq, head) strides with a unit
// stride over hd, so the DiT's (B, S, 3, H, hd) QKV buffer needs no copy;
// o is a contiguous (B, Sq, Hq, hd).  Shared memory per block: 4 * (BM *
// (HDP + 4) + 4 * BN * (HDP + 4) + BN * (BM + 4) + 2 * BM) bytes, 88 KB at
// HDP 32 and 204 KB at 256; the attribute that allows it is set once per
// instance and device.  The launch geometry comes packed from kernel.py::
// cuda_core_geometry, which the tests replay block by block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// (BM query rows, BN keys) a tile, CV float4 columns of O a thread, and
// the blocks an SM should hold (the register budget: 65536 / (256 * MINB);
// at 64 two blocks' 128 registers spill)
template <int HDP> struct Tiles;
template <> struct Tiles<16> {
  static constexpr int BM = 128, BN = 64, CV = 1, MINB = 2;
};
template <> struct Tiles<32> {
  static constexpr int BM = 128, BN = 64, CV = 1, MINB = 2;
};
template <> struct Tiles<48> {
  static constexpr int BM = 128, BN = 32, CV = 3, MINB = 2;
};
template <> struct Tiles<64> {
  static constexpr int BM = 128, BN = 32, CV = 2, MINB = 1;
};
template <> struct Tiles<96> {
  static constexpr int BM = 64, BN = 64, CV = 3, MINB = 1;
};
template <> struct Tiles<128> {
  static constexpr int BM = 64, BN = 64, CV = 2, MINB = 1;
};
template <> struct Tiles<256> {
  static constexpr int BM = 64, BN = 32, CV = 2, MINB = 1;
};

template <int HDP>
struct Shape {
  static constexpr int BM = Tiles<HDP>::BM, BN = Tiles<HDP>::BN;
  static constexpr int CV = Tiles<HDP>::CV;
  static constexpr int LD = HDP + 4;        // Q, K, V rows in shared memory
  static constexpr int PLD = BM + 4;        // P^T rows (one per key)
  static constexpr int NRG = kThreads / 8;  // S-phase row groups: 32
  static constexpr int SR = BM / NRG, SC = BN / 8;
  static constexpr int TCO = HDP / (4 * CV), TRO = kThreads / TCO;
  static constexpr int RO = BM / TRO;
  static constexpr int UD = HDP <= 64 ? 4 : 8;      // Q.K's unroll over hd
  static constexpr size_t SMEM =
      4 * (size_t)(BM * LD + 4 * BN * LD + BN * PLD + 2 * BM);
  static constexpr int MIN_BLOCKS = Tiles<HDP>::MINB;
  static_assert(TCO * TRO == kThreads && RO * TRO == BM && SR * NRG == BM,
                "tiling");
  static_assert(RO == 1 || RO == 2 || RO % 4 == 0, "P reads");
  static_assert(SMEM <= 232448, "shared memory");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int B, Hq, Hkv, Sq, Sk, hd, rep, causal, window;
  int G, plog, n_pt, ng;            // heads a block, log2 of positions a block
  int vec_q, vec_k, vec_v;
  float scale2, cap2, inv_cap2;     // hd^-0.5 * log2(e); softcap * log2(e)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes (or 4) from global src to shared dst, asynchronously; zero-filled
// and src not read when `in` is false
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
// 2^x (ex2.approx: 2 ulp; 0 for x below -126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) of a tile into dst[r * (HDP + 4) + c], c < HDP, as fp32;
// row(r) is the row's first element, or nullptr past the sequence; columns
// hd..HDP-1 and absent rows are zeros.  fp32 goes by cp.async (the caller
// commits and waits); bf16 through registers, times `mul`.
template <typename T, int HDP, int R, typename RowFn>
__device__ __forceinline__ void stage(float* dst, RowFn row, int hd,
                                      bool vec, const T* any, float mul) {
  constexpr int LD = HDP + 4;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int NC = HDP / 4;
      for (int i = threadIdx.x; i < R * NC; i += kThreads) {
        const int r = i / NC, c = (i - r * NC) * 4;
        const T* src = row(r);
        const bool in = src != nullptr && c < hd;
        cp_async16(dst + r * LD + c, in ? src + c : any, in);
      }
    } else {
      for (int i = threadIdx.x; i < R * HDP; i += kThreads) {
        const int r = i / HDP, c = i - r * HDP;
        const T* src = row(r);
        const bool in = src != nullptr && c < hd;
        cp_async4(dst + r * LD + c, in ? src + c : any, in);
      }
    }
  } else {
    if (vec) {
      constexpr int NC = HDP / 8;
      for (int i = threadIdx.x; i < R * NC; i += kThreads) {
        const int r = i / NC, c = (i - r * NC) * 8;
        const T* src = row(r);
        float f[8];
        if (src != nullptr && c < hd) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + c));
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 t = __bfloat1622float2(h[e]);
            f[2 * e] = t.x * mul;
            f[2 * e + 1] = t.y * mul;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = 0.f;
        }
        float4* d4 = reinterpret_cast<float4*>(dst + r * LD + c);
        d4[0] = make_float4(f[0], f[1], f[2], f[3]);
        d4[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    } else {
      for (int i = threadIdx.x; i < R * HDP; i += kThreads) {
        const int r = i / HDP, c = i - r * HDP;
        const T* src = row(r);
        dst[r * LD + c] = src != nullptr && c < hd ? to_f32(src[c]) * mul
                                                   : 0.f;
      }
    }
  }
}

// fp32 rows staged by cp.async, times `mul`, each element by the thread
// that copied it (after its copies completed), so no barrier is needed
template <int HDP, int R>
__device__ __forceinline__ void scale_own(float* dst, bool vec, float mul) {
  constexpr int LD = HDP + 4;
  if (vec) {
    constexpr int NC = HDP / 4;
    for (int i = threadIdx.x; i < R * NC; i += kThreads) {
      const int r = i / NC, c = (i - r * NC) * 4;
      float4* x = reinterpret_cast<float4*>(dst + r * LD + c);
      const float4 y = *x;
      *x = make_float4(y.x * mul, y.y * mul, y.z * mul, y.w * mul);
    }
  } else {
    for (int i = threadIdx.x; i < R * HDP; i += kThreads) {
      const int r = i / HDP, c = i - r * HDP;
      dst[r * LD + c] *= mul;
    }
  }
}

// 4 values of a row of o from column c (a multiple of 4), those < hd
__device__ __forceinline__ void store4(float* row, int c, int hd,
                                       const float* y) {
  if ((hd & 3) == 0) {
    if (c < hd)
      *reinterpret_cast<float4*>(row + c) = make_float4(y[0], y[1], y[2],
                                                        y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < hd) row[c + e] = y[e];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* row, int c, int hd,
                                       const float* y) {
  if ((hd & 3) == 0) {
    if (c < hd) {
      uint2 x;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
      h[0] = __floats2bfloat162_rn(y[0], y[1]);
      h[1] = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(row + c) = x;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < hd) row[c + e] = __float2bfloat16_rn(y[e]);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, Shape<HDP>::MIN_BLOCKS)
flash_fwd_kernel(const Params p) {
  using S = Shape<HDP>;
  constexpr int BM = S::BM, BN = S::BN, LD = S::LD, PLD = S::PLD;
  constexpr int SR = S::SR, SC = S::SC, CV = S::CV, TCO = S::TCO;
  constexpr int NRG = S::NRG;
  constexpr int RO = S::RO;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* sK = sQ + BM * LD;                     // [2][BN][LD]
  float* sV = sK + 2 * BN * LD;                 // [2][BN][LD]
  float* sP = sV + 2 * BN * LD;                 // [BN][PLD]: P, key-major
  float* sA = sP + BN * PLD;                    // [BM]: this tile's alpha
  float* sL = sA + BM;                          // [BM]: the row sums

  // the block's work, heaviest query tiles first: blockIdx.x = rank * nbh
  // + (b, kv head, head group), position tile n_pt - 1 - rank under a
  // causal mask (the last positions see the most keys), else rank (a
  // window leaves the first positions the most)
  const int nbh = p.B * p.Hkv * p.ng;
  const int rank = blockIdx.x / nbh, bh = blockIdx.x - rank * nbh;
  const int b = bh / (p.Hkv * p.ng);
  const int hk = (bh / p.ng) % p.Hkv;
  const int gi = bh % p.ng;
  const int P = 1 << p.plog, pmask = P - 1;
  const int q0 = (p.causal ? p.n_pt - 1 - rank : rank) * P;  // first position
  const int h0 = hk * p.rep + gi * p.G;       // first query head
  const int pos_hi = min(q0 + P, p.Sq) - 1;   // last query position
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  // the key tiles some row of the block sees
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Sk, pos_hi + 1) : p.Sk;
  const int kt0 = lo / BN;
  const int nt = hi > lo ? (hi + BN - 1) / BN - kt0 : 0;

  // row r of the block: query head h0 + r / P at position q0 + r % P
  auto qrow = [&](int r) -> const T* {
    const int pos = q0 + (r & pmask);
    return pos < p.Sq ? qb + pos * p.qss + (h0 + (r >> p.plog)) * p.qsh
                      : nullptr;
  };
  auto stage_kv = [&](int tile, int buf) {
    const int k0 = tile * BN;
    stage<T, HDP, BN>(
        sK + buf * BN * LD,
        [&](int r) -> const T* {
          return k0 + r < p.Sk ? kb + (k0 + r) * p.kss : nullptr;
        },
        p.hd, p.vec_k, kb, 1.f);
    commit();
    stage<T, HDP, BN>(
        sV + buf * BN * LD,
        [&](int r) -> const T* {
          return k0 + r < p.Sk ? vb + (k0 + r) * p.vss : nullptr;
        },
        p.hd, p.vec_v, vb, 1.f);
    commit();
  };

  stage<T, HDP, BM>(sQ, qrow, p.hd, p.vec_q, qb, p.scale2);
  commit();
  if (nt > 0) {
    stage_kv(kt0, 0);
  } else {
    commit();
    commit();
  }
  wait_groups<2>();                             // this thread's q is in
  if constexpr (std::is_same<T, float>::value)
    scale_own<HDP, BM>(sQ, p.vec_q, p.scale2);

  const int tid = threadIdx.x, lane = tid & 31;
  // S-phase: NRG row groups x 8 key groups, a warp 4 x 8
  const int cg = lane & 7, rg = (tid >> 5) * 4 + (lane >> 3);
  // O-phase: TRO row groups x TCO column groups
  const int tc = tid % TCO, tr = tid / TCO;

  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  // O: rows tr * RO + i, columns tc * 4 + 4 * TCO * u
  float acc[RO][4 * CV];
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int e = 0; e < 4 * CV; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const int k0 = (kt0 + t) * BN;
    const float* Kt = sK + (t & 1) * BN * LD;
    const float* Vt = sV + (t & 1) * BN * LD;
    wait_groups<1>();                           // K of tile t is in
    __syncthreads();                            // and tile t - 1 is done
    if (t + 1 < nt) {
      stage_kv(kt0 + t + 1, (t + 1) & 1);       // in flight during tile t
    } else {
      commit();
      commit();
    }

    // S = Q K^T: rows rg + NRG i, keys cg + 8 j
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
    const float* qp = sQ + rg * LD;
    const float* kp = Kt + cg * LD;
#pragma unroll(S::UD)
    for (int d = 0; d < HDP; d += 4) {
      float4 a[SR], c[SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
        a[i] = *reinterpret_cast<const float4*>(qp + i * NRG * LD + d);
#pragma unroll
      for (int j = 0; j < SC; ++j)
        c[j] = *reinterpret_cast<const float4*>(kp + j * 8 * LD + d);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // soft cap, masks, online softmax: s becomes P, alpha per row
    const bool edge = k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > q0) ||
                      (p.window > 0 && k0 < pos_hi - p.window + 1);
    float alpha[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int pos = q0 + ((rg + NRG * i) & pmask);
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float x = s[i][j];
        if (p.cap2 > 0.f) x = p.cap2 * tanhf(x * p.inv_cap2);
        if (edge) {
          const int key = k0 + cg + 8 * j;
          const bool ok = key < p.Sk && (!p.causal || key <= pos) &&
                          (p.window <= 0 || key > pos - p.window);
          x = ok ? x : kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = exp2_approx(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = s[i][j] > 0.5f * kNeg ? exp2_approx(s[i][j] - mn) : 0.f;
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha[i], sum);
    }

    // P^T and alpha through shared memory, then O = alpha O + P V
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = rg + NRG * i;
#pragma unroll
      for (int j = 0; j < SC; ++j) sP[(cg + 8 * j) * PLD + r] = s[i][j];
      if (cg == 0) sA[r] = alpha[i];
    }
    wait_groups<2>();                           // V of tile t is in
    __syncthreads();
    const float* pp = sP + tr * RO;
    const float* vp = Vt + tc * 4;
#pragma unroll
    for (int i = 0; i < RO; ++i) {
      const float a = sA[tr * RO + i];
#pragma unroll
      for (int e = 0; e < 4 * CV; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      float pr[RO];
      if constexpr (RO % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RO; i += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(pp + j * PLD + i);
          pr[i] = x.x;
          pr[i + 1] = x.y;
          pr[i + 2] = x.z;
          pr[i + 3] = x.w;
        }
      } else if constexpr (RO == 2) {
        const float2 x = *reinterpret_cast<const float2*>(pp + j * PLD);
        pr[0] = x.x;
        pr[1] = x.y;
      } else {
        pr[0] = pp[j * PLD];
      }
#pragma unroll
      for (int u = 0; u < CV; ++u) {
        const float4 x =
            *reinterpret_cast<const float4*>(vp + j * LD + 4 * TCO * u);
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          acc[i][4 * u] = fmaf(pr[i], x.x, acc[i][4 * u]);
          acc[i][4 * u + 1] = fmaf(pr[i], x.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(pr[i], x.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(pr[i], x.w, acc[i][4 * u + 3]);
        }
      }
    }
  }

  // the row sums, over the 8 key groups of each row in a fixed order
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float x = l[i];
    x += __shfl_xor_sync(kFull, x, 1);
    x += __shfl_xor_sync(kFull, x, 2);
    x += __shfl_xor_sync(kFull, x, 4);
    l[i] = x;
  }
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < SR; ++i)
    if (cg == 0) sL[rg + NRG * i] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int r = tr * RO + i;
    const int pos = q0 + (r & pmask);
    if (pos >= p.Sq) continue;
    const float sum = sL[r];
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    T* orow = o + (((long long)b * p.Sq + pos) * p.Hq + h0 + (r >> p.plog)) *
                      p.hd;
#pragma unroll
    for (int u = 0; u < CV; ++u) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = acc[i][4 * u + e] * inv;
      store4(orow, tc * 4 + 4 * TCO * u, p.hd, y);
    }
  }
}

typedef void (*KernelFn)(const Params);

constexpr int kClasses[] = {16, 32, 48, 64, 96, 128, 256};
constexpr int kNumClasses = 7;

int class_index(int hdp) {
  for (int i = 0; i < kNumClasses; ++i)
    if (kClasses[i] == hdp) return i;
  return -1;
}

int hd_class(int hd) {
  for (int i = 0; i < kNumClasses; ++i)
    if (hd <= kClasses[i]) return kClasses[i];
  return -1;
}

template <typename T>
KernelFn pick(int hdp) {
  switch (hdp) {
    case 16: return flash_fwd_kernel<T, 16>;
    case 32: return flash_fwd_kernel<T, 32>;
    case 48: return flash_fwd_kernel<T, 48>;
    case 64: return flash_fwd_kernel<T, 64>;
    case 96: return flash_fwd_kernel<T, 96>;
    case 128: return flash_fwd_kernel<T, 128>;
    case 256: return flash_fwd_kernel<T, 256>;
    default: return nullptr;
  }
}

template <int HDP>
constexpr long long tiles_of(int what) {
  return what == 0 ? Shape<HDP>::BM
                   : what == 1 ? Shape<HDP>::BN : (long long)Shape<HDP>::SMEM;
}

// BM, BN or shared bytes (what 0, 1, 2) of class hdp
long long tiles(int hdp, int what) {
  switch (hdp) {
    case 16: return tiles_of<16>(what);
    case 32: return tiles_of<32>(what);
    case 48: return tiles_of<48>(what);
    case 64: return tiles_of<64>(what);
    case 96: return tiles_of<96>(what);
    case 128: return tiles_of<128>(what);
    case 256: return tiles_of<256>(what);
    default: return -1;
  }
}

// Runs on device `dev`, restoring the caller's current device.
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int dev) {
    cudaGetDevice(&prev);
    if (prev != dev) cudaSetDevice(dev);
  }
  ~OnDevice() {
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != prev) cudaSetDevice(prev);
  }
};

// cudaFuncSetAttribute for fn's shared memory, once per instance and
// device (slot: the instance's index; a bit a device)
std::atomic<unsigned long long> g_smem_set[2 * kNumClasses];

template <typename Fn>
int allow_smem(Fn fn, int slot, int dev, size_t bytes) {
  const unsigned long long bit = 1ull << (dev & 63);
  if (g_smem_set[slot].load() & bit) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  g_smem_set[slot].fetch_or(bit);
  return 0;
}

// g: dtype (0 fp32, 1 bf16), B, Hq, Hkv, Sq, Sk, hd, causal, window, the
// (batch, seq, head) strides of q, k and v in elements, whether q, k and v
// are staged 16 bytes at a time, HDP, G, blocks, shared bytes, device.
bool geometry_ok(const long long* g) {
  const long long B = g[1], Hq = g[2], Hkv = g[3], Sq = g[4], Sk = g[5];
  const long long hd = g[6], hdp = g[21], G = g[22];
  if (!(g[0] == 0 || g[0] == 1) || B < 1 || Hq < 1 || Hkv < 1 ||
      Hq % Hkv != 0 || Sq < 1 || Sk < 1 || hd < 1 || hd > kMaxHd ||
      g[8] < 0 || Sq >= (1ll << 30) || Sk >= (1ll << 30) ||
      hdp != hd_class((int)hd))
    return false;
  const long long BM = tiles((int)hdp, 0), rep = Hq / Hkv;
  if (G < 1 || (G & (G - 1)) != 0 || rep % G != 0 || 16 * G > BM)
    return false;
  const long long P = BM / G, n_pt = (Sq + P - 1) / P;
  return g[23] == n_pt * B * Hkv * (rep / G) && g[23] < (1ll << 31) &&
         g[24] == tiles((int)hdp, 2);
}

// An input read 16 bytes at a time (g[flag]) has hd, its strides
// g[st..st+2] and its base pointer in whole 16-byte chunks.
bool chunks_ok(const long long* g, int flag, const void* ptr, int st) {
  const long long n = g[0] == 0 ? 4 : 8;
  return !g[flag] || (g[6] % n == 0 && g[st] % n == 0 && g[st + 1] % n == 0 &&
                      g[st + 2] % n == 0 &&
                      reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
}

int log2_of(long long x) {
  int n = 0;
  while ((1ll << n) < x) ++n;
  return n;
}

}  // namespace

// q: (B, Sq, Hq, hd) view, k/v: (B, Sk, Hkv, hd) views of one type with a
// unit stride over hd; o: a contiguous (B, Sq, Hq, hd) of that type; g as
// in geometry_ok.  softcap 0 for none; scale hd^-0.5.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* g, float softcap,
                                   float scale, cudaStream_t stream) {
  if (!geometry_ok(g) || softcap < 0.f || !chunks_ok(g, 18, q, 9) ||
      !chunks_ok(g, 19, k, 12) || !chunks_ok(g, 20, v, 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hdp = (int)g[21], dt = (int)g[0];
  const KernelFn fn = dt == 0 ? pick<float>(hdp) : pick<__nv_bfloat16>(hdp);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qsb = g[9], p.qss = g[10], p.qsh = g[11];
  p.ksb = g[12], p.kss = g[13], p.ksh = g[14];
  p.vsb = g[15], p.vss = g[16], p.vsh = g[17];
  p.B = g[1], p.Hq = g[2], p.Hkv = g[3], p.Sq = g[4], p.Sk = g[5];
  p.hd = g[6];
  p.rep = g[2] / g[3];
  p.causal = g[7] != 0;
  p.window = g[8];
  p.G = g[22];
  p.plog = log2_of(tiles(hdp, 0) / g[22]);
  p.n_pt = (p.Sq + (1 << p.plog) - 1) >> p.plog;
  p.ng = p.rep / p.G;
  p.vec_q = g[18] != 0, p.vec_k = g[19] != 0, p.vec_v = g[20] != 0;
  p.scale2 = scale * kLog2e;
  p.cap2 = softcap * kLog2e;
  p.inv_cap2 = softcap > 0.f ? 1.f / p.cap2 : 0.f;
  OnDevice on((int)g[25]);
  const int err = allow_smem(fn, dt * kNumClasses + class_index(hdp),
                             (int)g[25], (size_t)g[24]);
  if (err != 0) return err;
  fn<<<(unsigned)g[23], kThreads, (size_t)g[24], stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the instance (dtype 0 fp32 / 1 bf16, head-dim class
// hdp) fit on one SM of device `dev` at once (the occupancy calculator),
// or -1.
extern "C" int flash_attention_occupancy(int dtype, int hdp, int dev) {
  if ((dtype != 0 && dtype != 1) || class_index(hdp) < 0) return -1;
  const KernelFn fn = dtype == 0 ? pick<float>(hdp)
                                 : pick<__nv_bfloat16>(hdp);
  OnDevice on(dev);
  const size_t smem = (size_t)tiles(hdp, 2);
  if (allow_smem(fn, dtype * kNumClasses + class_index(hdp), dev, smem) != 0)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}
