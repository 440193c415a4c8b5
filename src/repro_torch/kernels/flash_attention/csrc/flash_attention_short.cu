// Attention at short sequences (Sq, Sk <= 32, head dim <= 64) for Hopper
// (sm_90a): one exact pass with every key on chip, in every mode of the
// reference (non-causal, causal, sliding window, logit softcap, GQA), fp32
// or bf16 inputs, fp32 arithmetic.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (body _flash_kernel) at the shapes kernel.py::short_seq_route accepts.  The
// DiT runs it non-causal over S = n_tok + 1 = 17 tokens in fp32, with q, k
// and v as views of its (B, S, 3, H, hd) QKV buffer: (256, 17, 4, 36) at the
// paper preset, 3000 launches per uniform D_syn round.
//
// What bounds it on the H100: device-memory bytes.  At the preset each batch
// element reads 17 x 3 x 4 x 36 fp32 = 29.4 KB of q, k and v and writes
// 9.8 KB of o, 10 MB a call, 3.0 us at 3.35 TB/s; its ~4 S^2 hd = 42 kflop
// per head are nothing against that.  A block has so little work that the
// launch and one chain of memory latencies (load, barrier, compute, store)
// set its time; the design shortens that chain:
//   * one block per (batch element, group of hb query heads; hb = Hq = 4 at
//     the preset): it stages q, k and v of its heads into shared memory as
//     fp32 once, 16 bytes at a time wherever the view's strides and base
//     pointer allow (the DiT's QKV slab does), walking (row, head, chunk)
//     with incremental carries instead of an integer division per element.
//     fp32 chunks go by cp.async, so each thread has all of its copies in
//     flight at once; q and k form one group and v a second, so Q.K starts
//     while V is still arriving.  Query head h reads kv head h / (Hq / Hkv)
//     (GQA); the block stages the kv heads its query heads need;
//   * one warp per query head and one lane per query row: lane i holds its
//     q row, scaled by hd^-0.5, in registers and scores key j against the K
//     row that all lanes read at once (a shared-memory broadcast, float4 at
//     a time), four keys in flight (the key loops unrolled by 4);
//   * exact softmax inside the thread: the scores of the row go to a
//     per-warp scratch in shared memory (lane-contiguous, no bank conflict),
//     then max, expf and sum over them; no online rescale, no shuffle;
//   * masks and the soft cap cost one compare or one tanhf per score: the
//     cap cap * tanh(s / cap) on the scaled score, then key <= query
//     (causal) and key > query - window (window); a masked score has
//     probability exactly 0, and a row that sees no key is written as 0;
//   * P.V accumulates into hd fp32 registers per lane against V rows read
//     as broadcasts; the output acc / l is staged through shared memory
//     (reusing q's space) and stored as contiguous (S, H * hd) rows, the
//     layout the output projection reads, 16 bytes at a time, rounded to
//     the input type (__float2bfloat16_rn for bf16).
// Two designs that move fewer bytes from shared memory to registers per FMA
// measured slower on the card, in the same calls as this one: up to 4
// query rows per lane with 4 heads to a warp and the keys and columns split
// over 2 warps (fewer warps, each with a longer chain), and two warps per
// head splitting keys and columns at one row per lane (level).  So the
// compute is not bound by that traffic; chip_smoke.py times this kernel
// beside an empty kernel and this kernel without its compute
// (flash_attention_short_memory_only) at the same launch.
// Head dims are a template parameter rounded up to a multiple of 4
// (padding columns staged as zeros), so q and the accumulators stay in
// registers.  Shared memory per block: 4 * HDP * (hb * Sq + 2 * nkv * Sk)
// bytes of q, k and v plus 4 * 32 * Sk per warp of scores, at most 48 KB
// (kernel.py::short_geometry chooses hb); 38080 bytes at the preset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 32;        // one query row per lane, every key on chip
constexpr int kMaxHd = 64;
constexpr int kMaxWarps = 8;     // 256 threads: up to 255 registers
constexpr int kMaxSmem = 48 * 1024;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int Hq, Sq, Sk, hd, rep, hb, nkv_max, causal, window;
  int vec_q, vec_k, vec_v;
  int compute;                     // 0: stage and store only (a measurement)
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T at p (16-byte aligned) into dst (16-byte aligned shared
// memory) as fp32: fp32 by cp.async, which needs no register and lets a
// thread keep all its copies in flight at once (completed by
// cp.async.wait_group); bf16 through registers, converted
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(p)
               : "memory");
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(h[i]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0].x, f[0].y, f[1].x,
                                                  f[1].y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[2].x, f[2].y, f[3].x,
                                                  f[3].y);
}

// 16 bytes of fp32 from src (shared) rounded to T at p (16-byte aligned)
__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* src) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = x;
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Walks i = threadIdx.x, + blockDim.x, ... over a (rows, heads, cols) grid
// in row-major order, carrying (row, head, col) from step to step: one
// division per thread, none per element.
struct Walk {
  int row, head, col, drow, dhead, dcol, heads, cols;
  __device__ Walk(int heads_, int cols_) : heads(heads_), cols(cols_) {
    const int t = threadIdx.x, n = blockDim.x;
    col = t % cols;
    head = (t / cols) % heads;
    row = t / cols / heads;
    dcol = n % cols;
    dhead = (n / cols) % heads;
    drow = n / cols / heads;
  }
  __device__ __forceinline__ void next() {
    col += dcol;
    int carry = col >= cols;
    col -= carry ? cols : 0;
    head += dhead + carry;
    carry = head >= heads;
    head -= carry ? heads : 0;
    row += drow + carry;
  }
};

// Rows [0, S) x heads [0, nh) of a (S, H, hd) view at base (the block's
// batch element and first head) into dst[head][row][HDP] as fp32; columns
// hd..HDP-1 are zeros.  vec: hd, the strides and base are whole 16-byte
// chunks.  The caller completes the copies (cp.async.wait_group) and syncs.
template <typename T, int HDP>
__device__ __forceinline__ void stage(const T* base, long long ss,
                                      long long sh, int S, int nh, int hd,
                                      bool vec, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    Walk w(nh, hd / kVec);
    for (; w.row < S; w.next())      // hd is a multiple of 4: HDP == hd
      load16(base + w.row * ss + w.head * sh + w.col * kVec,
             dst + (w.head * S + w.row) * HDP + w.col * kVec);
  } else {
    Walk w(nh, HDP);
    for (; w.row < S; w.next())
      dst[(w.head * S + w.row) * HDP + w.col] =
          w.col < hd ? to_f32(base[w.row * ss + w.head * sh + w.col]) : 0.f;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kMaxWarps * 32)
short_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int h0 = blockIdx.x * p.hb;
  const int nh = min(p.hb, p.Hq - h0);             // this block's query heads
  const int kv0 = h0 / p.rep;
  const int nkv = (h0 + nh - 1) / p.rep - kv0 + 1;  // kv heads they read
  const int Sq = p.Sq, Sk = p.Sk, hd = p.hd;
  float* sq = smem;                                // [hb][Sq][HDP], then O
  float* sk = sq + p.hb * Sq * HDP;                // [nkv_max][Sk][HDP]
  float* sv = sk + p.nkv_max * Sk * HDP;
  float* ss = sv + p.nkv_max * Sk * HDP;           // [warp][Sk][32] scores

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  stage<T, HDP>(q + b * p.qsb + h0 * p.qsh, p.qss, p.qsh, Sq, nh, hd,
                p.vec_q, sq);
  stage<T, HDP>(k + b * p.ksb + kv0 * p.ksh, p.kss, p.ksh, Sk, nkv, hd,
                p.vec_k, sk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage<T, HDP>(v + b * p.vsb + kv0 * p.vsh, p.vss, p.vsh, Sk, nkv, hd,
                p.vec_v, sv);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool busy = p.compute && warp < nh && lane < Sq;
  float acc[HDP];
  float inv = 0.f;
  float m = kNeg;
  const int kvh = (h0 + min(warp, nh - 1)) / p.rep - kv0;
  const float* vb = sv + kvh * Sk * HDP;
  float* sc = ss + warp * Sk * 32 + lane;
  if (busy) {                          // lanes past Sq idle
    const float* qrow = sq + (warp * Sq + lane) * HDP;
    float qr[HDP];
#pragma unroll
    for (int c = 0; c < HDP; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qrow + c);
      qr[c] = x.x * p.scale;
      qr[c + 1] = x.y * p.scale;
      qr[c + 2] = x.z * p.scale;
      qr[c + 3] = x.w * p.scale;
    }
    const float* kb = sk + kvh * Sk * HDP;
#pragma unroll 4
    for (int j = 0; j < Sk; ++j) {
      const float* kr = kb + j * HDP;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < HDP; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(kr + c);
        a0 = fmaf(qr[c], x.x, a0);
        a1 = fmaf(qr[c + 1], x.y, a1);
        a2 = fmaf(qr[c + 2], x.z, a2);
        a3 = fmaf(qr[c + 3], x.w, a3);
      }
      float s = (a0 + a1) + (a2 + a3);
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      const bool ok = (!p.causal || j <= lane) &&
                      (p.window <= 0 || j > lane - p.window);
      s = ok ? s : kNeg;
      sc[j * 32] = s;
      m = fmaxf(m, s);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();                     // V is in
  if (busy) {
#pragma unroll
    for (int c = 0; c < HDP; ++c) acc[c] = 0.f;
    float l = 0.f;
#pragma unroll 4
    for (int j = 0; j < Sk; ++j) {
      const float s = sc[j * 32];
      const float pj = s > 0.5f * kNeg ? expf(s - m) : 0.f;
      l += pj;
      const float* vr = vb + j * HDP;
#pragma unroll
      for (int c = 0; c < HDP; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(vr + c);
        acc[c] = fmaf(pj, x.x, acc[c]);
        acc[c + 1] = fmaf(pj, x.y, acc[c + 1]);
        acc[c + 2] = fmaf(pj, x.z, acc[c + 2]);
        acc[c + 3] = fmaf(pj, x.w, acc[c + 3]);
      }
    }
    inv = l > 0.f ? 1.f / l : 0.f;
  }
  __syncthreads();                                 // every q row is read
  if (busy) {
    float* orow = sq + (warp * Sq + lane) * HDP;
#pragma unroll
    for (int c = 0; c < HDP; c += 4)
      *reinterpret_cast<float4*>(orow + c) =
          make_float4(acc[c] * inv, acc[c + 1] * inv, acc[c + 2] * inv,
                      acc[c + 3] * inv);
  }
  __syncthreads();

  // o is a contiguous (B, Sq, Hq, hd): row s of this block's heads is the
  // span o[b, s, h0:h0 + nh, :]
  T* o = static_cast<T*>(p.o) + ((long long)b * Sq * p.Hq + h0) * hd;
  constexpr int kVec = 16 / sizeof(T);
  if (hd % kVec == 0) {
    for (Walk w(nh, hd / kVec); w.row < Sq; w.next())
      store16(o + (w.row * p.Hq + w.head) * hd + w.col * kVec,
              sq + (w.head * Sq + w.row) * HDP + w.col * kVec);
  } else {
    for (Walk w(nh, hd); w.row < Sq; w.next())
      store1(o + (w.row * p.Hq + w.head) * hd + w.col,
             sq[(w.head * Sq + w.row) * HDP + w.col]);
  }
}

typedef void (*KernelFn)(const Params);

template <typename T, int... HDPs>
struct Table {
  static KernelFn get(int hdp) {
    KernelFn fns[] = {short_fwd_kernel<T, HDPs>...};
    return fns[hdp / 4 - 1];
  }
};

using Fp32Table = Table<float, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48,
                        52, 56, 60, 64>;
using Bf16Table = Table<__nv_bfloat16, 4, 8, 12, 16, 20, 24, 28, 32, 36, 40,
                        44, 48, 52, 56, 60, 64>;

// The launch geometry: g[21..23] = hb, nkv_max, shared bytes.
bool geometry_ok(const long long* g) {
  const long long Hq = g[2], Hkv = g[3], Sq = g[4], Sk = g[5], hd = g[6];
  const long long hb = g[21], nkv = g[22], smem = g[23];
  const long long hdp = (hd + 3) / 4 * 4;
  return g[1] >= 1 && g[1] <= 65535 && Hq >= 1 && Hkv >= 1 && Hq % Hkv == 0 &&
         Sq >= 1 && Sq <= kMaxS && Sk >= 1 && Sk <= kMaxS && hd >= 1 &&
         hd <= kMaxHd && g[8] >= 0 && hb >= 1 && hb <= kMaxWarps &&
         nkv >= 1 && nkv <= hb &&
         smem == 4 * (hdp * (hb * Sq + 2 * nkv * Sk) + hb * Sk * 32) &&
         smem <= kMaxSmem && (g[0] == 0 || g[0] == 1);
}

// An input read 16 bytes at a time (g[flag]) has hd, its strides
// g[st..st+2] and its base pointer in whole 16-byte chunks.
bool chunks_ok(const long long* g, int flag, const void* ptr, int st) {
  const long long n = g[0] == 0 ? 4 : 8;
  return !g[flag] || (g[6] % n == 0 && g[st] % n == 0 && g[st + 1] % n == 0 &&
                      g[st + 2] % n == 0 &&
                      reinterpret_cast<uintptr_t>(ptr) % 16 == 0);
}

// Runs on the device g[24], restoring the caller's current device.
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

int launch(const void* q, const void* k, const void* v, void* o,
           const long long* g, float softcap, float scale,
           cudaStream_t stream, int compute) {
  if (!geometry_ok(g) || softcap < 0.f || !chunks_ok(g, 18, q, 9) ||
      !chunks_ok(g, 19, k, 12) || !chunks_ok(g, 20, v, 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qsb = g[9], p.qss = g[10], p.qsh = g[11];
  p.ksb = g[12], p.kss = g[13], p.ksh = g[14];
  p.vsb = g[15], p.vss = g[16], p.vsh = g[17];
  p.Hq = g[2], p.Sq = g[4], p.Sk = g[5], p.hd = g[6];
  p.rep = g[2] / g[3];
  p.causal = g[7] != 0;
  p.window = g[8];
  p.vec_q = g[18] != 0, p.vec_k = g[19] != 0, p.vec_v = g[20] != 0;
  p.hb = g[21], p.nkv_max = g[22];
  p.compute = compute;
  p.softcap = softcap;
  p.scale = scale;
  const int hdp = (p.hd + 3) / 4 * 4;
  const KernelFn fn = g[0] == 0 ? Fp32Table::get(hdp) : Bf16Table::get(hdp);
  const dim3 grid((p.Hq + p.hb - 1) / p.hb, g[1]);
  OnDevice on(g[24]);
  fn<<<grid, p.hb * 32, g[23], stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, Hq, hd) view, k/v: (B, Sk, Hkv, hd) views of one type with a
// unit stride over hd; o: a contiguous (B, Sq, Hq, hd) of that type.
// g: dtype (0 fp32, 1 bf16), B, Hq, Hkv, Sq, Sk, hd, causal, window, the
// (batch, seq, head) strides of q, k and v in elements, whether each of q,
// k and v is staged 16 bytes at a time, heads per block, kv heads staged
// per block, shared bytes, device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_short_fwd(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* g, float softcap,
                                         float scale, cudaStream_t stream) {
  return launch(q, k, v, o, g, softcap, scale, stream, 1);
}

// The same launch without the compute: q, k and v staged, o stored (its
// values unspecified).  What the kernel's memory phases and barriers cost.
extern "C" int flash_attention_short_memory_only(const void* q, const void* k,
                                                 const void* v, void* o,
                                                 const long long* g,
                                                 cudaStream_t stream) {
  return launch(q, k, v, o, g, 0.f, 1.f, stream, 0);
}

// How many blocks of the launch flash_attention_short_fwd would make with g
// fit on one SM at once (the occupancy calculator), or -1.
extern "C" int flash_attention_short_occupancy(const long long* g) {
  if (!geometry_ok(g)) return -1;
  const int hdp = (g[6] + 3) / 4 * 4;
  const KernelFn fn = g[0] == 0 ? Fp32Table::get(hdp) : Bf16Table::get(hdp);
  OnDevice on(g[24]);
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, g[21] * 32,
                                                    g[23]) != cudaSuccess)
    return -1;
  return blocks;
}
