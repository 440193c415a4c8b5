// Flash-attention forward for Hopper (sm_90a): causal, sliding-window,
// logit-softcap and GQA modes, fp32 or bf16 inputs, head dim up to 256.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (body _flash_kernel) in every mode it has.  The DiT runs it non-causal
// over S = n_tok + 1 tokens in fp32; the LM's prefill runs it causal, with
// gemma2's 4096-token window on the local layers, softcap 50 and 8 query
// heads over 4 kv heads, in bf16 at head dim 256.
//
// What bounds it on the H100: at the DiT's shapes (S = 17, head dim 32 or
// 36) each (batch, head) pair does ~4*S*S*hd flops on 4*S*hd*4 bytes of
// q, k, v and o, about S/4 flop per byte: device-memory bytes bound it.  At
// gemma2's prefill (S = 4608, hd 256, causal) each pair does ~S*S*2*hd
// flops on 4*S*hd*2 bytes, ~600 flop per byte: the flops bound it, 0.35 ms
// per layer of a 4 x 4608 wave at the tensor cores' 989 TFLOP/s.  This
// kernel runs on the CUDA cores in fp32 for now (tensor cores, wgmma and
// TMA come later), so it sits far above that bound.  The design reads each
// q, k and v element from device memory once per query tile and keeps
// everything else on chip:
//   * one block per (query tile of 32 rows, query head, batch); 8 warps,
//     each warp owns 4 query rows and their running (m, l, acc) in
//     registers; query head h reads kv head h / (Hq / Hkv) (GQA);
//   * K and V tiles of 32 keys are staged in shared memory as fp32 (bf16
//     converted on the way in), K with an odd row stride so that lane j
//     reading key j is free of bank conflicts; q rows are padded to a
//     multiple of 4 and read as float4 (a broadcast to the warp);
//   * scores: lane j computes the dot products of key j with the warp's 4
//     rows, then the soft cap cap * tanhf(s / cap) on the scaled score, then
//     the masks (key < Sk, causal key <= query, window key > query - window;
//     a masked score is -1e30 and its probability exactly 0); the
//     online-softmax max and sum are warp shuffles.  A row whose tile is
//     fully masked keeps m = -1e30, alpha = 1 and p = 0;
//   * only the key tiles that some row of the block can see are visited:
//     [max(0, q0 - window + 1), min(Sk, q0 + 32)) rounded out to whole
//     tiles, as the TPU kernel skips its fully masked blocks;
//   * P.V: key j's probability is broadcast from lane j, and lanes split
//     the head dimension (lane + 32*i), DPL dims per lane (a template: 1,
//     2, 4 or 8, so any head dim up to 256 works, including the DiT's 36);
//   * q is scaled by hd^-0.5 when staged; the output is acc / l, rounded
//     to the input type (__float2bfloat16_rn for bf16).
// q, k and v are read through (batch, seq, head) strides with a unit stride
// over hd, so the DiT's (B, S, 3, H, hd) QKV buffer needs no transpose.
// At hd 256 a block holds 32 + 32.9 + 32 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;                 // one key per lane
constexpr int kMaxHd = 256;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int hd, int rep, int causal, int window,
                 float softcap,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hd4 = (hd + 3) & ~3;            // q rows padded for float4 reads
  const int kstride = hd4 | 1;
  float* sq = smem;                         // [kBlockQ][hd4]
  float* sk = sq + kBlockQ * hd4;           // [kBlockK][kstride]
  float* sv = sk + kBlockK * kstride;       // [kBlockK][hd]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / rep) * ksh;
  const T* vb = v + b * vsb + (h / rep) * vsh;

  for (int i = tid; i < kBlockQ * hd4; i += blockDim.x) {
    const int r = i / hd4, c = i - r * hd4;
    sq[i] = q0 + r < Sq && c < hd ? to_f32(qb[(q0 + r) * qss + c]) * scale
                                  : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
    qpos[r] = q0 + warp + r * kWarps;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  // the key tiles some row of this block can see
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kBlockQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                        // q staged / last tile consumed
    for (int i = tid; i < kBlockK * hd4; i += blockDim.x) {
      const int r = i / hd4, c = i - r * hd4;
      const bool in = k0 + r < Sk && c < hd;
      sk[r * kstride + c] = in ? to_f32(kb[(k0 + r) * kss + c]) : 0.f;
      if (c < hd) sv[r * hd + c] = in ? to_f32(vb[(k0 + r) * vss + c]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = sk + lane * kstride;
    for (int c = 0; c < hd4; c += 4) {
      const float k0c = krow[c], k1c = krow[c + 1], k2c = krow[c + 2],
                  k3c = krow[c + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            sq + (warp + r * kWarps) * hd4 + c);
        s[r] = fmaf(qv.x, k0c, s[r]);
        s[r] = fmaf(qv.y, k1c, s[r]);
        s[r] = fmaf(qv.z, k2c, s[r]);
        s[r] = fmaf(qv.w, k3c, s[r]);
      }
    }

    const int kpos = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool ok = kpos < Sk && (!causal || kpos <= qpos[r]) &&
                      (window <= 0 || kpos > qpos[r] - window);
      float sr = softcap > 0.f ? softcap * tanhf(s[r] / softcap) : s[r];
      sr = ok ? sr : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sr - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }

    const int nk = min(kBlockK, k_end - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        vj[i] = c < hd ? sv[j * hd + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (qpos[r] >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + b * osb + qpos[r] * oss + h * osh;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) store(orow + c, acc[r][i] * inv);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int hd, int causal, int window,
           float softcap, const long long* st, float scale,
           cudaStream_t stream) {
  const int hd4 = (hd + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t)(kBlockQ * hd4 +
                                               kBlockK * (hd4 | 1) +
                                               kBlockK * hd);
  auto kern = flash_fwd_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, hd, Hq / Hkv,
      causal, window, softcap, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dpl(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
               int window, float softcap, const long long* st, float scale,
               cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, window,
                        softcap, st, scale, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, window,
                        softcap, st, scale, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, window,
                        softcap, st, scale, stream);
  return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, window,
                      softcap, st, scale, stream);
}

}  // namespace

// q/o: (B, Sq, Hq, hd) views, k/v: (B, Sk, Hkv, hd) views, all of one type
// (dtype 0: fp32, 1: bf16), given by their (batch, seq, head) strides in
// elements, unit stride over hd; Hq a multiple of Hkv.  causal 0/1, window
// 0 for none, softcap 0 for none.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd,
    int causal, int window, float softcap,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd || Sq < 1 || Sk < 1 || B < 1 || Hq < 1 ||
      Hkv < 1 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || window < 0 ||
      softcap < 0.f || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  if (dtype == 0)
    return launch_dpl<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal,
                             window, softcap, st, scale, stream);
  return launch_dpl<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd,
                                   causal, window, softcap, st, scale,
                                   stream);
}
