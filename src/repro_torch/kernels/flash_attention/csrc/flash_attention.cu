// Flash-attention forward, non-causal, fp32, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (body _flash_kernel) in its non-causal mode, which the DiT runs once per
// block over its S = n_tok + 1 tokens.
//
// What bounds it on the H100: at the denoiser's shapes (S = 17, head dim 32
// or 36) each (batch, head) pair does ~4*S*S*hd flops on 4*S*hd*4 bytes of
// q, k, v and o, about S/4 flop per byte: device-memory bytes bound it.  At
// S = 3137 the flops dominate (fp32 outside the tensor cores).  The design
// reads each q, k and v element from device memory once per query tile and
// keeps everything else on chip:
//   * one block per (query tile of 32 rows, head, batch); 8 warps, each
//     warp owns 4 query rows and their running (m, l, acc) in registers;
//   * K and V tiles of 32 keys are staged in shared memory, K with an odd
//     row stride so that lane j reading key j is free of bank conflicts;
//   * scores: lane j computes the dot products of key j with the warp's 4
//     rows; the online-softmax max and sum are warp shuffles;
//   * P.V: key j's probability is broadcast from lane j, and lanes split
//     the head dimension (lane + 32*i), so any head dim up to 128 works,
//     including the paper preset's 36;
//   * q is scaled by hd^-0.5 when staged; keys at or past Sk are masked.
// q, k and v are read through (batch, seq, head) strides with a unit stride
// over hd, so the DiT's (B, S, 3, H, hd) QKV buffer needs no transpose.
// Simple and right first: wgmma and TMA come later.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;                 // one key per lane
constexpr int kMaxHd = 128;
constexpr int kDimsPerLane = kMaxHd / 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Sk, int hd,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh, float scale) {
  extern __shared__ float smem[];
  const int kstride = hd | 1;
  float* sq = smem;                         // [kBlockQ][hd]
  float* sk = sq + kBlockQ * hd;            // [kBlockK][kstride]
  float* sv = sk + kBlockK * kstride;       // [kBlockK][hd]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + h * ksh;
  const float* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < kBlockQ * hd; i += blockDim.x) {
    const int r = i / hd, c = i - r * hd;
    sq[i] = q0 + r < Sq ? qb[(q0 + r) * qss + c] * scale : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kBlockK) {
    __syncthreads();                        // q staged / last tile consumed
    for (int i = tid; i < kBlockK * hd; i += blockDim.x) {
      const int r = i / hd, c = i - r * hd;
      const bool in = k0 + r < Sk;
      sk[r * kstride + c] = in ? kb[(k0 + r) * kss + c] : 0.f;
      sv[r * hd + c] = in ? vb[(k0 + r) * vss + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = sk + lane * kstride;
    for (int c = 0; c < hd; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(sq[(warp + r * kWarps) * hd + c], kc, s[r]);
    }

    const bool key_ok = k0 + lane < Sk;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = key_ok ? s[r] : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      p[r] = key_ok ? expf(sr - m_new) : 0.f;
      l[r] = alpha * l[r] + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= alpha;
    }

    const int nk = min(kBlockK, Sk - k0);
    for (int j = 0; j < nk; ++j) {
      float vj[kDimsPerLane];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int c = lane + 32 * i;
        vj[i] = c < hd ? sv[j * hd + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = fmaf(pj, vj[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp + r * kWarps;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = o + b * osb + row * oss + h * osh;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) orow[c] = acc[r][i] * inv;
    }
  }
}

}  // namespace

// q/k/v/o: fp32 (B, S, H, hd) views given by their (batch, seq, head)
// strides in elements, unit stride over hd.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(
    const float* q, const float* k, const float* v, float* o,
    int B, int H, int Sq, int Sk, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd || Sq < 1 || Sk < 1 || B < 1 || H < 1 ||
      B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (size_t)(kBlockQ * hd + kBlockK * (hd | 1) + kBlockK * hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<<<grid, kWarps * 32, smem, stream>>>(
      q, k, v, o, Sq, Sk, hd, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
      osb, oss, osh, scale);
  return static_cast<int>(cudaGetLastError());
}
