// LayerNorm over d + adaLN modulation in one pass, for Hopper (sm_90a):
// out = (x - mean) * rsqrt(var + eps) * (1 + scale[b]) + shift[b], with
// fp32 statistics (mean, then the centred variance), no gain or bias, and a
// per-batch-row (d,) scale and shift; fp32 or bf16.
//
// Replaces src/repro/kernels/adaln_norm/kernel.py::adaln_norm_3d (body
// _adaln_kernel), run at the DiT's three modulation sites: (B, S, d) before
// attention and before the MLP, and the (B, S - 1, d) view tok[:, 1:] at the
// output, (256, 17, 144) and (256, 16, 144) fp32 at the paper preset, 6750
// launches per uniform D_syn round.
//
// What bounds it on the H100: device-memory bytes.  Each token row is read
// once and written once, with ~8 flops per element: at (256, 17, 144) fp32,
// 5.3 MB, 1.6 us at 3.35 TB/s.  The design:
//   * one warp per token row; its d values stay in registers (NV per lane, a
//     template parameter: 8, 16, 32 or 64, so d <= 2048), read 16 bytes at a
//     time where d, the row strides and the base pointer allow (the DiT's
//     rows and its tok[:, 1:] view do; kernel.py::vector_route) and one
//     element at a time otherwise, with no padding of d to a power of two;
//   * mean, then the centred variance, each one warp-shuffle reduction in
//     fp32, eps inside the rsqrt: the reference's two-step arithmetic;
//   * a block holds the token rows of one or more whole batch rows (or 16
//     or 32 rows of one or two when a batch row is longer): 17 warps at the
//     preset, 256 blocks, 4352 warps.  The block stages 1 + scale and shift
//     of its batch rows into shared memory once, so each is read from
//     device memory once per batch row, not once per token;
//   * rows are addressed through the input's batch and token strides, so
//     the tok[:, 1:] view needs no copy; the output is contiguous.
// The launch geometry (values per lane, rows per block, batch rows staged)
// comes from kernel.py::geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 2048;
constexpr int kMaxSmem = 48 * 1024;

struct Params {
  const void* x;
  const void* scale;
  const void* shift;
  void* out;
  long long sxb, sxn, ssb, sbb;
  int B, N, d, rows_per_block, nb, vec;
  float eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Lane `lane` holds NV values of its row: in the vector layout, element j is
// column (lane + 32 * (j / kVec)) * kVec + j % kVec (16-byte chunks dealt
// round the warp); in the scalar layout, column lane + 32 * j.
template <typename T, int NV>
__global__ void __launch_bounds__(NV <= 16 ? 1024 : 512)
adaln_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float4 smem4[];
  float* gain = reinterpret_cast<float*>(smem4);   // [nb][d]: 1 + scale
  float* bias = gain + p.nb * p.d;                 // [nb][d]: shift
  const int d = p.d;
  const long long r0 = (long long)blockIdx.x * p.rows_per_block;
  const int b0 = static_cast<int>(r0 / p.N);
  const int nb = min(p.nb, p.B - b0);
  const T* scale = static_cast<const T*>(p.scale) + b0 * p.ssb;
  const T* shift = static_cast<const T*>(p.shift) + b0 * p.sbb;
  for (int j = 0; j < nb; ++j)
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      gain[j * d + c] = 1.f + to_f32(scale[j * p.ssb + c]);
      bias[j * d + c] = to_f32(shift[j * p.sbb + c]);
    }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long r = r0 + (threadIdx.x >> 5);
  if (r >= (long long)p.B * p.N) return;
  const int b = static_cast<int>(r / p.N);
  const int n = static_cast<int>(r - (long long)b * p.N);
  const T* xr = static_cast<const T*>(p.x) + b * p.sxb + n * p.sxn;
  const float* g = gain + (b - b0) * d;
  const float* h = bias + (b - b0) * d;
  const bool vec = p.vec != 0;

  float v[NV];
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; j += kVec) {
      const int c = (lane + 32 * (j / kVec)) * kVec;
      if (c < d) {
        load16(xr + c, v + j);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[j + i] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < d ? to_f32(xr[c]) : 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) s += v[j];
  const float mean = warp_sum(s) / d;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = vec ? (lane + 32 * (j / kVec)) * kVec + j % kVec
                      : lane + 32 * j;
    v[j] = c < d ? v[j] - mean : 0.f;
    s2 = fmaf(v[j], v[j], s2);
  }
  const float rstd = rsqrtf(warp_sum(s2) / d + p.eps);

  T* orow = static_cast<T*>(p.out) + r * d;
  if (vec) {
#pragma unroll
    for (int j = 0; j < NV; j += kVec) {
      const int c = (lane + 32 * (j / kVec)) * kVec;
      if (c < d) {
        float y[kVec];
#pragma unroll
        for (int i = 0; i < kVec; i += 4) {
          const float4 gi = *reinterpret_cast<const float4*>(g + c + i);
          const float4 hi = *reinterpret_cast<const float4*>(h + c + i);
          y[i] = fmaf(v[j + i] * rstd, gi.x, hi.x);
          y[i + 1] = fmaf(v[j + i + 1] * rstd, gi.y, hi.y);
          y[i + 2] = fmaf(v[j + i + 2] * rstd, gi.z, hi.z);
          y[i + 3] = fmaf(v[j + i + 3] * rstd, gi.w, hi.w);
        }
        store16(orow + c, y);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < d) store1(orow + c, fmaf(v[j] * rstd, g[c], h[c]));
    }
  }
}

typedef void (*KernelFn)(const Params);

template <typename T>
KernelFn pick(int nv) {
  switch (nv) {
    case 8: return adaln_kernel<T, 8>;
    case 16: return adaln_kernel<T, 16>;
    case 32: return adaln_kernel<T, 32>;
    case 64: return adaln_kernel<T, 64>;
    default: return nullptr;
  }
}

// g: dtype (0 fp32, 1 bf16), B, N, d, x's batch and token strides, scale's
// and shift's batch strides (elements), vec, NV, rows per block, batch rows
// staged per block, shared bytes, device.
bool geometry_ok(const long long* g, const void* x) {
  const long long B = g[1], N = g[2], d = g[3], vec = g[8], nv = g[9];
  const long long R = g[10], nb = g[11], smem = g[12];
  const long long kvec = g[0] == 0 ? 4 : 8;
  if (N < 1) return false;
  const long long span = R % N == 0 ? R / N : (R - 1) / N + 2;
  const long long per_lane = vec ? (d + 32 * kvec - 1) / (32 * kvec) * kvec
                                 : (d + 31) / 32;
  return (g[0] == 0 || g[0] == 1) && B >= 1 && N >= 1 && d >= 1 &&
         d <= kMaxD && per_lane <= nv && R >= 1 &&
         R <= (nv <= 16 ? 32 : 16) && nb >= 1 && span <= nb &&
         smem == 8 * nb * d && smem <= kMaxSmem &&
         (!vec || (d % kvec == 0 && g[4] % kvec == 0 && g[5] % kvec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0));
}

struct OnDevice {           // runs on device `dev`, then restores the caller's
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

}  // namespace

// x: a (B, N, d) view with a unit stride over d; scale, shift: (B, d) views
// with a unit stride over d; out: a contiguous (B, N, d); all of one type.
// g as in geometry_ok, then the device index at g[13].  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int adaln_norm_fwd(const void* x, const void* scale,
                              const void* shift, void* out,
                              const long long* g, float eps,
                              cudaStream_t stream) {
  if (!geometry_ok(g, x)) return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = g[0] == 0 ? pick<float>(g[9])
                                : pick<__nv_bfloat16>(g[9]);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.scale = scale;
  p.shift = shift;
  p.out = out;
  p.sxb = g[4], p.sxn = g[5], p.ssb = g[6], p.sbb = g[7];
  p.B = g[1], p.N = g[2], p.d = g[3];
  p.vec = g[8] != 0;
  p.rows_per_block = g[10], p.nb = g[11];
  p.eps = eps;
  const long long rows = g[1] * g[2];
  const unsigned blocks = (rows + g[10] - 1) / g[10];
  OnDevice on(g[13]);
  fn<<<blocks, g[10] * 32, g[12], stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
