// RMSNorm over the last dimension for Hopper (sm_90a):
// out = x * rsqrt(mean(x^2) + eps) * (1 + scale), fp32 statistics, fp32 or
// bf16 x, fp32 or bf16 scale, output in x's type.
//
// Replaces src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d (body
// _rms_kernel).  The LM's norm sites give it (rows, d) = (4 x 4608, 2304)
// in bf16 at gemma2-2b's wave A.
//
// What bounds it on the H100: device-memory bytes.  Each row is read once
// and written once, with ~4 flops per element: at (18432, 2304) bf16 that
// is 170 MB, 51 us at 3.35 TB/s.  The design keeps every byte in flight
// that the bound needs and moves nothing else:
//   * a row is split into 16-byte chunks, dealt round W warps (W a power of
//     two, 1 at d = 2304 in bf16 and 2 in fp32) so that each lane holds NV
//     <= 12 chunks in registers, NV = ceil(chunks / (32 W)) a template
//     parameter: 2304 bf16 values are 288 chunks, 9 a lane of one warp.
//     No padding of d to a power of two, no masked lanes past the row's
//     last chunk;
//   * all of a row's loads are in flight before its reduction (the row is
//     read once, into registers, for the mean of squares and the output),
//     a warp-shuffle sum, and across W warps a named barrier on the warps
//     of that row with the partial sums in shared memory, added in a fixed
//     order;
//   * a persistent grid (the SMs times the blocks that fit on one, 2 at
//     d = 2304): each block of 8 warps loops over rows 8 / W at a time,
//     holds 1 + scale in fp32 in shared memory, loaded once, and copies its
//     next row (cp.async, 16 bytes a lane and chunk) into a two-row ring in
//     shared memory before it reduces and stores the current one.  Each
//     lane reads back only the chunks it copied, so the ring needs no
//     barrier; outputs go out as streaming stores.  Holding the next row
//     or the scale in registers instead costs warps (up to 247 registers
//     a thread) and measured slower;
//   * rows whose width, stride or base pointer are not whole 16-byte
//     chunks are read and written one element at a time, in the same
//     layout (kernel.py::vector_route decides).
// The output is a contiguous (rows, d).  The geometry (NV, W) comes packed
// from kernel.py::geometry, which the tests replay row by row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNV = 12;
constexpr int kMaxD = 8192;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 2;              // rows in the ring: 1 ahead

struct Params {
  const void* x;
  const void* scale;
  void* out;
  long long sx;                   // x's row stride, in elements
  long long rows;
  int d, W, vec, scale_bf16;
  float eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

// the kVec = 16 / sizeof(T) values of one chunk, as fp32
__device__ __forceinline__ void unpack(const uint4& r, float* f, float) {
  const float4 x = *reinterpret_cast<const float4*>(&r);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  const float4 x = make_float4(f[0], f[1], f[2], f[3]);
  return *reinterpret_cast<const uint4*>(&x);
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i],
                                                           f[2 * i + 1]);
  return r;
}

// chunk q of a row (elements q * kVec ..): 16 bytes at once, or one
// element at a time with the ones past d zero
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int q, int d,
                                            bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int c = q * kVec;
  if (vec) {
    if (c < d) return __ldg(reinterpret_cast<const uint4*>(row + c));
    return make_uint4(0, 0, 0, 0);
  }
  float f[kVec];                  // bf16 values round back exactly
#pragma unroll
  for (int e = 0; e < kVec; ++e) f[e] = c + e < d ? to_f32(row[c + e]) : 0.f;
  return pack(f, T());
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* row, int q, int d, bool vec,
                                            const float* y) {
  constexpr int kVec = 16 / sizeof(T);
  const int c = q * kVec;
  if (vec) {                      // streaming: the output is not reread
    if (c < d) __stcs(reinterpret_cast<uint4*>(row + c), pack(y, T()));
    return;
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    if (c + e < d) row[c + e] = from_f32(y[e], T());
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Warp w of a block takes part w % W of rows blockIdx.x * R + w / W, + R *
// gridDim.x, ... (R = 8 / W rows at a time); lane `lane` of part `wp`
// holds chunks (j * W + wp) * 32 + lane, j < NV.
// 16 bytes from global src to shared dst, asynchronously; zero-filled and
// src not read when `in` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// Shared bytes of a block of instance NV: the ring, then 1 + scale.
constexpr size_t smem_bytes(int nv) {
  return (size_t)kStages * nv * kThreads * 16 + 4 * (size_t)(kMaxD + 8);
}

// Warp w of a block takes part w % W of rows blockIdx.x * R + w / W, + R *
// gridDim.x, ... (R = 8 / W rows at a time); lane `lane` of part `wp`
// holds chunks (j * W + wp) * 32 + lane, j < NV.  Whole-chunk rows go
// through a ring of kStages rows a thread in shared memory, each lane
// copying (cp.async) and reading back its own chunks, so no barrier is
// needed; other rows are read one element at a time.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 1) rms_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                         // [kStages][NV][kThreads]
  float* gain = reinterpret_cast<float*>(smem + kStages * NV * kThreads);
  __shared__ float part[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = p.W, wp = warp % W, grp = warp / W, R = kWarps / W;
  const int d = p.d;
  const bool vec = p.vec != 0;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const long long step = (long long)R * gridDim.x;
  long long row = (long long)blockIdx.x * R + grp;

  // the next rows' chunks, in flight while this block loads 1 + scale
  auto issue = [&](long long r, int stage) {
    if (vec && r < p.rows) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = ((j * W + wp) * 32 + lane) * kVec;
        cp_async16(ring + (stage * NV + j) * kThreads + threadIdx.x,
                   c < d ? x + r * p.sx + c : x, c < d);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(row + s * step, s);

  for (int c = threadIdx.x; c < d; c += kThreads)
    gain[c] = 1.f + (p.scale_bf16
                         ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(p.scale)[c])
                         : static_cast<const float*>(p.scale)[c]);
  __syncthreads();

  for (int it = 0; row < p.rows; row += step, ++it) {
    issue(row + (kStages - 1) * step, (it + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    uint4 cur[NV];
    const uint4* mine = ring + (it % kStages) * NV * kThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      cur[j] = vec ? mine[j * kThreads]
                   : load_chunk(x + row * p.sx, (j * W + wp) * 32 + lane, d,
                                false);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[kVec];
      unpack(cur[j], f, T());
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss = fmaf(f[e], f[e], ss);
    }
    ss = warp_sum(ss);
    if (W > 1) {                                // the row's W warps
      if (lane == 0) part[it & 1][warp] = ss;
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(32 * W)
                   : "memory");
      ss = 0.f;
      for (int w = 0; w < W; ++w) ss += part[it & 1][grp * W + w];
    }
    const float r = rsqrtf(ss / d + p.eps);
    T* orow = out + row * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int q = (j * W + wp) * 32 + lane;
      if (q * kVec >= d) continue;
      float f[kVec];
      unpack(cur[j], f, T());
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(gain + q * kVec + e);
        f[e] = f[e] * r * g4.x;
        f[e + 1] = f[e + 1] * r * g4.y;
        f[e + 2] = f[e + 2] * r * g4.z;
        f[e + 3] = f[e + 3] * r * g4.w;
      }
      store_chunk(orow, q, d, vec, f);
    }
  }
}

typedef void (*KernelFn)(const Params);

template <typename T>
KernelFn pick(int nv) {
  switch (nv) {
    case 1: return rms_kernel<T, 1>;
    case 2: return rms_kernel<T, 2>;
    case 3: return rms_kernel<T, 3>;
    case 4: return rms_kernel<T, 4>;
    case 5: return rms_kernel<T, 5>;
    case 6: return rms_kernel<T, 6>;
    case 7: return rms_kernel<T, 7>;
    case 8: return rms_kernel<T, 8>;
    case 9: return rms_kernel<T, 9>;
    case 10: return rms_kernel<T, 10>;
    case 11: return rms_kernel<T, 11>;
    case 12: return rms_kernel<T, 12>;
    default: return nullptr;
  }
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

// g: dtype of x (0 fp32, 1 bf16), rows, d, x's row stride (elements), vec,
// NV, W, scale dtype (0 fp32, 1 bf16), device.
bool geometry_ok(const long long* g, const void* x) {
  const long long rows = g[1], d = g[2], sx = g[3], vec = g[4], nv = g[5];
  const long long W = g[6];
  const long long kvec = g[0] == 0 ? 4 : 8;
  const long long chunks = (d + kvec - 1) / kvec;
  return (g[0] == 0 || g[0] == 1) && (g[7] == 0 || g[7] == 1) && rows >= 1 &&
         d >= 1 && d <= kMaxD && sx >= 0 &&
         (W == 1 || W == 2 || W == 4 || W == 8) && nv >= 1 &&
         nv <= kMaxNV && nv == (chunks + 32 * W - 1) / (32 * W) &&
         (W == 1 || 32 * (W / 2) * kMaxNV < chunks) &&
         (!vec || (d % kvec == 0 && sx % kvec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0));
}

// the persistent grid: enough blocks for every row, at most as many as fit
// on the card at once (cached per instance and device, with the shared
// memory attribute set once)
int grid_of(KernelFn fn, int slot, int dev, long long rows, int W,
            size_t smem) {
  static int fits[2 * (kMaxNV + 1)][64];
  if (fits[slot][dev & 63] == 0) {
    int sms = 0, per = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, kThreads,
                                                      smem) != cudaSuccess ||
        sms * per < 1)
      return -1;
    fits[slot][dev & 63] = sms * per;
  }
  const long long need = (rows + kWarps / W - 1) / (kWarps / W);
  return (int)(need < fits[slot][dev & 63] ? need : fits[slot][dev & 63]);
}

}  // namespace

// x: a (rows, d) view with a unit stride over d; scale: a contiguous (d,);
// out: a contiguous (rows, d) of x's type; g as in geometry_ok.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           const long long* g, float eps,
                           cudaStream_t stream) {
  if (!geometry_ok(g, x)) return static_cast<int>(cudaErrorInvalidValue);
  const int nv = (int)g[5];
  const KernelFn fn = g[0] == 0 ? pick<float>(nv) : pick<__nv_bfloat16>(nv);
  OnDevice on((int)g[8]);
  const int grid = grid_of(fn, (int)g[0] * (kMaxNV + 1) + nv, (int)g[8],
                           g[1], (int)g[6], smem_bytes(nv));
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.scale = scale;
  p.out = out;
  p.sx = g[3];
  p.rows = g[1];
  p.d = (int)g[2];
  p.W = (int)g[6];
  p.vec = g[4] != 0;
  p.scale_bf16 = g[7] != 0;
  p.eps = eps;
  fn<<<grid, kThreads, smem_bytes(nv), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The grid rmsnorm_fwd launches with g (blocks), or -1.
extern "C" int rmsnorm_grid(const long long* g, const void* x) {
  if (!geometry_ok(g, x)) return -1;
  const int nv = (int)g[5];
  const KernelFn fn = g[0] == 0 ? pick<float>(nv) : pick<__nv_bfloat16>(nv);
  OnDevice on((int)g[8]);
  return grid_of(fn, (int)g[0] * (kMaxNV + 1) + nv, (int)g[8], g[1],
                 (int)g[6], smem_bytes(nv));
}
