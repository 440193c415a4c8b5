// Fused classifier-free guidance combine + ancestral (DDIM eta) update for
// Hopper (sm_90a), fp32:
//
//   eps    = (1+s)·ε_c − s·ε_u
//   x0     = clip((x − √(1−ᾱ_t)·eps) / √ᾱ_t, ±1)
//   out    = √ᾱ_prev·x0 + dir·eps + σ·z
//
// Replaces src/repro/kernels/cfg_fuse/kernel.py::cfg_update_2d (body
// _cfg_kernel; the "scalar" variant: one set of step scalars for the whole
// tensor, once per reverse step of a uniform wave) and ::cfg_update_rowwise_3d
// (body _cfg_rowwise_kernel; the "rowwise" variant: tensor row b reads its
// scalars from column row_offset + b of an (8, slots) table that may span a
// whole wave, and a row whose `active` entry is not > 0 is stored back
// unchanged).  The main path runs each 750 times a D_syn round on (120 or
// 128, 16, 16, 3): 92,160-98,304 elements a launch.
//
// Each variant takes z, the step's standard normal noise, from one of two
// sources (the kKeyed template parameter):
//   * from memory: exactly the TPU kernel's function;
//   * drawn from threefry keys inside the kernel, bit for bit as
//     repro_torch/prng.py::normal builds jax.random.normal: element n of a
//     key's draw hashes the count pair (0, n) with threefry-2x32 (20
//     rounds), xors the two words, maps the top 23 bits to a uniform on
//     [nextafter(-1, 0), 1) and takes √2 · XLA's single-precision erfinv.
//     The scalar variant draws one key over the whole tensor (n the flat
//     index; z = 0 where the step is not live, t = 0), the rowwise variant
//     one key per tensor row (n the index within the row), times the row's
//     live entry (t > 0), as the samplers draw and mask their noise.  This
//     keeps the 4 bytes of z a element off the device, and the ~100 eager
//     int64 torch ops that drew a whole wave's noise before its loop.
//
// What bounds it on the H100: at the main path's size, the launch.  A
// launch moves 20 bytes an element with z from memory (16 drawn from keys),
// ~2 MB, 0.6 us at 3.35 TB/s, against ~1.15 us for an empty kernel
// replayed in a graph.  Drawing z costs ~75 int32 operations an element
// (20 threefry rounds of add, rotate and xor, and the key injections) and
// ~45 fp32 ones (log1pf, the erfinv polynomial): at the card's int32 rate
// (64 lanes an SM, half the fp32 lanes) ~0.44 us, as much as the bytes.
// The design therefore gives every SM, and every one of its four warp
// schedulers, the same share at once, and keeps every byte in flight from
// the first instruction:
//   * z from memory: 16-byte loads and stores wherever the row length and
//     every pointer are whole chunks (build.whole_chunks; every main-path
//     tensor, eps2[B:] included), one chunk a thread, at most one block
//     per SM of just enough warps (192 threads, 128 blocks at the main
//     path);
//   * z drawn from keys, and odd totals and unaligned views: one element a
//     thread (coalesced 4-byte accesses), blocks of 256 threads.  A warp of
//     16-byte chunks is 128 elements: ~98,304 elements over 528 schedulers
//     then leave some with two warps (256 draws) and others with one, and
//     the draw, not the bytes, sets the time; one element a thread evens
//     that out (192 draws at most);
//   * past 8 blocks an SM, a grid-stride loop (kernel.py::geometry);
//   * the step's scalars come in the packed argument block (scalar
//     variant) or as 8 loads from the row's column of the device table
//     (rowwise), issued with the operands' loads and the row's key, so
//     that a thread waits for one round trip to memory, with the draw
//     (which needs only the key and the counter) in its shadow.
//
// Rounding: exactly where the plain versions (ref.py, and prng.normal for
// the draw) round, so that the output is bit-equal to them.  The update is
// ill-conditioned at a first step at t = 999 (x0 divides a cancelling
// difference by √ᾱ_t ~ 5e-5), so one rounding more or less moves the output
// by ~1e-3.  Every product, sum and quotient is an explicit _rn intrinsic
// (no multiply-add contraction, IEEE division); log1pf and sqrtf are the
// CUDA library's (IEEE sqrt), as PyTorch's kernels call them; the erfinv
// constants are the float32 values PyTorch rounds the Python doubles to,
// written as hex floats.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

// The packed argument block, 184 bytes; kernel.py::_ARGS packs it.
struct Args {
  const float* x;
  const float* ec;
  const float* eu;
  const float* z;          // z from memory, else null
  float* out;
  const float* coeffs;     // rowwise: the (8, slots) table, else null
  const uint32_t* keys;    // rowwise keyed: (rows, 2) threefry keys
  const float* live;       // rowwise keyed: (rows,) 1 or 0
  long long n_row;         // elements a row (the scalar variant: all)
  long long rows;          // tensor rows (the scalar variant: 1)
  long long slots;         // columns of the coefficient table
  long long row_offset;    // the slot of tensor row 0
  long long variant;       // 0 scalar, 1 rowwise
  long long keyed;         // 0 z from memory, 1 drawn from keys
  long long vec;           // 16-byte loads and stores
  long long blocks, threads, device;
  // the scalar variant's (1+s, s, √(1−ᾱ_t), √ᾱ_t, √ᾱ_prev, dir, σ, live)
  float sc[8];
  uint32_t key[2];         // the scalar variant's threefry key
};
static_assert(sizeof(Args) == 184, "Args must match kernel.py::_ARGS");

constexpr float kUniformLo = -0x1.fffffep-1f;   // nextafter(-1, 0)
constexpr float kSpan = 2.0f;                   // fl32(1 - lo)
constexpr float kSqrt2 = 0x1.6a09e6p+0f;        // fl32(√2)

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Element n of prng.normal's draw from key (k0, k1): jax.random.bits
// (threefry-2x32 of the count pair (0, n), the two output words xored),
// the uniform, then √2 · erfinv in its op order
__device__ __forceinline__ float normal_of(uint32_t k0, uint32_t k1,
                                           uint32_t n) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t a = k0, b = n + k1;
#define CFG_ROUND(r) \
  a += b;            \
  b = rotl(b, r) ^ a;
#define CFG_ROUNDS_A CFG_ROUND(13) CFG_ROUND(15) CFG_ROUND(26) CFG_ROUND(6)
#define CFG_ROUNDS_B CFG_ROUND(17) CFG_ROUND(29) CFG_ROUND(16) CFG_ROUND(24)
  CFG_ROUNDS_A a += k1; b += k2 + 1u;
  CFG_ROUNDS_B a += k2; b += k0 + 2u;
  CFG_ROUNDS_A a += k0; b += k1 + 3u;
  CFG_ROUNDS_B a += k1; b += k2 + 4u;
  CFG_ROUNDS_A a += k2; b += k0 + 5u;
#undef CFG_ROUNDS_B
#undef CFG_ROUNDS_A
#undef CFG_ROUND
  const uint32_t bits = a ^ b;
  const float one = __uint_as_float((bits >> 9) | 0x3F800000u);
  float u = __fadd_rn(__fmul_rn(__fsub_rn(one, 1.0f), kSpan), kUniformLo);
  u = fmaxf(u, kUniformLo);
  const float w0 = -log1pf(__fmul_rn(u, -u));
  const bool lt = w0 < 5.0f;
  const float w = lt ? __fsub_rn(w0, 2.5f) : __fsub_rn(sqrtf(w0), 3.0f);
  // XLA's erfinv polynomials (w < 5, w >= 5) in float32: immediates once
  // the loop is unrolled
  const float lt5[9] = {0x1.e2cb1p-26f,   0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                        -0x1.11c9dep-8f,  0x1.f91ec6p-3f,  0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f,  0x1.7824f6p-8f,  -0x1.f38baep-8f,
                        0x1.354afcp-7f,   0x1.006db6p+0f,  0x1.6a9efcp+1f};
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __fadd_rn(lt ? lt5[i] : ge5[i], __fmul_rn(p, w));
  const float e = fabsf(u) == 1.0f ? __fmul_rn(u, __int_as_float(0x7f800000))
                                   : __fmul_rn(p, u);
  return __fmul_rn(kSqrt2, e);
}

// ref.ancestral_step on eps = (1+s)·ε_c − s·ε_u, c = (1+s, s, √(1−ᾱ_t),
// √ᾱ_t, √ᾱ_prev, dir, σ)
__device__ __forceinline__ float update(float x, float ec, float eu, float z,
                                        const float* c) {
  const float eps = __fsub_rn(__fmul_rn(c[0], ec), __fmul_rn(c[1], eu));
  float x0 = __fdiv_rn(__fsub_rn(x, __fmul_rn(c[2], eps)), c[3]);
  x0 = fminf(fmaxf(x0, -1.0f), 1.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(c[4], x0), __fmul_rn(c[5], eps)),
                   __fmul_rn(c[6], z));
}

// Item i of the launch is chunk (or element) i % per_row of tensor row
// i / per_row; thread t of block g takes items g * threads + t, + blocks *
// threads, ...  A chunk is 4 consecutive elements of one row, read with z
// from memory; a keyed launch takes one element a thread.  Every load of
// an item is issued before anything waits on one: the row's scalars, its
// key and its operands are one round trip, and the draw overlaps it.  A
// frozen row (rowwise, active not > 0) stores x back.
template <bool kRowwise, bool kKeyed>
__global__ void __launch_bounds__(kMaxThreads) cfg_kernel(const Args a) {
  const bool vec = !kKeyed && a.vec != 0;
  const uint32_t per_row = vec ? (uint32_t)(a.n_row >> 2) : (uint32_t)a.n_row;
  const uint32_t items = per_row * (uint32_t)a.rows;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += stride) {
    const uint32_t row = kRowwise ? i / per_row : 0u;
    const uint32_t j = kRowwise ? i - row * per_row : i;
    const uint32_t n = vec ? 4u * j : j;          // counter within the row
    const size_t at = (size_t)row * (size_t)a.n_row + n;
    float c[8];
    if (kRowwise) {
      const float* col = a.coeffs + a.row_offset + row;
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = __ldg(col + k * a.slots);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = a.sc[k];
    }
    if (vec) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a.x + at));
      const float4 ec = __ldg(reinterpret_cast<const float4*>(a.ec + at));
      const float4 eu = __ldg(reinterpret_cast<const float4*>(a.eu + at));
      const float4 z = __ldg(reinterpret_cast<const float4*>(a.z + at));
      float4 o = x;
      if (!kRowwise || c[7] > 0.0f) {
        o.x = update(x.x, ec.x, eu.x, z.x, c);
        o.y = update(x.y, ec.y, eu.y, z.y, c);
        o.z = update(x.z, ec.z, eu.z, z.z, c);
        o.w = update(x.w, ec.w, eu.w, z.w, c);
      }
      *reinterpret_cast<float4*>(a.out + at) = o;
      continue;
    }
    const float x = __ldg(a.x + at);
    const float ec = __ldg(a.ec + at);
    const float eu = __ldg(a.eu + at);
    float z;
    if (!kKeyed) {
      z = __ldg(a.z + at);
    } else if (kRowwise) {          // the row's key, times its live entry
      z = __fmul_rn(normal_of(__ldg(a.keys + 2 * row),
                              __ldg(a.keys + 2 * row + 1), n),
                    __ldg(a.live + row));
    } else {                        // the step's key; t = 0: no noise
      z = c[7] > 0.0f ? normal_of(a.key[0], a.key[1], n) : 0.0f;
    }
    a.out[at] = !kRowwise || c[7] > 0.0f ? update(x, ec, eu, z, c) : x;
  }
}

typedef void (*KernelFn)(const Args);

KernelFn pick(const Args& a) {
  if (a.variant == 0) return a.keyed ? cfg_kernel<false, true>
                                     : cfg_kernel<false, false>;
  return a.keyed ? cfg_kernel<true, true> : cfg_kernel<true, false>;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool args_ok(const Args& a) {
  const bool rowwise = a.variant == 1;
  if ((a.variant != 0 && a.variant != 1) || (a.keyed != 0 && a.keyed != 1))
    return false;
  if (a.n_row < 1 || a.rows < 1 || a.n_row * a.rows >= (1LL << 31) ||
      a.blocks < 1 || a.blocks > 0x7fffffffLL || a.threads < 32 ||
      a.threads > kMaxThreads || a.threads % 32 != 0 ||
      a.blocks * a.threads >= (1LL << 31))
    return false;
  if (!a.x || !a.ec || !a.eu || !a.out || (!a.keyed && !a.z)) return false;
  if (!rowwise && a.rows != 1) return false;
  if (rowwise && (!a.coeffs || a.row_offset < 0 ||
                  a.row_offset + a.rows > a.slots))
    return false;
  if (rowwise && a.keyed && (!a.keys || !a.live)) return false;
  if (a.vec && (a.keyed || a.n_row % 4 != 0 || !aligned(a.x) ||
                !aligned(a.ec) || !aligned(a.eu) || !aligned(a.out) ||
                !aligned(a.z)))
    return false;
  return true;
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

// One update: the packed Args (see above; kernel.py::_ARGS), launched on
// `stream` at its (blocks, threads).  Returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for arguments it refuses.
extern "C" int cfg_fuse_fwd(const void* args, cudaStream_t stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on((int)a.device);
  pick(a)<<<(unsigned)a.blocks, (unsigned)a.threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
