// Kernel K5: the decode step's new token, for Hopper (sm_90a): the rotary
// on its q and k, the int8 quantization of its k and v per (token, head),
// and their write into the int8 KV cache at each row's position, in one
// launch.
//
// Replaces no TPU kernel. The JAX rotary (attwarp_tpu/models/llama.py::
// apply_rope) and quantization (attwarp_tpu/numerics/quant.py::quantize_kv)
// are plain jnp code that XLA fuses, and the TPU's decode attention merged
// the new token inside its kernel (attwarp_tpu/ops/pallas_decode_attn.py,
// v3). On the card the same code ran eagerly, inside the graphed decode
// step, as 34 small kernels a layer (the rotary's casts, products, negation,
// concatenations and sums on q and k; for k and v each a cast, abs, amax,
// clamp, two divisions, round, clamp, cast and two index writes), the
// largest chain of a step in every model family. K5 is those 34 as one.
//
// What bounds it on the H100: latency. A call at LLaVA-1.5-7B's widths (B=8,
// 32 heads of 128) moves ~340 KB, ~0.1 us at 3.35 TB/s, and does a few
// operations a value; a launch and one round trip to HBM take longer. So the
// design is one launch with no second pass and no shared memory:
// - a warp per (row, head) of q, k and v, four head dims a lane (one 8-byte
//   bf16 load, or 16 bytes in float32);
// - rotate_half's partner of dim d sits at d ^ 64: lane l ^ 16, one shuffle;
// - max|x| over the head is a warp reduction, and lane 0 writes the scale;
// - each lane writes its four int8 values as one 32-bit word, a warp 128
//   contiguous bytes of the cache row.
// Positions come from a (B,) int64 tensor on the card (the decode graphs'
// static buffer, so a replay reads no host value), or one int for the whole
// batch (the eager step's), passed by value. A position outside [0, S)
// traps (the wrapper refuses an int one before the launch); ATen's index
// write device-asserts on one past the end.
//
// Numerics, step for step the eager PyTorch sequence on the card
// (kernels/rope_append.py::rope_append_int8_plain): cos and sin rounded to
// the activations' type; q * cos and rotate_half(q) * sin each rounded to
// that type, then their sum; the rotated k rounded likewise. The scale is
// max(max|x|, 1e-8) times RN(1 / 127) (ATen divides a tensor by a Python
// scalar as a product with its float reciprocal); each value is x / s
// correctly rounded, rounded half to even and clamped to +-127. The products
// and sums are _rn intrinsics, so nothing is contracted into an FMA. The
// max is order-free, so the outputs are bit-equal to the eager sequence's;
// a NaN propagates through the max and the clamps as in torch.amax and
// torch.clamp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;    // 4 dims a lane
constexpr int kWarps = 4;        // heads a block, a warp each
constexpr float kInv127 = 0x1.020408p-7f;   // RN(1 / 127) in float

template <typename T>
struct Lane4;

template <>
struct Lane4<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* o) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(r.x << 16);
    o[1] = __uint_as_float(r.x & 0xffff0000u);
    o[2] = __uint_as_float(r.y << 16);
    o[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
  // x rounded to bf16, as a float
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Lane4<float> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    o[0] = r.x;
    o[1] = r.y;
    o[2] = r.z;
    o[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// x rotated: x * cos + rotate_half(x) * sin, each step rounded to T
template <typename T>
__device__ __forceinline__ void rotate(float* x, const float* cos_row, const float* sin_row,
                                       int lane) {
  using E = Lane4<T>;
  float c[4], s[4];
  Lane4<float>::load(cos_row + 4 * lane, c);
  Lane4<float>::load(sin_row + 4 * lane, s);
  const bool low = lane < 16;   // dims 0-63: rotate_half takes -x[d + 64]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float partner = __shfl_xor_sync(0xffffffffu, x[i], 16);
    const float r = low ? -partner : partner;
    const float a = E::round(__fmul_rn(x[i], E::round(c[i])));
    const float b = E::round(__fmul_rn(r, E::round(s[i])));
    x[i] = E::round(__fadd_rn(a, b));
  }
}

// The larger of a and b, NaN if either is (as torch.amax and torch.clamp
// propagate it; fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// One head's values quantized into its cache row and scale. A NaN in the
// head makes its scale NaN and its values 0 (the conversion of NaN to an
// integer), as in the eager sequence.
__device__ __forceinline__ void quantize_store(const float* x, int8_t* row, float* scale,
                                               int lane) {
  float m = max_nan(max_nan(fabsf(x[0]), fabsf(x[1])), max_nan(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = __fmul_rn(max_nan(m, 1e-8f), kInv127);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = min_nan(max_nan(rintf(__fdiv_rn(x[i], s)), -127.f), 127.f);
    w |= ((uint32_t)(uint8_t)(int8_t)(int)q) << (8 * i);
  }
  *reinterpret_cast<uint32_t*>(row + 4 * lane) = w;
  if (lane == 0) *scale = s;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rope_append_int8(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ cos, const float* __restrict__ sin,
                 T* __restrict__ q_out, int8_t* __restrict__ k_q, float* __restrict__ k_s,
                 int8_t* __restrict__ v_q, float* __restrict__ v_s,
                 const long long* __restrict__ pos, long long pos0, int B, int S, int H,
                 int kvH, int layer) {
  using E = Lane4<T>;
  const int lane = threadIdx.x & 31;
  const int per_row = H + 2 * kvH;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= (long long)B * per_row) return;
  const int b = (int)(w / per_row);
  const int j = (int)(w % per_row);   // q heads, then k heads, then v heads
  float x[4];
  if (j < H) {
    E::load(q + ((long long)b * H + j) * kHeadDim + 4 * lane, x);
    rotate<T>(x, cos + (long long)b * kHeadDim, sin + (long long)b * kHeadDim, lane);
    E::store(q_out + ((long long)b * H + j) * kHeadDim + 4 * lane, x);
    return;
  }
  const bool is_k = j < H + kvH;
  const int h = is_k ? j - H : j - H - kvH;
  E::load((is_k ? k : v) + ((long long)b * kvH + h) * kHeadDim + 4 * lane, x);
  if (is_k) rotate<T>(x, cos + (long long)b * kHeadDim, sin + (long long)b * kHeadDim, lane);
  const long long p = pos ? pos[b] : pos0;
  // no slot there: stop the kernel, as the eager index write's bound check
  // does, rather than leave a stale slot for the attention to read
  if (p < 0 || p >= S) __trap();
  const long long slot = (((long long)layer * B + b) * S + p) * kvH + h;
  quantize_store(x, (is_k ? k_q : v_q) + slot * kHeadDim, (is_k ? k_s : v_s) + slot, lane);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* cos,
                   const float* sin, void* q_out, int8_t* k_q, float* k_s, int8_t* v_q,
                   float* v_s, const long long* pos, long long pos0, int B, int S, int H,
                   int kvH, int layer, cudaStream_t stream) {
  const long long warps = (long long)B * (H + 2 * kvH);
  rope_append_int8<T><<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cos, sin,
      static_cast<T*>(q_out), k_q, k_s, v_q, v_s, pos, pos0, B, S, H, kvH, layer);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, 128), k and v (B, kvH, 128) in the activations' type (bf16,
// elem_bytes 2, or float32, 4); cos, sin (B, 128) f32; q_out (B, H, 128) in
// that type; k_q, v_q (L, B, S, kvH, 128) int8 and k_s, v_s (L, B, S, kvH)
// f32, written at (layer, b, position of row b); pos (B,) int64 or null,
// then every row's position is pos0. Returns cudaGetLastError after the
// launch.
extern "C" int attwarp_rope_append_int8(const void* q, const void* k, const void* v,
                                        const void* cos, const void* sin, void* q_out,
                                        void* k_q, void* k_s, void* v_q, void* v_s,
                                        const void* pos, long long pos0, int L, int B, int S,
                                        int H, int kvH, int hd, int layer, int elem_bytes,
                                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || kvH <= 0 || hd != kHeadDim || layer < 0 || layer >= L ||
      (long long)B * (H + 2 * kvH) > 0x7fffffffLL * kWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
  int8_t* kq = static_cast<int8_t*>(k_q);
  int8_t* vq = static_cast<int8_t*>(v_q);
  float* ks = static_cast<float*>(k_s);
  float* vs = static_cast<float*>(v_s);
  const long long* p = static_cast<const long long*>(pos);
  if (elem_bytes == 2) {
    return (int)launch<__nv_bfloat16>(q, k, v, c, s, q_out, kq, ks, vq, vs, p, pos0, B, S, H,
                                      kvH, layer, st);
  }
  if (elem_bytes == 4) {
    return (int)launch<float>(q, k, v, c, s, q_out, kq, ks, vq, vs, p, pos0, B, S, H, kvH,
                              layer, st);
  }
  return (int)cudaErrorInvalidValue;
}
