// Kernel K4: the scaled row softmax between a vision tower's two attention
// products, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX towers (attwarp_tpu/models/qwen2vl.py,
// attwarp_tpu/models/clip_vit.py) take this softmax as plain einsum code that
// XLA fuses. On the card the same code ran as four elementwise passes over
// the (heads, N, N) logits (cast to f32, scale, softmax, cast back), the
// largest device time of the Qwen2-VL two-pass batch (2304-patch rows, 16
// heads, 32 blocks, one image at a time). K4 is those four passes as one.
//
// What bounds it on the H100: bytes. Each logit is read once and its
// probability written once over it: 4 bytes a bf16 value (8 a float), for 5
// operations (scale, max, exponent, sum, quotient), three orders of
// magnitude below any compute limit. A (16, 2304, 2304) bf16 image moves
// 340 MB, ~101 us at 3.35 TB/s.
//
// Design: one warp per row, the whole row in registers (24 values a lane
// for rows up to 768, CLIP's 577 and SigLIP's 729; 72 for rows up to 2304,
// Qwen2-VL's at 672 px), so each row is read from HBM once and written
// once, with no shared memory. The arithmetic (~18 instructions a value,
// the exponent most of it) takes about half the time of the bytes at this
// card's rates, so the kernel is built to keep HBM busy while warps compute:
// - The row is cut where its bytes meet a 16-byte boundary: a scalar head of
//   fewer than 16 bytes, 16-byte vectors (8 bf16), a scalar tail. A row of
//   odd length (CLIP's 577, SigLIP's 729) starts off the boundary, so every
//   row finds its own head; rows of 2304 are all vectors.
// - Persistent warps (as many as fit on the card) walk the rows with a
//   stride; each warp starts the next row's loads before this row's
//   arithmetic, and one bulk L2 prefetch (cp.async.bulk.prefetch) of the
//   row after that, so the row it computes next is already on its way.
//   Probabilities are stored with evict-first hints (__stcs): they are not
//   read again by this kernel.
// - The quotient is a product by the correctly rounded reciprocal of the
//   sum and one FMA correction (Markstein's theorem: RN(q + r(a - sq)) is
//   a / s correctly rounded for r = RN(1/s) and a normal quotient), 3
//   instructions where __fdiv_rn takes ~10 and a slow-path branch.
//   Measured on an H100 (700 W) at (16, 2304, 2304): one row a warp with
//   __fdiv_rn, 58% of the bound; persistent warps loading the next row
//   first, 53% with __fdiv_rn (185 registers) and 73% with the correction;
//   with the L2 prefetch and evict-first stores, 81%.
// - The short rows take the 24-value form, which holds fewer registers and
//   keeps more warps resident.
// - Rows longer than 2304 (Qwen2-VL above 672 px: 3136 patches at 784 px)
//   take a second form, attn_softmax_rows_long: a warp a row that reads it
//   three times (max, sum, quotients; the second and third reads mostly
//   from L2) and takes the exponent twice, with the same arithmetic. No
//   cell of the benchmark runs it.
//
// Numerics, step for step the plain version's
// (kernels/attn_softmax.py::scaled_softmax_plain,
// softmax(x.float() * scale).to(x.dtype)): each value widened to f32 and
// multiplied by the f32 scale; the row's max; exp(x - max) with expf (not
// __expf) and their f32 sum; the quotient, rounded to nearest even in the
// output type. The products, differences and sums are the _rn intrinsics,
// so the compiler cannot contract them into FMAs. Only the sum's order
// differs from PyTorch's (a warp's butterfly): within 1 ulp of bf16, a few
// ulps of f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;              // rows a block, a warp each

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;       // values in 16 bytes
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void unpack(const uint4& r, float* o) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// a / s, correctly rounded, from r = RN(1 / s): one FMA correction of RN(a * r)
__device__ __forceinline__ float quotient(float a, float s, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-s, q, a), r, q);
}

// A row's layout and its values, held by one warp.
template <typename T, int kPerLane>
struct Row {
  static constexpr int kVec = Elem<T>::kVec;
  static constexpr int kVecs = kPerLane / kVec;   // 16-byte vectors a lane
  T* p;
  int head, nvec, tail_at, tail;
  uint4 raw[kVecs];
  float hv, tv;   // this lane's head and tail value

  // Starts the row's loads (x + row * L).
  __device__ __forceinline__ void load(T* x, long long row, int L, int lane) {
    p = x + row * L;
    // head: the values before the row's first 16-byte boundary
    head = min((int)(((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) / sizeof(T)), L);
    nvec = (L - head) / kVec;
    tail_at = head + nvec * kVec;
    tail = L - tail_at;
    const uint4* body = reinterpret_cast<const uint4*>(p + head);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nvec) raw[i] = body[lane + 32 * i];
    }
    hv = lane < head ? Elem<T>::load(p + lane) : 0.f;
    tv = lane < tail ? Elem<T>::load(p + tail_at + lane) : 0.f;
  }

  // Writes softmax(x * scale) over the row.
  __device__ __forceinline__ void softmax(float scale, int lane) {
    using E = Elem<T>;
    // x * scale and the row's max
    float v[kVecs][kVec];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nvec) {
        E::unpack(raw[i], v[i]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[i][e] = __fmul_rn(v[i][e], scale);
          m = fmaxf(m, v[i][e]);
        }
      }
    }
    if (lane < head) {
      hv = __fmul_rn(hv, scale);
      m = fmaxf(m, hv);
    }
    if (lane < tail) {
      tv = __fmul_rn(tv, scale);
      m = fmaxf(m, tv);
    }
    m = warp_max(m);

    // exp(x - max), kept, and its sum
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nvec) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          v[i][e] = expf(__fsub_rn(v[i][e], m));
          s = __fadd_rn(s, v[i][e]);
        }
      }
    }
    if (lane < head) {
      hv = expf(__fsub_rn(hv, m));
      s = __fadd_rn(s, hv);
    }
    if (lane < tail) {
      tv = expf(__fsub_rn(tv, m));
      s = __fadd_rn(s, tv);
    }
    s = warp_sum(s);

    // the quotients, over the logits
    const float r = __frcp_rn(s);
    uint4* body = reinterpret_cast<uint4*>(p + head);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      if (lane + 32 * i < nvec) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = quotient(v[i][e], s, r);
        __stcs(body + lane + 32 * i, E::pack(o));
      }
    }
    if (lane < head) E::store(p + lane, quotient(hv, s, r));
    if (lane < tail) E::store(p + tail_at + lane, quotient(tv, s, r));
  }
};

// One bulk prefetch into L2 of the 16-byte-aligned part of row ``row``.
template <typename T>
__device__ __forceinline__ void prefetch_row(const T* x, long long row, int L) {
  const uintptr_t b = ((uintptr_t)(x + row * L) + 15) & ~(uintptr_t)15;
  const uintptr_t e = (uintptr_t)(x + (row + 1) * L) & ~(uintptr_t)15;
  if (e > b) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(b), "r"((uint32_t)(e - b)) : "memory");
  }
}

template <typename T, int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
attn_softmax_rows(T* __restrict__ x, long long rows, int L, float scale) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  Row<T, kPerLane> cur, next;
  cur.load(x, row, L, lane);
  if (lane == 0 && row + stride < rows) prefetch_row(x, row + stride, L);
  while (true) {
    const bool more = row + stride < rows;
    if (lane == 0 && row + 2 * stride < rows) prefetch_row(x, row + 2 * stride, L);
    if (more) next.load(x, row + stride, L, lane);
    cur.softmax(scale, lane);
    if (!more) break;
    cur = next;
    row += stride;
  }
}

// Rows too long for the registers: three passes over the row, a warp each.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attn_softmax_rows_long(T* __restrict__ x, long long rows, int L, float scale) {
  using E = Elem<T>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  T* p = x + row * L;
  float m = -INFINITY;
  for (int j = lane; j < L; j += 32) m = fmaxf(m, __fmul_rn(E::load(p + j), scale));
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < L; j += 32) {
    s = __fadd_rn(s, expf(__fsub_rn(__fmul_rn(E::load(p + j), scale), m)));
  }
  s = warp_sum(s);
  const float r = __frcp_rn(s);
  for (int j = lane; j < L; j += 32) {
    E::store(p + j, quotient(expf(__fsub_rn(__fmul_rn(E::load(p + j), scale), m)), s, r));
  }
}

template <typename T, int kPerLane>
cudaError_t launch(void* x, long long rows, int L, float scale, cudaStream_t stream) {
  // persistent: as many blocks as fit on the card at once, fewer where the
  // rows give each warp less than one
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, attn_softmax_rows<T, kPerLane>,
                                                  kWarps * 32, 0);
    return n;
  }();
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long blocks =
      std::min((rows + kWarps - 1) / kWarps, (long long)std::max(per_sm, 1) * n_sm);
  attn_softmax_rows<T, kPerLane>
      <<<(unsigned)blocks, kWarps * 32, 0, stream>>>(static_cast<T*>(x), rows, L, scale);
  return cudaGetLastError();
}

// The register form that holds a row of L, or the long-row form.
template <typename T>
cudaError_t dispatch(void* x, long long rows, int L, float scale, cudaStream_t stream) {
  constexpr int kVec = Elem<T>::kVec;
  const int need = (L / kVec + 31) / 32 * kVec;   // body values of the fullest lane
  if (need <= 24) return launch<T, 24>(x, rows, L, scale, stream);
  if (need <= 72) return launch<T, 72>(x, rows, L, scale, stream);
  attn_softmax_rows_long<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kWarps * 32, 0,
                              stream>>>(static_cast<T*>(x), rows, L, scale);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, L) contiguous, bf16 (elem_bytes 2) or f32 (4), overwritten by
// softmax(x * scale) along L. Returns cudaGetLastError after the launch.
extern "C" int attwarp_attn_softmax(void* x, long long rows, int L, int elem_bytes,
                                    float scale, void* stream) {
  if (rows <= 0 || L <= 0 ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return (int)dispatch<__nv_bfloat16>(x, rows, L, scale, st);
  if (elem_bytes == 4) return (int)dispatch<float>(x, rows, L, scale, st);
  return (int)cudaErrorInvalidValue;
}
