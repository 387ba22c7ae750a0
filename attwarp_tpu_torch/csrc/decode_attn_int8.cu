// Kernel K3: one-token (decode) attention over the int8 KV cache, for
// Hopper (sm_90a).
//
// Replaces: attwarp_tpu/ops/pallas_decode_attn.py::decode_attn_quantcache
// (body _kernel), the TPU flash-decoding kernel that streams the int8 cache
// once, widens and scales it on-chip and keeps online-softmax state in VMEM
// across a sequential grid over sequence tiles.
//
// What bounds it on the H100: memory. Per (batch row, head) it reads S int8
// K rows and S int8 V rows of head_dim bytes plus two f32 scales per token,
// and does ~4 flops per cache byte: about 2 flops per byte with the
// scales, far below any compute limit. The whole win is reading the int8
// bytes exactly once and doing all widening, scaling, softmax and the PV
// sum on-chip.
//
// Design (simple and correct first; no TMA or wgmma):
// - one block of 256 threads per (head h, batch row b); kv head
//   g = h / (H / kvH) (GQA by index, no repeated cache);
// - 8 lanes cover one 128-byte K (or V) row, 16 bytes each (one int4
//   load), so a block has 32 token groups that stride over S;
// - each group keeps its own online-softmax state (m, l, acc[16] per lane)
//   over its tokens: score = (q . k_q) * k_s * sm_scale, masked tokens
//   skipped, acc += p * v_s * v_q;
// - the 32 group states merge in shared memory, one thread per output dim.
// The cache is passed whole with a layer index, so no plane is copied. The
// caller has already written the current token into the cache, and the
// mask (B, S) includes it.
//
// Numerics: q.k and p.v accumulate in f32 (the plain version rounds them to
// q's dtype first, as the JAX form does), softmax in f32. A row with no
// valid token returns zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;                       // head_dim this kernel takes
constexpr int kLanesPerTok = 8;                // 8 x 16 B = one int8 row
constexpr int kPerLane = kHd / kLanesPerTok;   // 16 values per lane
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanesPerTok;  // 32 token groups

__device__ __forceinline__ void unpack16(const int4 raw, float* f) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) f[i] = (float)v[i];
}

__global__ void __launch_bounds__(kThreads)
decode_attn_int8_kernel(const __nv_bfloat16* __restrict__ q,
                        const int8_t* __restrict__ k_q,
                        const float* __restrict__ k_s,
                        const int8_t* __restrict__ v_q,
                        const float* __restrict__ v_s,
                        const uint8_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out,
                        int B, int S, int H, int kvH, int layer,
                        float sm_scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / kvH);
  const int tid = threadIdx.x;
  const int grp = tid / kLanesPerTok;
  const int sub = tid % kLanesPerTok;

  float qf[kPerLane];
  const __nv_bfloat16* qrow = q + ((size_t)b * H + h) * kHd + sub * kPerLane;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) qf[i] = __bfloat162float(qrow[i]);

  const size_t tok0 = ((size_t)layer * B + b) * S;  // token (layer, b, 0)
  const uint8_t* mrow = mask + (size_t)b * S;
  float m = -INFINITY, l = 0.0f;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;

  // every lane runs the same trip count so the group shuffles never diverge
  for (int t0 = 0; t0 < S; t0 += kGroups) {
    const int t = t0 + grp;
    const bool valid = t < S && mrow[t] != 0;
    const size_t row = (tok0 + (size_t)(t < S ? t : 0)) * kvH + g;
    float dot = 0.0f;
    if (valid) {
      float kf[kPerLane];
      unpack16(__ldg(reinterpret_cast<const int4*>(k_q + row * kHd) + sub),
               kf);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) dot += qf[i] * kf[i];
    }
    // sum over the 8 lanes of this token group (aligned groups of 8)
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (valid) {
      const float s = dot * __ldg(k_s + row) * sm_scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float pw = p * __ldg(v_s + row);
      float vf[kPerLane];
      unpack16(__ldg(reinterpret_cast<const int4*>(v_q + row * kHd) + sub),
               vf);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] = acc[i] * alpha + pw * vf[i];
      m = m_new;
    }
  }

  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][kHd];
  if (sub == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) sm_acc[grp][sub * kPerLane + i] = acc[i];
  __syncthreads();

  if (tid < kHd) {
    float M = -INFINITY;
    for (int gi = 0; gi < kGroups; ++gi) M = fmaxf(M, sm_m[gi]);
    float o = 0.0f;
    if (M > -INFINITY) {
      float L = 0.0f;
      for (int gi = 0; gi < kGroups; ++gi) {
        const float w = expf(sm_m[gi] - M);  // 0 for groups with no token
        L += sm_l[gi] * w;
        o += sm_acc[gi][tid] * w;
      }
      o /= L;
    }
    out[((size_t)b * H + h) * kHd + tid] = __float2bfloat16(o);
  }
}

}  // namespace

extern "C" int attwarp_decode_attn_int8(const void* q, const void* k_q,
                                        const void* k_s, const void* v_q,
                                        const void* v_s, const void* mask,
                                        void* out, int L, int B, int S, int H,
                                        int kvH, int hd, int layer,
                                        float sm_scale, void* stream) {
  if (hd != kHd || B <= 0 || S <= 0 || H <= 0 || kvH <= 0 || H % kvH != 0 ||
      layer < 0 || layer >= L) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(H, B);
  decode_attn_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k_q), static_cast<const float*>(k_s),
      static_cast<const int8_t*>(v_q), static_cast<const float*>(v_s),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out),
      B, S, H, kvH, layer, sm_scale);
  return (int)cudaGetLastError();
}
