// Kernel K2: causal prefill attention with left padding, for Hopper
// (sm_90a).
//
// Replaces: attwarp_tpu/models/llama.py::_flash_attn, which calls JAX's
// Pallas TPU flash_attention with segment ids (padding = 1, valid = 2),
// causal, over GQA heads that _repeat_kv has copied out first.
//
// out[b, i, h, :] = softmax_j(q[b,i,h] . k[b,j,g] * sm_scale) . v[b,j,g],
// g = h / (H / kvH), over the keys j <= i whose segment equals row i's
// (seg = mask ? 2 : 1). Every row attends at least itself, so no row is
// all-masked and padded rows stay finite, as in JAX.
//
// What bounds it on the H100: tensor-core work. Per (b, h) the causal
// half of T x T x 128 twice (q.k and p.v) is ~T^2 * 256 flops against
// 2 * T * 256 bytes of K/V, far above the ~295 flops per byte where bf16
// compute, not HBM, becomes the limit. So the design keeps q, the scores
// and the output in registers, feeds the tensor cores with mma.sync, and
// never writes a (T, T) matrix anywhere.
//
// Design (simple and right first; no TMA, no wgmma, no pipelining):
// - one block of 4 warps per (64-query tile, head, batch row); each warp
//   owns 16 query rows; the heaviest (last) query tiles launch first;
// - q's fragments for all of head_dim stay in registers (32 x 32 bit);
// - K/V tiles of 64 keys are staged through shared memory, K row-major and
//   V transposed, so every mma operand is one 32-bit shared load;
// - S = q.k^T with mma.sync m16n8k16 bf16 -> f32; the mask is applied by
//   select (-inf), never by multiplying by 0; online softmax in f32 (base 2,
//   sm_scale folded into log2(e)); P is rounded to bf16 for the p.v mma;
// - key tiles wholly above the diagonal are skipped; a ragged T is handled
//   by bounds checks (keys past T are zero-filled and never match a row).
// head_dim 128 only, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;                 // head_dim this kernel takes
constexpr int kBlockQ = 64;              // query rows per block
constexpr int kBlockK = 64;              // keys per shared-memory tile
constexpr int kWarps = kBlockQ / 16;     // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr int kKStride = kHd + 8;        // padded smem rows: conflict-free
constexpr int kVtStride = kBlockK + 8;   //   32-bit fragment loads
constexpr uint8_t kSegPastEnd = 3;       // key past T: matches no row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b for one m16n8k16 tile: a 16x16 row-major, b 16x8 column-major.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,   // (B, T, H, hd)
                     const __nv_bfloat16* __restrict__ k,   // (B, T, kvH, hd)
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,      // (B, T)
                     __nv_bfloat16* __restrict__ out,       // (B, T, H * hd)
                     int T, int H, int kvH, float scale_log2) {
  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / kvH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;    // fragment column pair

  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 sVt[kHd * kVtStride];
  __shared__ uint8_t sSeg[kBlockK];

  // this thread's two query rows; a row past T has segment 0 (no key)
  const int row0 = qt * kBlockQ + warp * 16 + gid;
  const int row1 = row0 + 8;
  const uint8_t* mrow = mask + (size_t)b * T;
  const int seg0 = row0 < T ? (mrow[row0] ? 2 : 1) : 0;
  const int seg1 = row1 < T ? (mrow[row1] ? 2 : 1) : 0;

  // q fragments (A operand) for the warp's 16 rows over all of head_dim
  uint32_t qf[kHd / 16][4];
  {
    const size_t rs = (size_t)H * kHd;
    const __nv_bfloat16* q0 = q + (size_t)b * T * rs + (size_t)h * kHd;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = row0 < T ? ld32(q0 + row0 * rs + c) : 0u;
      qf[kk][1] = row1 < T ? ld32(q0 + row1 * rs + c) : 0u;
      qf[kk][2] = row0 < T ? ld32(q0 + row0 * rs + c + 8) : 0u;
      qf[kk][3] = row1 < T ? ld32(q0 + row1 * rs + c + 8) : 0u;
    }
  }

  // output accumulators: 16 tiles of 8 columns, rows row0 ([0], [1]) and
  // row1 ([2], [3]); m and l per row (l partial over this thread's columns)
  float o[kHd / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHd / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int q_last = min(T, (qt + 1) * kBlockQ) - 1;
  const int n_kt = q_last / kBlockK + 1;   // tiles above the diagonal skipped
  for (int kt = 0; kt < n_kt; ++kt) {
    const int key0 = kt * kBlockK;
    __syncthreads();   // every warp is done with the previous tile
    for (int i = tid; i < kBlockK * (kHd / 8); i += kThreads) {
      const int r = i / (kHd / 8);
      const int c = (i % (kHd / 8)) * 8;
      const int key = key0 + r;
      int4 kv4 = make_int4(0, 0, 0, 0);
      int4 vv4 = make_int4(0, 0, 0, 0);
      if (key < T) {
        const size_t off = (((size_t)b * T + key) * kvH + g) * kHd + c;
        kv4 = __ldg(reinterpret_cast<const int4*>(k + off));
        vv4 = __ldg(reinterpret_cast<const int4*>(v + off));
      }
      *reinterpret_cast<int4*>(sK + r * kKStride + c) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) sVt[(c + j) * kVtStride + r] = ve[j];
    }
    if (tid < kBlockK) {
      const int key = key0 + tid;
      sSeg[tid] = key < T ? (mrow[key] ? 2 : 1) : kSegPastEnd;
    }
    __syncthreads();

    // S = q . k^T for the warp's 16 rows x 64 keys: 8 tiles of 8 keys
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sK + (nt * 8 + gid) * kKStride + tig * 2;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const uint32_t bf[2] = {ld32(kr + kk * 16), ld32(kr + kk * 16 + 8)};
        mma_bf16(s[nt], qf[kk], bf);
      }
    }

    // mask by select, then the online-softmax update in base 2
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = nt * 8 + tig * 2 + e;
        const int key = key0 + kc;
        const int ks = sSeg[kc];
        const float v0 = s[nt][e] * scale_log2;
        const float v1 = s[nt][2 + e] * scale_log2;
        s[nt][e] = (key <= row0 && ks == seg0) ? v0 : -INFINITY;
        s[nt][2 + e] = (key <= row1 && ks == seg1) ? v1 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    // the 4 threads of a fragment row hold its 64 columns between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // a row with no valid key so far keeps m = -inf: shift by 0 so that
    // exp2 gives 0 and never -inf - -inf = NaN
    const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
    const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - sh0);
    const float al1 = exp2f(m1 - sh1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - sh0);
      s[nt][1] = exp2f(s[nt][1] - sh0);
      s[nt][2] = exp2f(s[nt][2] - sh1);
      s[nt][3] = exp2f(s[nt][3] - sh1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int dt = 0; dt < kHd / 8; ++dt) {
      o[dt][0] *= al0;
      o[dt][1] *= al0;
      o[dt][2] *= al1;
      o[dt][3] *= al1;
    }

    // o += P . V: the score tiles are the A fragments of the next mma
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dt = 0; dt < kHd / 8; ++dt) {
        const __nv_bfloat16* vr =
            sVt + (dt * 8 + gid) * kVtStride + kk * 16 + tig * 2;
        const uint32_t bf[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16(o[dt], pa, bf);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const size_t rs = (size_t)H * kHd;
  __nv_bfloat16* o0 = out + (size_t)b * T * rs + (size_t)h * kHd + tig * 2;
#pragma unroll
  for (int dt = 0; dt < kHd / 8; ++dt) {
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(o0 + row0 * rs + dt * 8) =
          pack_bf16(o[dt][0] * inv0, o[dt][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(o0 + row1 * rs + dt * 8) =
          pack_bf16(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int attwarp_flash_prefill(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int B, int T, int H, int kvH,
                                     int hd, float sm_scale, void* stream) {
  if (hd != kHd || B <= 0 || T <= 0 || H <= 0 || kvH <= 0 || H % kvH != 0 ||
      B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, H, B);
  flash_prefill_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), T, H, kvH,
      sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
