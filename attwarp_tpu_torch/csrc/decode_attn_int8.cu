// Kernel K3: one-token (decode) attention over the int8 KV cache, for
// Hopper (sm_90a).
//
// Replaces: attwarp_tpu/ops/pallas_decode_attn.py::decode_attn_quantcache
// (body _kernel), the TPU flash-decoding kernel that streams the int8 cache
// once, widens and scales it on-chip and keeps online-softmax state in VMEM
// across a sequential grid over sequence tiles.
//
// What bounds it on the H100: memory. Per (batch row, kv head) it reads the
// int8 K and V rows of the positions the mask allows (head_dim bytes each)
// plus two f32 scales per position, and does 4 * head_dim flops per
// position and query head: ~2 flops per byte at n_rep 1, far below any
// compute limit. In a decode step each layer's plane comes cold from HBM,
// 3-100 MB at the decode batches of the main path (B = 4-16), a few to a
// few tens of microseconds at 3.35 TB/s. A kernel near that bound must keep
// enough bytes in flight to cover HBM's latency on every SM, and must not
// add a chain of dependent steps per block on top.
//
// Design: flash-decoding over splits of S (the plan comes from Python,
// kernels/decode_attn.py::decode_split_plan), each split read in one go.
// - grid (split, kv head g x head group, batch row b): one block of 256
//   threads serves up to 8 query heads of kv head g (all n_rep of them
//   where n_rep <= 8), so each K/V row is read once per 8 heads; chunks of
//   at most kMaxLen positions, enough splits that the grid fills the card
//   (one wave of blocks takes the whole plane where it fits, more and
//   smaller blocks stream it where not), one split where the batch alone
//   fills it (then no merge);
// - each thread reads its rows' mask bytes, then the block issues the
//   cp.async copies of every allowed K and V row of its chunk and their
//   scales at once (one commit group per 64-position sub-tile), so the
//   whole chunk is in flight: masked positions (left padding, past cur, a
//   free slot's tail) load nothing, and a chunk with none leaves a partial
//   with m = -inf;
// - q.k on the tensor cores (mma.sync m16n8k16, f16 in, f32 sums) for each
//   sub-tile as its group lands: K's int8 rows widen exactly to f16 (a
//   byte_perm into a half's mantissa), q is scaled per head by a power of 2
//   into f16's range, so every product is exact and only the f32 sums
//   round;
// - one softmax per head over the whole chunk in f32, base 2 (no online
//   rescale inside a block; MHA a thread per position, GQA a warp per
//   head); masked positions are dropped by select, never by multiplying
//   by 0;
// - p.v with f32 sums: under MHA on the CUDA cores, the warps splitting the
//   positions and meeting in shared memory; under GQA on the tensor cores
//   (the heads as the mma's rows, the warps splitting the dims), P going in
//   as a high and a low f16 part so that its products keep ~22 bits;
// - with more than one split, partials (m, l, acc[128]) go to scratch that
//   the wrapper allocates and a second small kernel merges them, reading
//   up to 16 splits' partials in one round of loads; it is launched as a
//   programmatic dependent of the first, so its launch overlaps the first
//   kernel's last blocks.
// The cache is passed whole with a layer index, so no plane is copied. The
// caller has already written the current token into the cache, and the
// mask (B, S) includes it.
//
// Numerics: q.k and p.v accumulate in f32 (the plain version rounds them to
// q's dtype first, as the JAX form does), softmax in f32. A row with no
// valid position returns zeros.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;              // head_dim this kernel takes
constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 64;              // positions per sub-tile (one commit group)
constexpr int kMaxLen = 256;          // positions per split: the chunk lives in smem
constexpr int kMaxSub = kMaxLen / kSub;
static_assert(kMaxLen == kThreads, "MHA's softmax takes a position per thread");
constexpr int kQRow = kHd + 8;        // smem row stride of q (halves): conflict-free
constexpr int kMaxRep = 8;            // query heads per block (one mma's n)
constexpr int kMergeBatch = 16;       // splits whose partials the merge reads at once
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// byte ``off`` of a 128-byte K or V row ``t`` in shared memory: its 16-byte
// chunk XOR (t % 8), so the mma's eight rows and a warp's row read hit
// distinct banks with no padding
__device__ __forceinline__ int swz(int t, int off) {
  return ((((off >> 4) ^ t) & 7) << 4) | (off & 15);
}

// wait until at most ``pending`` of this thread's commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Four int8 (one 32-bit word) to two f16 pairs, exactly: each byte with its
// sign bit flipped (x + 128) becomes the low mantissa byte of 1024.0, and
// subtracting 1152 leaves x. lo holds bytes 0 and 1, hi bytes 2 and 3.
__device__ __forceinline__ void widen_f16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const __half2 off = __half2half2(__ushort_as_half(0x6480));
  uint32_t a = __byte_perm(u, 0x64646464u, 0x4140);
  uint32_t b = __byte_perm(u, 0x64646464u, 0x4342);
  __half2 ha = __hsub2(*reinterpret_cast<__half2*>(&a), off);
  __half2 hb = __hsub2(*reinterpret_cast<__half2*>(&b), off);
  lo = *reinterpret_cast<uint32_t*>(&ha);
  hi = *reinterpret_cast<uint32_t*>(&hb);
}

// Four int8 to f32, exactly, the same way into 2^23's mantissa.
__device__ __forceinline__ void widen_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)) - 8388736.f;
}

// c += a . b for one m16n8k16 tile, f16 in, f32 accumulate
__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared memory of one block, carved from the dynamic allocation, for a
// chunk of ``len`` positions (a multiple of 16):
//   sK       [max(len, 32)][128] int8, its 16-byte chunks swizzled (swz);
//            under MHA the warps' p.v sums [kWarps][128] f32 reuse it
//   sV       [len][128] int8, swizzled
//   sKs, sVs [len] f32
//   sS       [2][rep][len] f32   q.k halves over dims, then p * v_scale
//   sQh      [kMaxRep][kQRow] f16   q scaled per head (zero rows pad to 8)
//   sQs, sM, sL [kMaxRep] f32   each head's q scale (a power of 2), max, sum
//   sMask    [len] u8
__host__ __device__ inline size_t smem_bytes(int len, int rep) {
  const size_t lp = len;
  return (lp > 32 ? lp : 32) * kHd + lp * kHd + 2 * lp * 4 + 2 * (size_t)rep * lp * 4 +
         (size_t)kMaxRep * kQRow * 2 + (size_t)kMaxRep * 12 + lp;
}

template <int REP>   // query heads per block: 1 (MHA), or up to kMaxRep (GQA)
__device__ __forceinline__ void
decode_attn_body(const __nv_bfloat16* __restrict__ q,   // (B, H, hd)
                 const int8_t* __restrict__ k_q,        // (L, B, S, kvH, hd)
                 const float* __restrict__ k_s,         // (L, B, S, kvH)
                 const int8_t* __restrict__ v_q,
                 const float* __restrict__ v_s,
                 const uint8_t* __restrict__ mask,      // (B, S)
                 __nv_bfloat16* __restrict__ out,       // (B, H, hd)
                 float* __restrict__ part_ml,           // (B, H, n_split, 2)
                 float* __restrict__ part_acc,          // (B, H, n_split, hd)
                 int B, int S, int H, int kvH, int layer, int len,
                 float scale_log2) {
  const int n_rep = H / kvH;
  const int n_hg = REP == 1 ? 1 : (n_rep + kMaxRep - 1) / kMaxRep;   // head groups
  const int split = blockIdx.x;
  const int g = blockIdx.y / n_hg;
  const int hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int nh = REP == 1 ? 1 : min(kMaxRep, n_rep - hg * kMaxRep);   // heads of the block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int t0 = split * len;
  const int n = min(len, S - t0);   // positions of this split
  const int n_sub = (n + kSub - 1) / kSub;
  const int lp = len;
  // the merge kernel may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem);
  int8_t* sV = sK + (size_t)max(lp, 32) * kHd;
  float* sKs = reinterpret_cast<float*>(sV + (size_t)lp * kHd);
  float* sVs = sKs + lp;
  float* sS = sVs + lp;
  __half* sQh = reinterpret_cast<__half*>(sS + 2 * REP * lp);
  float* sQs = reinterpret_cast<float*>(sQh + kMaxRep * kQRow);
  float* sM = sQs + kMaxRep;
  float* sL = sM + kMaxRep;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sL + kMaxRep);

  // every allowed row of the chunk at once: thread (r, c) copies the 16
  // bytes at c * 16 of rows r and r + 32 of each sub-tile, of K and of V,
  // so a warp's copy is 4 whole 128-byte rows; c 0 and 1 copy the rows'
  // scales. Its mask bytes are read first, all together.
  const int r = tid >> 3, c = tid & 7;
  const uint8_t* mrow = mask + (size_t)b * S + t0;
  bool ok[kMaxSub][2];
#pragma unroll
  for (int i = 0; i < kMaxSub; ++i) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = i * kSub + u * 32 + r;
      ok[i][u] = t < n && mrow[t];
    }
  }
  // this warp's head of q (warp w reads head w of the block)
  const size_t bh0 = (size_t)b * H + (size_t)g * n_rep + hg * kMaxRep;   // first head
  float qv[4] = {0.f, 0.f, 0.f, 0.f};
  if (warp < nh) {
    const uint2 w2 = *reinterpret_cast<const uint2*>(q + (bh0 + warp) * kHd + lane * 4);
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w2);
    const float2 a = __bfloat1622float2(p2[0]), c2 = __bfloat1622float2(p2[1]);
    qv[0] = a.x, qv[1] = a.y, qv[2] = c2.x, qv[3] = c2.y;
  }
  const size_t row0 = (((size_t)layer * B + b) * S + t0) * kvH + g;   // (layer, b, t0, g)
  bool any = false;
#pragma unroll
  for (int i = 0; i < kMaxSub; ++i) {
    if (i < n_sub) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = i * kSub + u * 32 + r;
        if (ok[i][u]) {
          const size_t row = row0 + (size_t)t * kvH;
          cp_async16(sK + (size_t)t * kHd + swz(t, c * 16), k_q + row * kHd + c * 16);
          cp_async16(sV + (size_t)t * kHd + swz(t, c * 16), v_q + row * kHd + c * 16);
          if (c == 0) cp_async4(sKs + t, k_s + row);
          if (c == 1) cp_async4(sVs + t, v_s + row);
          any = true;
        }
        if (c == 0 && t < n) sMask[t] = ok[i][u];
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
  if (!__syncthreads_or(any)) {
    // no valid position: zeros if this is the only split, else a partial
    // with m = -inf, which the merge skips (its l and acc are never read)
    if (n_split == 1) {
      for (int i = tid; i < nh * kHd; i += kThreads) out[bh0 * kHd + i] = __float2bfloat16(0.f);
    } else {
      for (int h = tid; h < nh; h += kThreads)
        part_ml[((bh0 + h) * n_split + split) * 2] = -INFINITY;
    }
    return;
  }

  // q while the copies fly: per head a power-of-2 scale that puts max|q|
  // below 2^14, so every bf16 value is exact in f16 down to 2^-28 of the max
  {
    const float mx = warp_max(fmaxf(fmaxf(fabsf(qv[0]), fabsf(qv[1])),
                                    fmaxf(fabsf(qv[2]), fabsf(qv[3]))));
    int e = 0;
    frexpf(mx, &e);                        // mx = f * 2^e, f in [0.5, 1)
    const float inv = mx > 0.f ? ldexpf(1.f, 14 - e) : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sQh[warp * kQRow + lane * 4 + j] = __float2half_rn(qv[j] * inv);
    if (lane == 0) sQs[warp] = 1.f / inv;   // kWarps == kMaxRep
  }

  // q.k, a sub-tile as its group lands: warp w takes 16 positions (w % 4)
  // over 64 dims (w / 4), 4 mma steps of 16 dims. The thread's A fragment
  // is the 4 bytes at dims 4 * tig of a step (rows gid and gid + 8); its B
  // fragment takes q at the same dims, so the product is the same sum in
  // another order.
  const int mt = warp & 3;
  const int half = warp >> 2;
  for (int i = 0; i < n_sub; ++i) {
    cp_async_wait(n_sub - 1 - i);
    __syncthreads();   // sub-tile i (and q) in for every thread
    const int p0 = i * kSub + mt * 16;
    if (p0 < n) {
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
      // rows p0 + gid and p0 + gid + 8 share their swizzle (p0 % 16 == 0)
      const int8_t* k0 = sK + (size_t)(p0 + gid) * kHd;
      const __half* qr = sQh + gid * kQRow + half * 64 + tig * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t a[4], bq[2];
        const int off = swz(gid, half * 64 + c * 16 + tig * 4);
        widen_f16(*reinterpret_cast<const uint32_t*>(k0 + off), a[0], a[2]);
        widen_f16(*reinterpret_cast<const uint32_t*>(k0 + 8 * kHd + off), a[1], a[3]);
        bq[0] = *reinterpret_cast<const uint32_t*>(qr + c * 16);
        bq[1] = *reinterpret_cast<const uint32_t*>(qr + c * 16 + 2);
        mma_f16(c4, a, bq);
      }
      // c4: positions gid, gid + 8 (rows); heads 2 tig, 2 tig + 1 (columns)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = p0 + gid + (e >> 1) * 8;
        const int h = tig * 2 + (e & 1);
        if (h < nh) sS[(half * REP + h) * lp + t] = c4[e];
      }
    }
  }
  __syncthreads();

  // softmax per head over the chunk in f32, base 2: max m, p = 2^(s - m)
  // times v's scale, l = sum p. MHA: a thread per position, the warps
  // meet in shared memory; GQA: a warp per head.
  if (REP == 1) {
    __shared__ float sRedM[kWarps], sRedL[kWarps];
    const int t = tid;   // kMaxLen == kThreads
    const bool valid = t < n && sMask[t];
    const float sc = valid ? (sS[t] + sS[lp + t]) * sQs[0] * sKs[t] * scale_log2 : -INFINITY;
    const float mw = warp_max(sc);
    if (lane == 0) sRedM[warp] = mw;
    __syncthreads();
    float mx = sRedM[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sRedM[w]);
    const float sh = mx == -INFINITY ? 0.f : mx;
    const float p = valid ? exp2f(sc - sh) : 0.f;
    if (t < lp) sS[t] = valid ? p * sVs[t] : 0.f;
    const float lw = warp_sum(p);
    if (lane == 0) sRedL[warp] = lw;
    __syncthreads();
    if (tid == 0) {
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) l += sRedL[w];
      sM[0] = mx;
      sL[0] = l;
    }
  } else if (warp < nh) {
    const int h = warp;
    constexpr int kPer = kMaxLen / 32;
    float sc[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = lane + e * 32;
      const bool valid = t < n && sMask[t];
      sc[e] = valid ? (sS[h * lp + t] + sS[(REP + h) * lp + t]) * sQs[h] * sKs[t] * scale_log2
                    : -INFINITY;
      mx = fmaxf(mx, sc[e]);
    }
    const float m = warp_max(mx);
    const float sh = m == -INFINITY ? 0.f : m;
    float l = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int t = lane + e * 32;
      if (t < lp) {
        const bool valid = t < n && sMask[t];
        const float p = valid ? exp2f(sc[e] - sh) : 0.f;
        l += p;
        sS[h * lp + t] = valid ? p * sVs[t] : 0.f;
      }
    }
    l = warp_sum(l);
    if (lane == 0) {
      sM[h] = m;
      sL[h] = l;
    }
  }
  __syncthreads();

  // p.v in f32, each lane the dims 4 lane ... 4 lane + 3 of a V row
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int h = warp;          // the head whose sums this thread writes
  int d = lane * 4;      // and its first dim
  if (REP == 1) {
    // MHA: warp w the positions w, w + 8, ...; the warps meet in sK
    for (int t = warp; t < n; t += kWarps) {
      float v[4];
      widen_f32(*reinterpret_cast<const uint32_t*>(sV + t * kHd + swz(t, lane * 4)), v);
      const float p = sS[t];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += p * v[j];
    }
    float* sRed = reinterpret_cast<float*>(sK);   // [kWarps][128]
    reinterpret_cast<float4*>(sRed + warp * kHd)[lane] =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (tid >= kHd / 4) return;
    h = 0;
    d = tid * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += sRed[w * kHd + d + j];
      acc[j] = o;
    }
  } else {
    // GQA: P.V on the tensor cores (mma m16n8k16, f16 in, f32 sums), the
    // heads as rows (8 of 16 used), 16 positions a k-step, warp w the dims
    // 16 w ... 16 w + 15 (two n-tiles). P (with v's scale) goes in as a high
    // and a low f16 part, so the products keep ~22 bits of P; V's int8
    // widen exactly. No reduction across warps.
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int n_k = (n + 15) / 16;
    for (int kb = 0; kb < n_k; ++kb) {
      const int tk = kb * 16 + 2 * tig;   // this thread's positions tk, tk + 1, tk + 8, tk + 9
      uint32_t ahi[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
      if (gid < nh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 pp = *reinterpret_cast<const float2*>(sS + gid * lp + tk + 8 * e);
          const __half2 hi = __floats2half2_rn(pp.x, pp.y);
          const float2 hf = __half22float2(hi);
          const __half2 lo = __floats2half2_rn(pp.x - hf.x, pp.y - hf.y);
          ahi[2 * e] = *reinterpret_cast<const uint32_t*>(&hi);
          alo[2 * e] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int dc = warp * 16 + nt * 8 + gid;
        uint32_t bv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = tk + 8 * e;
          const __half2 v2 = __halves2half2(__int2half_rn(sV[t * kHd + swz(t, dc)]),
                                            __int2half_rn(sV[(t + 1) * kHd + swz(t + 1, dc)]));
          bv[e] = *reinterpret_cast<const uint32_t*>(&v2);
        }
        mma_f16(o[nt], ahi, bv);
        mma_f16(o[nt], alo, bv);
      }
    }
    // o[nt][0..1]: head gid, dims 16 warp + 8 nt + 2 tig and + 1 (rows
    // 8-15, o[nt][2..3], are the padding)
    if (gid >= nh) return;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int dd = warp * 16 + nt * 8 + 2 * tig;
      if (n_split == 1) {
        const float inv = 1.f / sL[gid];
        *reinterpret_cast<__nv_bfloat162*>(out + (bh0 + gid) * kHd + dd) =
            __floats2bfloat162_rn(o[nt][0] * inv, o[nt][1] * inv);
      } else {
        const size_t pi = (bh0 + gid) * n_split + split;
        *reinterpret_cast<float2*>(part_acc + pi * kHd + dd) = make_float2(o[nt][0], o[nt][1]);
        if (dd == 0) {
          part_ml[pi * 2] = sM[gid];
          part_ml[pi * 2 + 1] = sL[gid];
        }
      }
    }
    return;
  }
  // the output (one split) or this split's partial
  if (n_split == 1) {
    const float inv = 1.f / sL[h];
    __nv_bfloat162 o2[2] = {__floats2bfloat162_rn(acc[0] * inv, acc[1] * inv),
                            __floats2bfloat162_rn(acc[2] * inv, acc[3] * inv)};
    *reinterpret_cast<uint2*>(out + (bh0 + h) * kHd + d) = *reinterpret_cast<uint2*>(o2);
  } else {
    const size_t pi = (bh0 + h) * n_split + split;
    *reinterpret_cast<float4*>(part_acc + pi * kHd + d) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (d == 0) {
      part_ml[pi * 2] = sM[h];
      part_ml[pi * 2 + 1] = sL[h];
    }
  }
}

#define K3_ARGS                                                                       \
  const __nv_bfloat16 *__restrict__ q, const int8_t *__restrict__ k_q,               \
      const float *__restrict__ k_s, const int8_t *__restrict__ v_q,                 \
      const float *__restrict__ v_s, const uint8_t *__restrict__ mask,               \
      __nv_bfloat16 *__restrict__ out, float *__restrict__ part_ml,                  \
      float *__restrict__ part_acc, int B, int S, int H, int kvH, int layer, int len, \
      float scale_log2
#define K3_PASS q, k_q, k_s, v_q, v_s, mask, out, part_ml, part_acc, B, S, H, kvH, layer, len, \
                scale_log2

__global__ void __launch_bounds__(kThreads, 4) decode_attn_mha(K3_ARGS) {
  decode_attn_body<1>(K3_PASS);
}
__global__ void __launch_bounds__(kThreads, 4) decode_attn_gqa(K3_ARGS) {
  decode_attn_body<kMaxRep>(K3_PASS);
}

// out[b, h] = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M) over the
// splits with a finite m_s; zeros where none has one. One block per (b, h),
// one thread per dim; the splits' (m, l) and acc are read kMergeBatch at a
// time, all loads of a batch at once, the sums rescaled as the max grows.
__global__ void __launch_bounds__(kHd)
decode_merge_kernel(const float* part_ml, const float* part_acc,
                    __nv_bfloat16* __restrict__ out, int n_split) {
  // launched early (programmatic dependent launch): wait for the split
  // kernel to finish and its partials to be visible. The partials are read
  // through plain (not __restrict__, not read-only) pointers, so that no
  // load moves above the wait onto the read-only path.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + bh * n_split;
  const float* acc = part_acc + bh * n_split * kHd + d;
  float M = -INFINITY, L = 0.f, o = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kMergeBatch) {
    float2 m_l[kMergeBatch];
    float a[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const bool in = s0 + j < n_split;
      m_l[j] = in ? ml[s0 + j] : make_float2(-INFINITY, 0.f);
      a[j] = in ? acc[(size_t)(s0 + j) * kHd] : 0.f;
    }
    float Mb = M;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) Mb = fmaxf(Mb, m_l[j].x);
    // an empty split's l and acc were never written: read, then dropped by
    // select
    const float r = M > -INFINITY ? exp2f(M - Mb) : 0.f;
    L = r > 0.f ? L * r : 0.f;
    o = r > 0.f ? o * r : 0.f;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const float w = m_l[j].x > -INFINITY ? exp2f(m_l[j].x - Mb) : 0.f;
      L += w > 0.f ? w * m_l[j].y : 0.f;
      o += w > 0.f ? w * a[j] : 0.f;
    }
    M = Mb;
  }
  out[bh * kHd + d] = __float2bfloat16(M > -INFINITY ? o / L : 0.f);
}

template <int REP>
int launch(const void* q, const void* k_q, const void* k_s, const void* v_q,
           const void* v_s, const void* mask, void* out, void* scratch, int B, int S,
           int H, int kvH, int layer, int n_split, int len, float sm_scale,
           cudaStream_t st) {
  const auto kernel = REP == 1 ? decode_attn_mha : decode_attn_gqa;
  static bool attr_set = false;   // one per instantiation: the largest chunk's smem
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(kMaxLen, REP));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int n_hg = REP == 1 ? 1 : (H / kvH + kMaxRep - 1) / kMaxRep;
  // scratch: (B, H, n_split, hd) acc (16-byte aligned), then (B, H,
  // n_split, 2) m and l
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc ? part_acc + (size_t)B * H * n_split * kHd : nullptr;
  kernel<<<dim3(n_split, kvH * n_hg, B), kThreads, smem_bytes(len, REP), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_s), static_cast<const int8_t*>(v_q),
      static_cast<const float*>(v_s), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), part_ml, part_acc, B, S, H, kvH, layer, len,
      sm_scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  // the merge launches while the split kernel runs its last blocks, so its
  // launch latency hides behind them
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(kHd);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_merge_kernel, static_cast<const float*>(part_ml),
                                 static_cast<const float*>(part_acc),
                                 static_cast<__nv_bfloat16*>(out), n_split);
}

}  // namespace

extern "C" int attwarp_decode_attn_int8(const void* q, const void* k_q,
                                        const void* k_s, const void* v_q,
                                        const void* v_s, const void* mask,
                                        void* out, void* scratch, int L, int B, int S,
                                        int H, int kvH, int hd, int layer, int n_split,
                                        int chunk, float sm_scale, void* stream) {
  const long long n_hg = (H / (kvH > 0 ? kvH : 1) + kMaxRep - 1) / kMaxRep;
  if (hd != kHd || B <= 0 || S <= 0 || H <= 0 || kvH <= 0 || H % kvH != 0 || layer < 0 ||
      layer >= L || chunk <= 0 || chunk > kMaxLen || chunk % 16 != 0 ||
      n_split != (S + chunk - 1) / chunk || (long long)kvH * n_hg > 65535 || B > 65535 ||
      (long long)B * H > 0x7fffffffLL || (n_split > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return H == kvH ? launch<1>(q, k_q, k_s, v_q, v_s, mask, out, scratch, B, S, H, kvH,
                              layer, n_split, chunk, sm_scale, st)
                  : launch<kMaxRep>(q, k_q, k_s, v_q, v_s, mask, out, scratch, B, S, H,
                                    kvH, layer, n_split, chunk, sm_scale, st);
}
