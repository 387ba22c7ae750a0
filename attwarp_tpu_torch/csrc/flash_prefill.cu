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
// What bounds it on the H100: about as much HBM as compute. At the path's
// shapes (T = 640-704, head_dim 128) the causal q.k and p.v come to ~160
// flops per byte of q, k, v and out: ~13 us of bf16 tensor-core work
// against ~12-25 us of HBM traffic at B = 4. A kernel near that bound must
// keep the tensor cores fed at Hopper's rate while the next K/V tiles
// stream in, and must read K/V once per kv head rather than once per query
// head.
//
// Design:
// - persistent: one block per SM walks the work items (a 128-query tile of
//   one head and batch row; see Item for the order): under GQA the n_rep
//   query heads of one kv head run side by side, and under MHA a block
//   takes a head's heavy and light query tiles as a pair, so K/V comes
//   from HBM about once and from L2 after; the next item's q, segments and
//   first K/V tiles load while the block finishes the last;
// - three warpgroups: a producer (warp 1 reads each item's segments into
//   shared memory and loads its q, an item ahead; lane 0 of warp 0 loads
//   the K/V tiles; setmaxnreg gives the producer's registers to the
//   consumers) and two consumer warpgroups of 64 query rows each;
// - TMA brings q (two slots) and 64-key K and V tiles (a ring of 4 stages,
//   full and empty mbarriers) into shared memory in the 128-byte swizzle
//   that wgmma reads; rows outside [0, T) come in as zeros (the query tiles
//   end at T, so a ragged T leaves rows below 0 in the lightest tile);
// - S = q.k^T with wgmma m64n64k16 (q and K from shared memory, K-major);
//   O += P.V with wgmma m64n128k16, P in registers as the A operand and V
//   read from shared memory as an MN-major B operand, so V is never
//   transposed; a tile's S is issued beside the previous tile's P.V, and
//   its softmax runs while that P.V is still on the tensor cores;
// - the mask by select (-inf), never by multiplying by 0; f32 online
//   softmax in base 2 (ex2 on the SFU, the scale folded into one FMA); a
//   row with no valid key so far shifts by 0, so no NaN; key tiles wholly
//   above the diagonal are never loaded, nor those whose keys are all in
//   another segment than every row of the tile (the first kSegPos
//   positions' segments are read once per item into shared memory; past
//   them, in a second instantiation of the kernel for T > kSegPos, a
//   position's segment comes from the mask in global memory and every key
//   tile is loaded);
// - the output goes back through shared memory and a TMA store, which
//   clips rows outside [0, T).
// head_dim 128 only, as on the TPU; any T.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;                 // head_dim this kernel takes
constexpr int kBlockQ = 128;             // query rows per block
constexpr int kBlockK = 64;              // keys per K/V tile
constexpr int kStages = 4;               // K/V ring depth
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kSegPos = 16384;           // positions whose segment is kept in smem
constexpr int kSegTiles = kSegPos / 64;  // key tiles with a segment summary
constexpr int kQHalf = kBlockQ * 128;    // bytes of q's 64-column half
constexpr int kKVHalf = kBlockK * 128;   // bytes of a K/V tile's half
constexpr int kQBytes = 2 * kQHalf;      // 32 KB
constexpr int kKVBytes = 2 * kKVHalf;    // 16 KB per K or V tile
constexpr uint8_t kSegPastEnd = 3;       // key past T: matches no row
constexpr uint8_t kMixed = 0xff;         // a tile with more than one segment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// waits for the phase after ``parity``; a wait of more than ~2^32 cycles
// (over a second) can only be a fault, and traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  }
}

// 4-D TMA load of one box into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
        "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: address, leading and
// stride byte offsets (all >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers at this point (the wgmma writes them
// asynchronously; nothing may read or move them across a fence or wait)
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_s(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Per-work-item state the producer warp writes and the consumers read: the
// segment of each of the first kSegPos key positions (past T: none), each
// of the first kSegTiles key tiles' segment and each consumer's rows'
// segment (kMixed where they differ).
struct Meta {
  uint8_t seg[kSegPos];
  uint8_t tile_seg[kSegTiles];
  uint8_t row_seg[2];
  uint8_t block_seg;   // the rows' one segment, or kMixed
};

// Shared memory, 1024-byte aligned: q (two slots; a warpgroup stages its
// output rows in its q rows), the K and V ring, two Meta slots and the
// barriers.
struct Smem {
  alignas(1024) uint8_t q[2][kQBytes];   // this item's and the next one's
  alignas(1024) uint8_t k[kStages][kKVBytes];
  alignas(1024) uint8_t v[kStages][kKVBytes];
  Meta meta[2];
  uint64_t q_full[2], q_empty[2];
  uint64_t full[kStages], empty[kStages];
  uint64_t meta_full[2], meta_empty[2];
};

// LONG: the kernel for T > kSegPos, the only one that reads segments past
// kSegPos from the mask in global memory (the other is kept free of that
// path's code and registers).
// position t's segment: from smem below kSegPos, else from the mask row
// (t < T)
template <bool LONG>
__device__ __forceinline__ uint8_t seg_at(const Meta& mt, const uint8_t* mrow, int t) {
  return !LONG || t < kSegPos ? mt.seg[t] : (mrow[t] ? 2 : 1);
}

// key tile kt's one segment, or kMixed (also for every tile past kSegTiles)
template <bool LONG>
__device__ __forceinline__ uint8_t tile_seg_of(const Meta& mt, int kt) {
  return !LONG || kt < kSegTiles ? mt.tile_seg[kt] : kMixed;
}

// Is key tile kt needed by the item's rows?
template <bool LONG>
__device__ __forceinline__ bool tile_needed(const Meta& mt, int kt) {
  const uint8_t ts = tile_seg_of<LONG>(mt, kt);
  return mt.block_seg == kMixed || ts == kMixed || ts == mt.block_seg;
}

template <bool LONG>
__device__ __forceinline__ int next_needed(const Meta& mt, int kt, int n_kt) {
  do { ++kt; } while (kt < n_kt && !tile_needed<LONG>(mt, kt));
  return kt;
}

// One work item: a 128-query tile of one (batch row, head). Blocks walk
// slots w = 2 * blockIdx.x, + 1, then on by 2 * gridDim.x; each slot holds
// an item or none (``valid``).
// - MHA (``paired``): slot w is half w & 1 of pair w >> 1, the heavy query
//   tile n_qt - 1 - p and then the light one p of one (b, h), so every
//   pair costs about the same and the light tile finds its keys (a prefix
//   of the heavy one's) in L2. Pairs run with p fastest, then h, then b,
//   so the pairs of one head run side by side and its K/V comes from HBM
//   about once. The middle tile of an odd n_qt has no partner.
// - GQA: slot w holds item w >> 1 (odd slots none), the heaviest query
//   tiles first, then b, then h fastest: the n_rep heads of one kv head run
//   side by side and share its K/V tiles in L2.
struct Item {
  int h, b, g, q0, n_kt;
  bool valid;
  __device__ Item(int w, int T, int B, int H, int kvH, bool paired) {
    const int n_qt = (T + kBlockQ - 1) / kBlockQ;
    int qt;
    if (paired) {
      const int n_p = (n_qt + 1) / 2;
      const int pair = w >> 1;
      const int p = pair % n_p;
      h = (pair / n_p) % H;
      b = pair / (n_p * H);
      qt = (w & 1) ? p : n_qt - 1 - p;
      valid = !(w & 1) || p != n_qt - 1 - p;
    } else {
      const int i = w >> 1;
      h = i % H;
      b = (i / H) % B;
      qt = n_qt - 1 - i / (H * B);
      valid = !(w & 1);
    }
    // tiles end at T: a ragged T leaves its rows below 0 in the first,
    // lightest tile, not past T in the heaviest one
    q0 = qt * kBlockQ - (n_qt * kBlockQ - T);
    g = h / (H / kvH);
    n_kt = (min(T, q0 + kBlockQ) - 1) / kBlockK + 1;   // none above the diagonal
  }
};

// slots / 2: pairs (MHA) or items (GQA)
__host__ __device__ inline int n_pairs_of(int B, int T, int H, bool paired) {
  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  return B * H * (paired ? (n_qt + 1) / 2 : n_qt);
}

// S (this thread's 2 rows x 16 keys) masked by select: causal and same
// segment, or untouched where the tile is wholly allowed for the rows
template <bool LONG>
__device__ __forceinline__ void mask_scores(float* s, const Meta& mt, const uint8_t* mrow,
                                            int T, int kt, int key0, int row0, int row1,
                                            int seg0, int seg1, uint8_t my_seg, int wg_row0,
                                            int tig) {
  const uint8_t ts = tile_seg_of<LONG>(mt, kt);
  if (key0 + kBlockK - 1 <= wg_row0 && ts != kMixed && ts == my_seg) return;
  if (!LONG || key0 + kBlockK <= kSegPos) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + tig * 2 + e;
        const int ks = mt.seg[key];
        s[j * 4 + e] = (key <= row0 && ks == seg0) ? s[j * 4 + e] : -INFINITY;
        s[j * 4 + 2 + e] = (key <= row1 && ks == seg1) ? s[j * 4 + 2 + e] : -INFINITY;
      }
    }
    return;
  }
  // past the positions kept in smem: the segments from the mask row
  for (int j = 0; j < 8; ++j) {
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + j * 8 + tig * 2 + e;
      const int ks = key < T ? (mrow[key] ? 2 : 1) : kSegPastEnd;
      s[j * 4 + e] = (key <= row0 && ks == seg0) ? s[j * 4 + e] : -INFINITY;
      s[j * 4 + 2 + e] = (key <= row1 && ks == seg1) ? s[j * 4 + 2 + e] : -INFINITY;
    }
  }
}

__device__ __forceinline__ float ex2(float x) {   // 2^x on the SFU; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online-softmax step in base 2, scores scaled by ``scale_log2`` here
// (positive, so the row max of the raw scores scales to the new max): new
// row maxima m, alpha = 2^(m_old - m), s becomes p = 2^(s * scale - m),
// l = l * alpha + sum p. A row with no valid key so far keeps m = -inf and
// shifts by 0, so ex2 gives 0, never NaN.
__device__ __forceinline__ void softmax_step(float* s, float scale_log2, float& m0, float& m1,
                                             float& l0, float& l1, float& al0, float& al1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
  }
  // the 4 threads of a quad share a row
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
  const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = ex2(m0 - sh0);
  al1 = ex2(m1 - sh1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j * 4 + 0] = ex2(fmaf(s[j * 4 + 0], scale_log2, -sh0));
    s[j * 4 + 1] = ex2(fmaf(s[j * 4 + 1], scale_log2, -sh0));
    s[j * 4 + 2] = ex2(fmaf(s[j * 4 + 2], scale_log2, -sh1));
    s[j * 4 + 3] = ex2(fmaf(s[j * 4 + 3], scale_log2, -sh1));
    ps0 += s[j * 4 + 0] + s[j * 4 + 1];
    ps1 += s[j * 4 + 2] + s[j * 4 + 3];
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
}

// the probabilities as wgmma's A fragments: the S accumulator layout is the
// register A layout of the next product, 16 keys per fragment
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pa)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = q . k^T over head_dim in 8 steps of 16 (4 per 64-column half), issued
// and committed, not waited for
__device__ __forceinline__ void issue_s(float* s, const uint8_t* qa, const uint8_t* kt) {
  fence_regs<32>(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const int off = (kk % 4) * 32;   // 16 columns = 32 bytes in the swizzle atom
    wgmma_s(s, desc(qa + (kk / 4) * kQHalf + off, 16, 1024),
            desc(kt + (kk / 4) * kKVHalf + off, 16, 1024), kk > 0);
  }
  wg_commit();
}

// O += P . V, V the MN-major B operand (LBO: the 64-column halves, SBO: 8
// key rows), issued and committed, not waited for
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4], const uint8_t* vt) {
  fence_regs<64>(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv(o, pa[kk], desc(vt + kk * 16 * 128, kKVHalf, 1024));
  wg_commit();
}

template <bool LONG>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_o,
                     const uint8_t* __restrict__ mask,   // (B, T)
                     __nv_bfloat16* __restrict__ out,    // (B, T, H * hd)
                     int B, int T, int H, int kvH, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const bool paired = H == kvH;
  const int n_pairs = n_pairs_of(B, T, H, paired);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.q_full[s], 1);
      mbar_init(&sm.q_empty[s], 256);       // every consumer thread
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 256);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.meta_full[s], 1);
      mbar_init(&sm.meta_empty[s], 257);   // the consumers and the K/V loader
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ===== producer warpgroup: warp 1 reads each item's segments and
    // loads its q, running an item ahead; lane 0 of warp 0 loads the K/V
    // tiles; the other warps only give up registers =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int lane = tid % 32;
    if (tid / 32 == 1) {
      int n = 0;      // items of this block so far
      for (int w = 2 * blockIdx.x; w < 2 * n_pairs; w += (w & 1) ? 2 * gridDim.x - 1 : 1) {
        const Item it(w, T, B, H, kvH, paired);
        if (!it.valid) continue;
        Meta& mt = sm.meta[n & 1];
        mbar_wait(&sm.meta_empty[n & 1], ((n >> 1) & 1) ^ 1);
        const uint8_t* mrow = mask + (size_t)it.b * T;
        const int n_pos = min(it.n_kt * kBlockK, kSegPos);
        const int n_sum = min(it.n_kt, kSegTiles);   // key tiles summarised
#pragma unroll 4
        for (int t = lane; t < n_pos; t += 32)
          mt.seg[t] = t < T ? (mrow[t] ? 2 : 1) : kSegPastEnd;
        __syncwarp();
        for (int u = 0; u < n_sum + 2; ++u) {
          const bool rows = u >= n_sum;
          const int p0 = rows ? it.q0 + (u - n_sum) * 64 : u * kBlockK;
          // rows outside [0, T) are segment 0, which no key has
          const int pa = p0 + lane, pc = p0 + 32 + lane;
          const uint8_t a = rows && (pa < 0 || pa >= T) ? 0 : seg_at<LONG>(mt, mrow, pa);
          const uint8_t c = rows && (pc < 0 || pc >= T) ? 0 : seg_at<LONG>(mt, mrow, pc);
          const uint8_t first = __shfl_sync(0xffffffffu, a, 0);
          const uint8_t one = __all_sync(0xffffffffu, a == first && c == first) ? first : kMixed;
          if (lane == 0) (rows ? mt.row_seg[u - n_sum] : mt.tile_seg[u]) = one;
        }
        __syncwarp();
        if (lane == 0) {
          // a consumer with every row outside [0, T) (segment 0) needs no key
          const uint8_t r0 = mt.row_seg[0], r1 = mt.row_seg[1];
          mt.block_seg = r0 == 0 ? r1 : (r1 == 0 || r0 == r1 ? r0 : kMixed);
          mbar_arrive(&sm.meta_full[n & 1]);
          mbar_wait(&sm.q_empty[n & 1], ((n >> 1) & 1) ^ 1);
          mbar_expect_tx(&sm.q_full[n & 1], kQBytes);
          tma_load(sm.q[n & 1], &map_q, &sm.q_full[n & 1], 0, it.h, it.q0, it.b);
          tma_load(sm.q[n & 1] + kQHalf, &map_q, &sm.q_full[n & 1], 64, it.h, it.q0, it.b);
        }
        __syncwarp();
        ++n;
      }
    } else if (tid == 0) {
      int i_kv = 0;   // K/V tiles issued so far (ring position)
      int n = 0;
      for (int w = 2 * blockIdx.x; w < 2 * n_pairs; w += (w & 1) ? 2 * gridDim.x - 1 : 1) {
        const Item it(w, T, B, H, kvH, paired);
        if (!it.valid) continue;
        const Meta& mt = sm.meta[n & 1];
        mbar_wait(&sm.meta_full[n & 1], (n >> 1) & 1);
        for (int kt = 0; kt < it.n_kt; ++kt) {
          if (!tile_needed<LONG>(mt, kt)) continue;
          const int st = i_kv % kStages;
          mbar_wait(&sm.empty[st], ((i_kv / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], 2 * kKVBytes);
          const int key0 = kt * kBlockK;
          tma_load(sm.k[st], &map_k, &sm.full[st], 0, it.g, key0, it.b);
          tma_load(sm.k[st] + kKVHalf, &map_k, &sm.full[st], 64, it.g, key0, it.b);
          tma_load(sm.v[st], &map_v, &sm.full[st], 0, it.g, key0, it.b);
          tma_load(sm.v[st] + kKVHalf, &map_v, &sm.full[st], 64, it.g, key0, it.b);
          ++i_kv;
        }
        mbar_arrive(&sm.meta_empty[n & 1]);   // done with the item's tile list
        ++n;
      }
    }
  } else {
    // ===== two consumer warpgroups, 64 query rows each =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wg = (tid - 128) / 128;         // 0 or 1
    const int t = tid % 128;
    const int warp = t / 32;
    const int lane = t % 32;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    int i_kv = 0;
    int n = 0;
    for (int w = 2 * blockIdx.x; w < 2 * n_pairs; w += (w & 1) ? 2 * gridDim.x - 1 : 1) {
      const Item it(w, T, B, H, kvH, paired);
      if (!it.valid) continue;
      const Meta& mt = sm.meta[n & 1];
      mbar_wait(&sm.meta_full[n & 1], (n >> 1) & 1);
      const int wg_row0 = it.q0 + wg * 64;
      const int row0 = wg_row0 + warp * 16 + gid;
      const int row1 = row0 + 8;
      const uint8_t* mrow = mask + (size_t)it.b * T;
      const int seg0 = row0 >= 0 && row0 < T ? seg_at<LONG>(mt, mrow, row0) : 0;
      const int seg1 = row1 >= 0 && row1 < T ? seg_at<LONG>(mt, mrow, row1) : 0;
      const uint8_t my_seg = mt.row_seg[wg];

      float o[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
      float s[32];
      uint32_t pa[4][4];
      mbar_wait(&sm.q_full[n & 1], (n >> 1) & 1);
      const uint8_t* qa = sm.q[n & 1] + wg * (kQHalf / 2);   // this warpgroup's 64 rows
      // the first needed tile: S, then its probabilities
      int kt = next_needed<LONG>(mt, -1, it.n_kt);
      int nxt = next_needed<LONG>(mt, kt, it.n_kt);
      int st = i_kv % kStages;
      mbar_wait(&sm.full[st], (i_kv / kStages) & 1);
      ++i_kv;
      issue_s(s, qa, sm.k[st]);
      wg_wait<0>();
      fence_regs<32>(s);
      mask_scores<LONG>(s, mt, mrow, T, kt, kt * kBlockK, row0, row1, seg0, seg1, my_seg,
                  wg_row0, tig);
      softmax_step(s, scale_log2, m0, m1, l0, l1, al0, al1);
      pack_p(s, pa);
      // each further tile: its S runs on the tensor cores beside the
      // previous tile's P.V, and its softmax beside the P.V
      while (nxt < it.n_kt) {
        kt = nxt;
        nxt = next_needed<LONG>(mt, kt, it.n_kt);
        const int prev = st;
        st = i_kv % kStages;
        mbar_wait(&sm.full[st], (i_kv / kStages) & 1);
        ++i_kv;
        issue_s(s, qa, sm.k[st]);
        issue_pv(o, pa, sm.v[prev]);
        wg_wait<1>();                  // S is in; P.V may still run
        fence_regs<32>(s);
        mask_scores<LONG>(s, mt, mrow, T, kt, kt * kBlockK, row0, row1, seg0, seg1, my_seg,
                  wg_row0, tig);
        softmax_step(s, scale_log2, m0, m1, l0, l1, al0, al1);
        wg_wait<0>();
        fence_regs<64>(o);
        mbar_arrive(&sm.empty[prev]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[j * 4 + 0] *= al0;
          o[j * 4 + 1] *= al0;
          o[j * 4 + 2] *= al1;
          o[j * 4 + 3] *= al1;
        }
        pack_p(s, pa);
      }
      issue_pv(o, pa, sm.v[st]);
      wg_wait<0>();
      fence_regs<64>(o);
      mbar_arrive(&sm.empty[st]);
      mbar_arrive(&sm.meta_empty[n & 1]);    // row segments read into registers

      // normalise, stage bf16 in the 128-byte swizzle in this warpgroup's
      // rows of the q slot (its products are done; the other warpgroup
      // reads only its own rows), store with TMA, and free the slot for
      // the next q once the store has read it
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const int r0 = warp * 16 + gid;   // row within the warpgroup's 64
      const int r1 = r0 + 8;
      uint8_t* ob = sm.q[n & 1] + wg * (kQHalf / 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint8_t* half = ob + (j / 8) * kQHalf;
        const int c = j % 8;                 // 16-byte chunk within the row
        *reinterpret_cast<uint32_t*>(half + r0 * 128 + ((c ^ (r0 % 8)) * 16) + tig * 4) =
            pack_bf16(o[j * 4 + 0] * inv0, o[j * 4 + 1] * inv0);
        *reinterpret_cast<uint32_t*>(half + r1 * 128 + ((c ^ (r1 % 8)) * 16) + tig * 4) =
            pack_bf16(o[j * 4 + 2] * inv1, o[j * 4 + 3] * inv1);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (wg_row0 >= 0) {
        if (t == 0) {
          tma_store(&map_o, ob, 0, it.h, wg_row0, it.b);
          tma_store(&map_o, ob + kQHalf, 64, it.h, wg_row0, it.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      } else if (wg_row0 + 64 > 0) {
        // the first tile of a ragged T straddles row 0, which a TMA store
        // does not clip: its rows in [0, T) go out from the staged copy
        const size_t rs = (size_t)H * kHd;
        for (int e = t; e < 64 * 16; e += 128) {
          const int r = e / 16, c16 = e % 16;      // row, 16-byte chunk of 256
          const int row = wg_row0 + r;
          if (row < 0 || row >= T) continue;
          const uint8_t* src = ob + (c16 / 8) * kQHalf + r * 128 + (((c16 % 8) ^ (r % 8)) * 16);
          *reinterpret_cast<int4*>(out + ((size_t)it.b * T + row) * rs + (size_t)it.h * kHd +
                                   c16 * 8) = *reinterpret_cast<const int4*>(src);
        }
      }
      mbar_arrive(&sm.q_empty[n & 1]);   // thread 0 only after the store read the slot
      ++n;
    }
  }
}


typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr) ==
            cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, T, heads, 128) bf16 seen as 4-D (128, heads, T, B), boxes of 64
// columns x ``rows`` positions of one head, 128-byte swizzle, zeros past T
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* base, int B, int T,
              int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)kHd, (cuuint64_t)heads, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kHd * 2, (cuuint64_t)heads * kHd * 2,
                                 (cuuint64_t)T * heads * kHd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int attwarp_flash_prefill(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, int B, int T, int H, int kvH,
                                     int hd, float sm_scale, void* stream) {
  if (hd != kHd || B <= 0 || T <= 0 || H <= 0 || kvH <= 0 ||
      H % kvH != 0 || (long long)B * H * ((T + kBlockQ - 1) / kBlockQ) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, enc, q, B, T, H, kBlockQ) || !make_map(&mk, enc, k, B, T, kvH, kBlockK) ||
      !make_map(&mv, enc, v, B, T, kvH, kBlockK) || !make_map(&mo, enc, out, B, T, H, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  static_assert(sizeof(Smem) + 1024 <= 232448, "shared memory over the H100's 227 KB");
  const int smem = (int)sizeof(Smem) + 1024;   // + the 1024-byte alignment
  const bool long_t = T > kSegPos;
  const auto kernel = long_t ? flash_prefill_kernel<true> : flash_prefill_kernel<false>;
  static bool attr_set[2] = {false, false};
  if (!attr_set[long_t]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set[long_t] = true;
  }
  // persistent: one block per SM walks the work items
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // MHA pairs come in n_p kinds (p); a grid that is no multiple of n_p
  // gives every block a mix of them
  const int n_qt = (T + kBlockQ - 1) / kBlockQ;
  const int n_p = (n_qt + 1) / 2;
  const int n_pairs = n_pairs_of(B, T, H, H == kvH);
  const int cap = H == kvH && n_sm % n_p == 0 && n_p > 1 ? n_sm - 1 : n_sm;
  const int grid = n_pairs < cap ? n_pairs : cap;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, mo, static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), B,
      T, H, kvH, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
