// Kernel K1: separable bilinear warp resample, cv2.remap(INTER_LINEAR,
// BORDER_REPLICATE) semantics, for Hopper (sm_90a).
//
// Replaces: attwarp_tpu/ops/pallas_warp.py::warp_batch_pallas_cf (body
// _warp_kernel), the TPU kernel that builds two-banded interpolation
// matrices R_y, R_x in VMEM and computes R_y . img . R_x^T per (image,
// channel) on the MXU with a two-level int8 fixed-point core. That form was
// a TPU choice and is not carried over.
//
// What bounds it on the H100: memory. Each output value needs four source
// taps and three lerps: about 2 flops per byte moved, far below the card's
// f32 balance point, so tensor cores buy nothing. The least time is the
// image and maps read once and the output written once at 3.35 TB/s. What
// keeps a kernel from it: taps recomputed for every pixel, narrow scalar
// accesses, source rows fetched again for every output row that uses them,
// and too few bytes in flight per SM at small batches.
//
// Design (the launch plan is kernels/warp_resample.py::k1_plan):
// - One block of 128 threads per (image, band of `rows` output rows, tile of
//   `tile` output columns); short bands and about four blocks per SM, so
//   that many blocks overlap their latency chains (map loads -> row copies
//   -> rows) and the first rows of a one-wave grid arrive soon.
// - Prologue, once per block: the x-tap table of the tile in shared memory
//   (per output float: both clamped source offsets and the fraction, from
//   map_x, whose loads are issued first); the band's y taps, and the list
//   of distinct source rows the band reads in order ("entries": consecutive
//   output rows that share a source row share its entry), by a ballot scan
//   over the 2 x rows taps.
// - Source rows staged in a ring of `slots` rows in shared memory, each
//   entry copied once, ahead of the row that first needs it: one 1-D TMA
//   bulk copy (cp.async.bulk) completing on the slot's mbarrier where rows
//   are a multiple of 16 bytes, else 4-byte cp.async by every thread
//   arriving on the same mbarrier (a kernel of its own, kBulk = false, so
//   that the bulk kernel keeps its 64 registers and eight blocks per SM).
//   Where a slot holds a whole source row, the first copies start right
//   after the y scan, before the x-tap table is built. A block whose tile
//   spans more source columns than a slot holds reads its taps from global
//   memory (__ldg) instead.
// - Output as 16-byte stores: a warp computes 128 floats of the flattened
//   output row lane-interleaved (so C=3 needs no layout of its own and the
//   lanes of one tap read hit neighbouring source words, not words 4 x scale
//   apart in few banks), passes them through a staging buffer in shared
//   memory, and each lane writes 4 consecutive floats as one float4; the
//   unaligned head of a row is stored float by float. The stores are
//   streaming (st.global.cs): nothing in this kernel reads them back.
// - Indexing is 32-bit inside an image; only the image's base is 64-bit.
//
// Arithmetic: as warp/resample.py::remap_bilinear_separable, both
// neighbours clamped from the unclipped floor, the x pass first, then the
// y pass, each as a * (1 - f) + b * f, rounded at each operation as the
// plain version's separate multiplies and add are (no FMA contraction).
//
// Layout: img (B, H, W, C) f32, map_x (B, W_out) f32, map_y (B, H_out) f32,
// out (B, H_out, W_out, C) f32, all contiguous and 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = kThreads / 2;   // two entries per output row
constexpr int kMaxSlots = 16;

struct Params {
  const float* img;
  const float* map_x;
  const float* map_y;
  float* out;
  int H, W, C, H_out, W_out;
  int rows, tile, slots, cap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// waits for the phase of ``parity``; a wait of more than ~2^32 cycles (over
// a second) can only be a fault, and traps rather than hang the card
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

// one TMA bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// both clamped neighbours of a source coordinate and its fraction; the
// float is bounded before the int conversion, which leaves the clamped
// taps as they are
__device__ __forceinline__ void taps(float v, int n, int& i0, int& i1, float& f) {
  const float fl = floorf(v);
  const int i = static_cast<int>(fminf(fmaxf(fl, -2.0f), static_cast<float>(n) + 1.0f));
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
  f = v - fl;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

// arrives on ``bar`` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// one output row of the tile from source rows r0 (top) and r1 (bottom):
// shared memory when ``kStaged``, global memory otherwise. The x-tap table
// holds, per output float, both source offsets and the fraction. A warp
// takes 128 floats at a time, lane l the floats l, l + 32, l + 64 and
// l + 96, so the 32 lanes of one tap read neighbouring source words (a
// lane taking 4 neighbouring floats would put its taps 4 x scale words
// from the next lane's, in as few banks); the 128 values go through the
// warp's staging buffer in shared memory, and each lane writes 4
// consecutive floats as one 16-byte store. The unaligned head of the row
// is stored float by float.
template <bool kStaged>
__device__ __forceinline__ void row_out(const float* __restrict__ r0, const float* __restrict__ r1,
                                        float fy, const int* __restrict__ off0,
                                        const int* __restrict__ off1,
                                        const float* __restrict__ fxs, float* __restrict__ o,
                                        int nf, int head, float* __restrict__ stage) {
  auto value = [&](int f) {
    const int a = off0[f], b = off1[f];
    const float fx = fxs[f];
    float t0, t1, b0, b1;
    if constexpr (kStaged) {
      t0 = r0[a]; t1 = r0[b]; b0 = r1[a]; b1 = r1[b];
    } else {
      t0 = __ldg(r0 + a); t1 = __ldg(r0 + b); b0 = __ldg(r1 + a); b1 = __ldg(r1 + b);
    }
    return lerp(lerp(t0, t1, fx), lerp(b0, b1, fx), fy);
  };
  if (threadIdx.x < head) __stcs(o + threadIdx.x, value(threadIdx.x));
  const int lane = threadIdx.x & 31;
  float* st = stage + (threadIdx.x >> 5) * 128;
  float* ob = o + head;                              // 16-byte aligned
  const int body = nf - head;
  for (int base = (threadIdx.x >> 5) * 128; base < body; base += 4 * kThreads) {
    const int n = min(128, body - base);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = lane + 32 * k;
      if (q < n) st[q] = value(head + base + q);
    }
    __syncwarp();
    const int q4 = 4 * lane;
    if (q4 + 3 < n) {
      __stcs(reinterpret_cast<float4*>(ob + base + q4), *reinterpret_cast<const float4*>(st + q4));
    } else {
      for (int q = q4; q < n; ++q) __stcs(ob + base + q, st[q]);
    }
    __syncwarp();
  }
}

// kC: the channel count where it is 1, 3 or 4 (a constant divisor), else
// 0 and p.C. kBulk: source rows are a multiple of 16 bytes (TMA bulk
// copies), else staged by 4-byte cp.async
template <int kC, bool kBulk>
__global__ void __launch_bounds__(kThreads) warp_resample_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = kC ? kC : p.C;
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int i0 = blockIdx.x * p.rows;
  const int j0 = blockIdx.y * p.tile;
  const int nrow = min(p.rows, p.H_out - i0);
  const int ncol = min(p.tile, p.W_out - j0);
  const int nf = ncol * C;                       // output floats of a tile row
  const int tfp = (p.tile * C + 3) & ~3;
  const int row_f = p.W * C;
  // where a slot holds a whole source row, whole rows are staged, so the
  // copies need only the y taps and start before the x-tap table is built
  const bool whole = p.slots > 0 && p.cap >= row_f;
  const float* img_b = p.img + static_cast<size_t>(b) * p.H * row_f;

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + 8 * kMaxSlots);
  float* stage = ring + p.slots * p.cap;                  // 128 floats per warp
  int* off0 = reinterpret_cast<int*>(stage + 4 * kThreads);
  int* off1 = off0 + tfp;
  float* fxs = reinterpret_cast<float*>(off1 + tfp);
  int* entry_of = reinterpret_cast<int*>(fxs + tfp);   // per tap: its entry
  int* entry_row = entry_of + 2 * p.rows;              // per entry: its source row
  float* fys = reinterpret_cast<float*>(entry_row + 2 * p.rows);
  int* misc = reinterpret_cast<int*>(fys + p.rows);    // lo, hi, 4 warp counts

  // map_x first: its loads run beside map_y's and the scan below
  const float* mx = p.map_x + static_cast<size_t>(b) * p.W_out + j0;
  float xv[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = u * kThreads + tid;
    xv[u] = j < ncol ? __ldg(mx + j) : 0.0f;
  }
  if (tid == 0) {
    misc[0] = p.W;
    misc[1] = -1;
  }
  if (tid < p.slots) mbar_init(&bars[tid], kBulk ? 1u : static_cast<uint32_t>(kThreads));
  if (p.slots) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // the band's taps in order, y0 and y1 of each output row (thread t takes
  // tap t); a tap that differs from the one before starts a new entry, a
  // source row to stage
  const float* my = p.map_y + static_cast<size_t>(b) * p.H_out + i0;
  const bool active = tid < 2 * nrow;
  int src = -1, prev = -1;
  if (active) {
    int y0, y1;
    float fy;
    taps(__ldg(my + (tid >> 1)), p.H, y0, y1, fy);
    src = (tid & 1) ? y1 : y0;
    if (tid & 1) {
      prev = y0;
    } else {
      fys[tid >> 1] = fy;
      if (tid) {
        int q0, q1;
        float qf;
        taps(__ldg(my + (tid >> 1) - 1), p.H, q0, q1, qf);
        prev = q1;
      }
    }
  }
  const bool fresh = active && src != prev;
  const uint32_t ballot = __ballot_sync(0xffffffffu, fresh);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) misc[2 + warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n_entries = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? misc[2 + w] : 0;
    n_entries += misc[2 + w];
  }
  const int e = before + __popc(ballot & ((1u << lane) - 1u)) + (fresh ? 1 : 0) - 1;
  if (active) {
    entry_of[tid] = e;
    if (fresh) entry_row[e] = src;
  }
  // the thread that starts an entry copies it where it can alone
  const bool early = whole && kBulk;
  if (early && fresh && e < p.slots)
    bulk_copy(ring + e * p.cap, img_b + src * row_f, 4u * row_f, &bars[e]);

  // the x-tap table of the tile (map_x read four columns a thread at once),
  // and the source columns it spans
  int lo = p.W, hi = -1;
  for (int jb = 0; jb < ncol; jb += 4 * kThreads) {
    if (jb) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = jb + u * kThreads + tid;
        xv[u] = j < ncol ? __ldg(mx + j) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = jb + u * kThreads + tid;
      if (j < ncol) {
        int x0, x1;
        float fx;
        taps(xv[u], p.W, x0, x1, fx);
#pragma unroll
        for (int c = 0; c < (kC ? kC : 1); ++c) {     // kC: unrolled; else the loop below
          off0[j * C + c] = x0 * C + c;
          off1[j * C + c] = x1 * C + c;
          fxs[j * C + c] = fx;
        }
        for (int c = kC ? kC : 1; c < C; ++c) {
          off0[j * C + c] = x0 * C + c;
          off1[j * C + c] = x1 * C + c;
          fxs[j * C + c] = fx;
        }
        lo = min(lo, x0);
        hi = max(hi, x1);
      }
    }
  }
  if (!whole) {
    for (int d = 16; d; d >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
    }
    if (lane == 0) {
      atomicMin(&misc[0], lo);
      atomicMax(&misc[1], hi);
    }
  }
  __syncthreads();

  const int lo_f = whole ? 0 : (misc[0] * C) & ~3;
  const int hi_f = whole ? row_f : min(((misc[1] + 1) * C + 3) & ~3, row_f);
  const int span = hi_f - lo_f;
  const bool staged = p.slots > 0 && span <= p.cap;
  float* out_b = p.out + static_cast<size_t>(b) * p.H_out * p.W_out * C;
  // the output image's first float, for the 16-byte alignment of each row
  const uint32_t out_base = static_cast<uint32_t>(static_cast<size_t>(b) * p.H_out * p.W_out * C);

  // copies the source row of entry ``k`` into its slot
  auto issue = [&](int k) {
    const int s = k % p.slots;
    float* dst = ring + s * p.cap;
    const float* srcp = img_b + entry_row[k] * row_f + lo_f;
    if constexpr (kBulk) {
      if (tid == 0) bulk_copy(dst, srcp, 4u * span, &bars[s]);
    } else {
      for (int f = tid; f < span; f += kThreads) cp_async4(dst + f, srcp + f);
      cp_async_arrive(&bars[s]);
    }
  };
  int issued = early ? min(n_entries, p.slots) : 0;
  if (staged) {
    for (; issued < min(n_entries, p.slots); ++issued) issue(issued);
  }

  for (int r = 0; r < nrow; ++r) {
    const int ea = entry_of[2 * r], eb = entry_of[2 * r + 1];
    const int orow = ((i0 + r) * p.W_out + j0) * C;
    float* o = out_b + orow;
    const int head = min(static_cast<int>((0u - (out_base + orow)) & 3u), nf);
    if (staged) {
      mbar_wait(&bars[ea % p.slots], (ea / p.slots) & 1);
      mbar_wait(&bars[eb % p.slots], (eb / p.slots) & 1);
      // each slot holds the span from lo_f on: its offsets start at lo_f
      row_out<true>(ring + (ea % p.slots) * p.cap - lo_f, ring + (eb % p.slots) * p.cap - lo_f,
                    fys[r], off0, off1, fxs, o, nf, head, stage);
      __syncthreads();                       // every read of this row's slots done
      const int first_next = r + 1 < nrow ? entry_of[2 * r + 2] : n_entries;
      for (; issued < n_entries && issued < first_next + p.slots; ++issued) issue(issued);
    } else {
      row_out<false>(img_b + entry_row[ea] * row_f, img_b + entry_row[eb] * row_f, fys[r],
                     off0, off1, fxs, o, nf, head, stage);
    }
  }
}

template <bool kBulk>
void (*kernel_for(int C))(Params) {
  return C == 3 ? warp_resample_kernel<3, kBulk>
         : C == 1 ? warp_resample_kernel<1, kBulk>
         : C == 4 ? warp_resample_kernel<4, kBulk> : warp_resample_kernel<0, kBulk>;
}

}  // namespace

// rows, tile, slots and cap come from kernels/warp_resample.py::k1_plan;
// ``smem`` is the plan's shared memory, checked against what the kernel
// lays out
extern "C" int attwarp_warp_resample(const float* img, const float* map_x,
                                     const float* map_y, float* out,
                                     int B, int H, int W, int C,
                                     int H_out, int W_out, int rows, int tile,
                                     int slots, int cap, int threads, int smem,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H_out <= 0 || W_out <= 0 ||
      threads != kThreads || rows < 1 || rows > kMaxRows || tile < 1 ||
      slots < 0 || slots > kMaxSlots || slots == 1 || cap < 0 || (cap & 3) ||
      (slots && cap < 4) || B > 65535 || (W_out + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  const long long tfp = ((long long)tile * C + 3) & ~3ll;
  const long long need = 8ll * kMaxSlots + 4ll * slots * cap + 16ll * kThreads + 12 * tfp +
                         4ll * 5 * rows + 4 * (2 + kThreads / 32);
  if (need > smem || smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = (W * C) % 4 == 0 ? kernel_for<true>(C) : kernel_for<false>(C);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  Params p{img, map_x, map_y, out, H, W, C, H_out, W_out, rows, tile, slots, cap};
  const dim3 grid((H_out + rows - 1) / rows, (W_out + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
