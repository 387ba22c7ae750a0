// The backward of kernel K1 (separable bilinear warp resample), for Hopper
// (sm_90a): the gradients of out = remap(img, map_x, map_y) with respect
// to the image and both coordinate maps, given g = dL/dout.
//
// Replaces: no Pallas kernel. The JAX package differentiates its warp
// through XLA's autodiff of the gather form
// (attwarp_tpu/warp/resample.py::remap_bilinear_separable); K1's Pallas
// kernel (attwarp_tpu/ops/pallas_warp.py::warp_batch_pallas_cf) has no
// backward.
//
// The forward's arithmetic (warp/resample.py and warp_resample.cu), per
// axis: i0 = clamp(floor(c), 0, n-1), i1 = clamp(floor(c) + 1, 0, n-1),
// f = c - floor(c); the x pass X[y, j] = lerp(I[y, x0_j], I[y, x1_j], fx_j),
// then out[i, j] = lerp(X[y0_i, j], X[y1_i, j], fy_i). So
// - grad_img[y, x] = sum over the x taps (j, wx) that hit x of wx * sum over
//   the y taps (i, wy) that hit y of wy * g[i, j]; a tap's weight is 1 - f
//   for i0 and f for i1, and where clamping makes i0 == i1 both land on the
//   same pixel;
// - grad_map_x[j] = sum over i, c of g[i, j, c] * ((1 - fy_i) * (I[y0_i, x1_j]
//   - I[y0_i, x0_j]) + fy_i * (I[y1_i, x1_j] - I[y1_i, x0_j]));
// - grad_map_y[i] = sum over j, c of g[i, j, c] * (X[y1_i, j] - X[y0_i, j]).
// floor has no gradient, so a map's gradient is zero where its clamped taps
// coincide, as in autograd of the plain version and in JAX's.
//
// What bounds it on the H100: memory, as for the forward (a few flops per
// byte, no use for tensor cores). The least time reads g once, the image
// once if the maps need a gradient, writes grad_img once if the image
// needs one, and reads and writes the maps (kernels/roofline.py::
// k1_backward_work).
//
// Design: simple, deterministic (the same bits on every run: every sum is
// taken in a fixed order, with no atomics in device memory), up to four
// launches on the caller's stream:
// 1. taps_kernel, only for grad_img: one block per (image, axis) builds the
//    inverse tap lists, for each source column (row) the output columns
//    (rows) whose taps hit it with their weights, filled in output order
//    (an output's i0 tap before its i1 tap), so that each list's order is
//    fixed whatever the maps, with no sort and no atomics. Each of the
//    block's first `segs` warps (up to kSegs, as many as shared memory holds
//    a count per source for) takes a contiguous segment of the outputs and
//    fills it 16 outputs (32 keys) a step; a key's place among the step's
//    keys with the same source is the count of lower lanes with that
//    source (__match_any_sync). The slots come from a count of each
//    segment's keys per source in shared memory, a prefix over the
//    segments and an exclusive scan over the sources.
// 2. grad_img_kernel: one block per (image, source row) sums the y taps of
//    g's output rows into a row of shared memory (the transposed y pass,
//    coalesced), then each source value sums its x taps of that row, in
//    list order, and is written once (zero where no tap hits it).
// 3. grad_maps_kernel, only for the maps: one block per (image, band of
//    kBand output rows) recomputes the taps, reduces grad_map_y per row
//    inside the block (a fixed shuffle tree) and writes the band's partial
//    sums of grad_map_x.
// 4. sum_bands_kernel, only for grad_map_x: sums those partials over the
//    bands in order.
// Nothing is computed or written that is not asked for: without grad_img,
// launches 1 and 2 do not run; without either map, 3 and 4 do not run and
// the image is not read; grad_map_y alone skips 4. Every launch made adds
// one to a count that attwarp_warp_resample_backward_kernels() reads.
//
// Layout: g (B, H_out, W_out, C), img and grad_img (B, H, W, C), map_x and
// grad_map_x (B, W_out), map_y and grad_map_y (B, H_out), all f32 and
// contiguous. One scratch buffer from the wrapper, of the bytes that
// attwarp_warp_resample_backward_scratch_bytes() asks for (see Scratch).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kTapThreads = 512;
constexpr int kImgThreads = 256;
constexpr int kMaxOutRow = 56 * 1024;  // W_out * C floats of dX in shared memory
constexpr int kBand = 4;
constexpr int kSegs = kTapThreads / 32;   // the taps kernel's segments of outputs, a warp each
constexpr int kTapSmem = 224 * 1024;     // its counts: n_src * (1 + segs) ints
constexpr int kMaxSrc = kTapSmem / 8;    // the longest source axis (one segment)

// both clamped neighbours of a source coordinate and its fraction, as
// warp_resample.cu computes them
__device__ __forceinline__ void taps(float v, int n, int& i0, int& i1, float& f) {
  const float fl = floorf(v);
  const int i = static_cast<int>(fminf(fmaxf(fl, -2.0f), static_cast<float>(n) + 1.0f));
  i0 = min(max(i, 0), n - 1);
  i1 = min(max(i + 1, 0), n - 1);
  f = v - fl;
}

// the forward's lerp, rounded at each operation
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

struct Bwd {
  const float* g;
  const float* img;
  const float* map_x;
  const float* map_y;
  float* grad_img;
  float* grad_mx;
  float* grad_my;
  int* tap_off;    // B * (W + 1) x lists' offsets, then B * (H + 1) y lists'
  int* tap_idx;    // 2 * B * W_out x lists' outputs, then 2 * B * H_out y lists'
  float* tap_w;    // their weights
  float* partial;  // B * n_bands * W_out: grad_map_x's partial sums by band
  int B, H, W, C, H_out, W_out, n_bands, segs;
};

// The scratch: each part 16-byte aligned, in the order above; null parts
// take no room (the taps' without grad_img, partial without grad_map_x).
struct Scratch {
  size_t off, idx, w, partial, bytes;
  Scratch(int B, int H, int W, int H_out, int W_out, bool need_img, bool need_mx) {
    auto up = [](size_t n) { return (n * 4 + 15) / 16 * 16; };
    const size_t taps = need_img ? 1 : 0;
    off = 0;
    idx = off + taps * up((size_t)B * (W + 1) + (size_t)B * (H + 1));
    w = idx + taps * up(2 * (size_t)B * ((size_t)W_out + H_out));
    partial = w + taps * up(2 * (size_t)B * ((size_t)W_out + H_out));
    bytes = partial + (need_mx ? up((size_t)B * ((H_out + kBand - 1) / kBand) * W_out) : 0);
  }
};

// the fill of one segment [m_lo, m_hi) of the outputs by its warp, 16 a
// step: lane l holds key 2m + (l & 1) of output m = base + l / 2, its i0
// tap on even lanes and its i1 tap on odd ones, and writes its output and
// weight at start[s] + cur[s] plus the step's lower lanes with source s;
// cur[s] then moves past the step's keys with source s.
__device__ __forceinline__ void fill_segment(const float* map, int n_src, int m_lo, int m_hi,
                                             int lane, const int* start, int* cur, int* idx,
                                             float* wt) {
  for (int base = m_lo; base < m_hi; base += 16) {
    const int m = base + (lane >> 1);
    int s = -1;
    float w = 0.0f;
    if (m < m_hi) {
      int i0, i1;
      float f;
      taps(__ldg(map + m), n_src, i0, i1, f);
      s = (lane & 1) ? i1 : i0;
      w = (lane & 1) ? f : __fsub_rn(1.0f, f);
    }
    const unsigned same = __match_any_sync(0xffffffffu, s);
    const int at = s >= 0 ? cur[s] : 0;
    if (s >= 0) {
      const int q = start[s] + at + __popc(same & ((1u << lane) - 1u));
      idx[q] = m;
      wt[q] = w;
    }
    __syncwarp();                         // every cursor read before it moves
    if (s >= 0 && lane == 31 - __clz(same)) cur[s] = at + __popc(same);
    __syncwarp();
  }
}

// one block per (image, axis): axis 0 lists the x taps of each source
// column, axis 1 the y taps of each source row
__global__ void __launch_bounds__(kTapThreads) taps_kernel(const Bwd p) {
  extern __shared__ int cnt[];            // n_src totals, then each list's first slot
  __shared__ int warp_tot[kSegs];
  __shared__ int carry;
  const int b = blockIdx.x, axis = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_src = axis ? p.H : p.W, n_out = axis ? p.H_out : p.W_out;
  const float* map = axis ? p.map_y + (size_t)b * p.H_out : p.map_x + (size_t)b * p.W_out;
  int* off = p.tap_off + (axis ? (size_t)p.B * (p.W + 1) + (size_t)b * (p.H + 1)
                               : (size_t)b * (p.W + 1));
  // seg[w * n_src + s], after cnt: the keys of segment w with source s,
  // then those of the segments before w (the segment's first slot in the
  // list), then the fill's cursor
  int* seg = cnt + n_src;
  const size_t list = axis ? 2 * ((size_t)p.B * p.W_out + (size_t)b * p.H_out)
                           : 2 * (size_t)b * p.W_out;
  int* idx = p.tap_idx + list;
  float* wt = p.tap_w + list;
  const int segs = p.segs, seg_len = (n_out + segs - 1) / segs;
  const int m_lo = min(n_out, warp * seg_len), m_hi = min(n_out, m_lo + seg_len);

  for (int v = tid; v < segs * n_src; v += kTapThreads) seg[v] = 0;
  if (tid == 0) carry = 0;
  __syncthreads();
  // each segment's keys per source (integer counts: any order of the
  // atomics gives the same)
  for (int m = tid; m < n_out; m += kTapThreads) {
    int i0, i1;
    float f;
    taps(__ldg(map + m), n_src, i0, i1, f);
    int* row = seg + (m / seg_len) * n_src;
    atomicAdd(row + i0, 1);
    atomicAdd(row + i1, 1);
  }
  __syncthreads();
  // per source: each segment's keys before it, and the total
  for (int s = tid; s < n_src; s += kTapThreads) {
    int at = 0;
    for (int w = 0; w < segs; ++w) {
      const int k = seg[w * n_src + s];
      seg[w * n_src + s] = at;
      at += k;
    }
    cnt[s] = at;
  }
  __syncthreads();
  // exclusive scan of the totals, kTapThreads at a time: off[s] and cnt[s]
  // become the first slot of source s's list
  for (int base = 0; base < n_src; base += kTapThreads) {
    const int s = base + tid;
    const int c = s < n_src ? cnt[s] : 0;
    int v = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    int excl = carry + v - c;
    for (int k = 0; k < warp; ++k) excl += warp_tot[k];
    if (s < n_src) {
      cnt[s] = excl;
      off[s] = excl;
    }
    __syncthreads();                      // every read of carry and warp_tot done
    if (tid == kTapThreads - 1) carry = excl + c;
    __syncthreads();
  }
  if (tid == 0) off[n_src] = carry;       // 2 * n_out
  fill_segment(map, n_src, m_lo, m_hi, lane, cnt, seg + warp * n_src, idx, wt);
}

// one block per (image, source row y). First the row's y-transpose, dX[j, c]
// = sum over the y taps (i, wy) that hit y of wy * g[i, j, c], into shared
// memory, a whole output row of g at a time (coalesced, 16-byte loads where
// rows allow); then each source value (x, c) sums wx * dX[j, c] over the x
// taps (j, wx) that hit x, and is written once (zero where no tap hits it)
__global__ void __launch_bounds__(kImgThreads) grad_img_kernel(const Bwd p) {
  extern __shared__ __align__(16) float dx[];   // W_out * C
  const int b = blockIdx.y, y = blockIdx.x, tid = threadIdx.x;
  const int row_f = p.W * p.C, out_f = p.W_out * p.C;
  const int* off_x = p.tap_off + (size_t)b * (p.W + 1);
  const int* off_y = p.tap_off + (size_t)p.B * (p.W + 1) + (size_t)b * (p.H + 1);
  const size_t list_x = 2 * (size_t)b * p.W_out;
  const size_t list_y = 2 * ((size_t)p.B * p.W_out + (size_t)b * p.H_out);
  float* gi = p.grad_img + ((size_t)b * p.H + y) * row_f;
  const int ya = __ldg(off_y + y), yb = __ldg(off_y + y + 1);
  if (ya == yb) {                               // no output row reads this row
    for (int v = tid; v < row_f; v += kImgThreads) gi[v] = 0.0f;
    return;
  }
  const float* g = p.g + (size_t)b * p.H_out * out_f;
  const bool vec = (out_f & 3) == 0;
  for (int q = ya; q < yb; ++q) {
    const float w = __ldg(p.tap_w + list_y + q);
    const float* gr = g + (size_t)__ldg(p.tap_idx + list_y + q) * out_f;
    if (vec) {
      const float4* g4 = reinterpret_cast<const float4*>(gr);
      float4* d4 = reinterpret_cast<float4*>(dx);
      for (int v = tid; v < out_f / 4; v += kImgThreads) {
        const float4 a = __ldg(g4 + v);
        float4 d = q == ya ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : d4[v];
        d.x += w * a.x;
        d.y += w * a.y;
        d.z += w * a.z;
        d.w += w * a.w;
        d4[v] = d;
      }
    } else {
      for (int v = tid; v < out_f; v += kImgThreads)
        dx[v] = (q == ya ? 0.0f : dx[v]) + w * __ldg(gr + v);
    }
  }
  __syncthreads();
  for (int v = tid; v < row_f; v += kImgThreads) {
    const int x = v / p.C, c = v - x * p.C;
    const int xa = __ldg(off_x + x), xb = __ldg(off_x + x + 1);
    float acc = 0.0f;
    for (int e = xa; e < xb; ++e)
      acc += __ldg(p.tap_w + list_x + e) * dx[__ldg(p.tap_idx + list_x + e) * p.C + c];
    gi[v] = acc;
  }
}

// one block per (image, band of kBand output rows); kY: grad_map_y, kX:
// grad_map_x's partial sums
template <bool kX, bool kY>
__global__ void __launch_bounds__(kThreads) grad_maps_kernel(const Bwd p) {
  __shared__ int sy0[kBand], sy1[kBand];
  __shared__ float sfy[kBand];
  __shared__ float red[kBand][kThreads / 32];
  const int b = blockIdx.y, band = blockIdx.x, tid = threadIdx.x;
  const int i_first = band * kBand;
  const int rows = min(kBand, p.H_out - i_first);
  if (tid < rows) {
    int y0, y1;
    float fy;
    taps(__ldg(p.map_y + (size_t)b * p.H_out + i_first + tid), p.H, y0, y1, fy);
    sy0[tid] = y0;
    sy1[tid] = y1;
    sfy[tid] = fy;
  }
  __syncthreads();
  const int C = p.C;
  const float* img = p.img + (size_t)b * p.H * p.W * C;
  const float* g = p.g + ((size_t)b * p.H_out + i_first) * p.W_out * C;
  float gy[kBand];
#pragma unroll
  for (int r = 0; r < kBand; ++r) gy[r] = 0.0f;
  for (int j = tid; j < p.W_out; j += kThreads) {
    int x0, x1;
    float fx;
    taps(__ldg(p.map_x + (size_t)b * p.W_out + j), p.W, x0, x1, fx);
    float gx = 0.0f;
#pragma unroll
    for (int r = 0; r < kBand; ++r) {
      if (r < rows) {
        const float fy = sfy[r], wy0 = __fsub_rn(1.0f, fy);
        const float* top = img + (size_t)sy0[r] * p.W * C;
        const float* bot = img + (size_t)sy1[r] * p.W * C;
        const float* gr = g + ((size_t)r * p.W_out + j) * C;
        for (int c = 0; c < C; ++c) {
          const float a = __ldg(top + x0 * C + c), bb = __ldg(top + x1 * C + c);
          const float cc = __ldg(bot + x0 * C + c), d = __ldg(bot + x1 * C + c);
          const float gv = __ldg(gr + c);
          if (kY) gy[r] += gv * (lerp(cc, d, fx) - lerp(a, bb, fx));
          if (kX) gx += gv * (wy0 * (bb - a) + fy * (d - cc));
        }
      }
    }
    if (kX) p.partial[((size_t)b * p.n_bands + band) * p.W_out + j] = gx;
  }
  if (!kY) return;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kBand; ++r) {
    float v = gy[r];
    for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
    if (lane == 0) red[r][warp] = v;
  }
  __syncthreads();
  if (tid < rows) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[tid][w];
    p.grad_my[(size_t)b * p.H_out + i_first + tid] = s;
  }
}

__global__ void __launch_bounds__(kThreads) sum_bands_kernel(const Bwd p) {
  const int b = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.W_out) return;
  const float* part = p.partial + (size_t)b * p.n_bands * p.W_out + j;
  float s = 0.0f;
  for (int k = 0; k < p.n_bands; ++k) s += part[(size_t)k * p.W_out];
  p.grad_mx[(size_t)b * p.W_out + j] = s;
}

std::atomic<int> g_kernels{0};   // kernels launched (attwarp_..._backward_kernels)

// the launch's error, counting the launch where there is none
cudaError_t launched() {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_kernels;
  return e;
}

}  // namespace

// *bytes: the scratch attwarp_warp_resample_backward takes for this shape
// and these gradients. Returns 0.
extern "C" int attwarp_warp_resample_backward_scratch_bytes(int B, int H, int W, int H_out,
                                                            int W_out, int need_img, int need_mx,
                                                            long long* bytes) {
  *bytes = (long long)Scratch(B, H, W, H_out, W_out, need_img, need_mx).bytes;
  return 0;
}

// grad_img null: no image gradient; grad_mx or grad_my null: no gradient of
// that map (img unused without both). scratch: the bytes above. Returns the
// first launch error, cudaErrorInvalidValue for a shape it does not take
// (sides beyond kMaxSrc or W_out * C beyond kMaxOutRow for the image
// gradient, B > 65535), or 0.
extern "C" int attwarp_warp_resample_backward(
    const float* g, const float* img, const float* map_x, const float* map_y,
    float* grad_img, float* grad_mx, float* grad_my, void* scratch, int B, int H, int W,
    int C, int H_out, int W_out, void* stream) {
  const bool need_img = grad_img != nullptr;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || H_out <= 0 || W_out <= 0 || B > 65535 ||
      (need_img && (H > kMaxSrc || W > kMaxSrc || (long long)W_out * C > kMaxOutRow)) ||
      ((need_img || grad_mx) && !scratch))
    return (int)cudaErrorInvalidValue;
  const Scratch sc(B, H, W, H_out, W_out, need_img, grad_mx != nullptr);
  char* base = static_cast<char*>(scratch);
  const int n_src = H > W ? H : W;
  const int fit = kTapSmem / (4 * n_src) - 1;
  const int segs = fit < kSegs ? fit : kSegs;
  const Bwd p{g, img, map_x, map_y, grad_img, grad_mx, grad_my,
              reinterpret_cast<int*>(base + sc.off), reinterpret_cast<int*>(base + sc.idx),
              reinterpret_cast<float*>(base + sc.w), reinterpret_cast<float*>(base + sc.partial),
              B, H, W, C, H_out, W_out, (H_out + kBand - 1) / kBand, segs};
  cudaStream_t s = (cudaStream_t)stream;
  if (need_img) {
    const int smem = 4 * n_src * (1 + segs);
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(taps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    taps_kernel<<<dim3(B, 2), kTapThreads, smem, s>>>(p);
    cudaError_t e = launched();
    if (e != cudaSuccess) return (int)e;
    const int dx_bytes = 4 * W_out * C;
    if (dx_bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(grad_img_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dx_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    grad_img_kernel<<<dim3(H, B), kImgThreads, dx_bytes, s>>>(p);
    e = launched();
    if (e != cudaSuccess) return (int)e;
  }
  if (grad_mx || grad_my) {
    const dim3 grid(p.n_bands, B);
    if (grad_mx && grad_my)
      grad_maps_kernel<true, true><<<grid, kThreads, 0, s>>>(p);
    else if (grad_mx)
      grad_maps_kernel<true, false><<<grid, kThreads, 0, s>>>(p);
    else
      grad_maps_kernel<false, true><<<grid, kThreads, 0, s>>>(p);
    cudaError_t e = launched();
    if (e != cudaSuccess) return (int)e;
    if (grad_mx) {
      sum_bands_kernel<<<dim3((W_out + kThreads - 1) / kThreads, B), kThreads, 0, s>>>(p);
      e = launched();
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// *count: the kernels attwarp_warp_resample_backward has launched since the
// library was loaded. Returns 0.
extern "C" int attwarp_warp_resample_backward_kernels(int* count) {
  *count = g_kernels;
  return 0;
}
