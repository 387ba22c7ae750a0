// Kernel K1: separable bilinear warp resample, cv2.remap(INTER_LINEAR,
// BORDER_REPLICATE) semantics, for Hopper (sm_90a).
//
// Replaces: attwarp_tpu/ops/pallas_warp.py::warp_batch_pallas_cf (body
// _warp_kernel), the TPU kernel that builds two-banded interpolation
// matrices R_y, R_x in VMEM and computes R_y . img . R_x^T per (image,
// channel) on the MXU with a two-level int8 fixed-point core.
//
// What bounds it on the H100: memory. Each output pixel needs 4 source taps
// of C floats and writes C floats: about 2 flops per byte moved, far below
// the card's ~20 flops/byte f32 balance point. The matrix form the TPU used
// would multiply ~100x more flops, and in TF32 would break the 1e-3 pixel
// budget.
//
// Design: a direct 4-tap gather. One thread per output pixel computes all C
// channels in f32 from the taps at the clamped floor/floor+1 of its source
// coordinates (both neighbours clamped from the unclipped floor, as the
// plain version does). Output writes are coalesced along W_out; source rows
// are read through the read-only cache, and neighbouring threads share taps.
//
// Layout: img (B, H, W, C) f32, map_x (B, W_out) f32, map_y (B, H_out) f32,
// out (B, H_out, W_out, C) f32, all contiguous.

#include <cuda_runtime.h>

namespace {

__global__ void warp_resample_kernel(const float* __restrict__ img,
                                     const float* __restrict__ map_x,
                                     const float* __restrict__ map_y,
                                     float* __restrict__ out,
                                     int B, int H, int W, int C,
                                     int H_out, int W_out) {
  const long long n = (long long)B * H_out * W_out;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const int j = (int)(idx % W_out);
    const long long r = idx / W_out;
    const int i = (int)(r % H_out);
    const int b = (int)(r / H_out);

    const float x = __ldg(map_x + (long long)b * W_out + j);
    const float y = __ldg(map_y + (long long)b * H_out + i);
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int xi = (int)x0f;
    const int yi = (int)y0f;
    const int x0 = min(max(xi, 0), W - 1);
    const int x1 = min(max(xi + 1, 0), W - 1);
    const int y0 = min(max(yi, 0), H - 1);
    const int y1 = min(max(yi + 1, 0), H - 1);

    const float* base = img + (long long)b * H * W * C;
    const float* r0 = base + (long long)y0 * W * C;
    const float* r1 = base + (long long)y1 * W * C;
    float* o = out + idx * C;
    for (int c = 0; c < C; ++c) {
      // x pass, then y pass: the plain version's order of operations
      const float top = __ldg(r0 + x0 * C + c) * (1.0f - fx) +
                        __ldg(r0 + x1 * C + c) * fx;
      const float bot = __ldg(r1 + x0 * C + c) * (1.0f - fx) +
                        __ldg(r1 + x1 * C + c) * fx;
      o[c] = top * (1.0f - fy) + bot * fy;
    }
  }
}

}  // namespace

extern "C" int attwarp_warp_resample(const float* img, const float* map_x,
                                     const float* map_y, float* out,
                                     int B, int H, int W, int C,
                                     int H_out, int W_out, void* stream) {
  const long long n = (long long)B * H_out * W_out;
  if (n <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond this
  warp_resample_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(img, map_x, map_y, out, B, H,
                                                 W, C, H_out, W_out);
  return (int)cudaGetLastError();
}
