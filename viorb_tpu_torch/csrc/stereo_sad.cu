// K9: stereo sub-pixel refinement by SAD, hand-written for Hopper (sm_90a).
//
// Replaces viorb_tpu/slam/kernels.py::refine_stereo_subpixel, an XLA
// program the reference wrote in TPU form: per matched keypoint a vmapped
// pair of dynamic slices (an 11x11 left patch, an 11x17 right strip of the
// edge-padded images), the 7 SADs of the patch against the strip's shifted
// views (+-3 px around the rounded descriptor match), the first smallest
// and a parabola through it and its neighbours. Here:
//
//   * one warp a keypoint, 4 keypoints a block: the lanes stage the patch
//     (121 floats) and the strip (187) in shared memory, reading each pixel
//     of the padded image through the edge clamp instead of padding the
//     image (no padded copy is written to device memory);
//   * the window starts are those of jax.lax.dynamic_slice on the padded
//     image (pad 9): the rounded coordinate (half to even, __float2int_rn),
//     a negative start counted from the end of the axis, then clamped so
//     that the window stays inside; an unmatched ur0 = -1 lands on the pad;
//   * lanes 0..6 each take one shift and add |l - r| over the window as ONE
//     running f32 sum in row-major order, the order of the plain version
//     (slam/kernels.py::refine_stereo_subpixel): the images are f32 and not
//     integer-valued, so a SAD depends on its order, and this one makes
//     kernel and plain equal bit for bit;
//   * lane 0 takes the first smallest SAD (strict <: a tie goes to the
//     first shift) and fits the parabola with explicitly rounded
//     operations (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc contracts
//     nothing into an FMA that the plain version rounds twice.
//
// What bounds it on the H100. Bytes: each keypoint reads 121 + 187 pixels
// (1232 B), its xy, ur0 and flag (13 B) and writes ur (4 B): 1.25 MB at
// N = 1000, ~0.37 us at 3.35 TB/s. Operations: 7 x 121 x 3 f32 operations
// a keypoint, 2.5 MFLOP at N = 1000, ~0.04 us at 67 TFLOP/s. Both lie far
// below one kernel launch (~2 us): the kernel is launch- and latency-bound,
// and 250 blocks of 4 warps put a keyframe's keypoints in flight at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalf = 5;                    // an 11x11 window
constexpr int kSearch = 3;                  // +-3 px
constexpr int kWin = 2 * kHalf + 1;         // 11
constexpr int kShifts = 2 * kSearch + 1;    // 7
constexpr int kStrip = kWin + 2 * kSearch;  // 17
constexpr int kPad = kHalf + kSearch + 1;   // the reference's edge pad: 9
constexpr int kWarps = 4;                   // keypoints a block

// dynamic_slice's start on an axis of n: negative counts from the end, then
// clamped so that a window of `size` stays inside
__device__ __forceinline__ int window_start(float x, int lo, int size, int n) {
  int i = __float2int_rn(x) + lo;
  if (i < 0) i += n;
  return min(max(i, 0), n - size);
}

__global__ void __launch_bounds__(kWarps * 32)
stereo_sad_kernel(const float* __restrict__ img_l, const float* __restrict__ img_r, int h, int w,
                  const float* __restrict__ xy_l, const float* __restrict__ ur0,
                  const uint8_t* __restrict__ matched, int n, float* __restrict__ ur) {
  __shared__ float patch[kWarps][kWin * kWin];
  __shared__ float strip[kWarps][kWin * kStrip];
  __shared__ float sads[kWarps][kShifts];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n) return;  // the whole warp leaves: the block has no block-wide barrier
  const int hp = h + 2 * kPad, wp = w + 2 * kPad;
  const float u0 = ur0[k];
  const int y0 = window_start(xy_l[2 * k + 1], kPad - kHalf, kWin, hp) - kPad;
  const int xl0 = window_start(xy_l[2 * k], kPad - kHalf, kWin, wp) - kPad;
  const int xr0 = window_start(u0, kPad - kHalf - kSearch, kStrip, wp) - kPad;
  // a padded pixel is the image's pixel at the clamped coordinate
  for (int i = lane; i < kWin * kWin; i += 32) {
    const int yy = min(max(y0 + i / kWin, 0), h - 1);
    const int xx = min(max(xl0 + i % kWin, 0), w - 1);
    patch[warp][i] = img_l[static_cast<size_t>(yy) * w + xx];
  }
  for (int i = lane; i < kWin * kStrip; i += 32) {
    const int yy = min(max(y0 + i / kStrip, 0), h - 1);
    const int xx = min(max(xr0 + i % kStrip, 0), w - 1);
    strip[warp][i] = img_r[static_cast<size_t>(yy) * w + xx];
  }
  __syncwarp();
  if (lane < kShifts) {
    float acc = 0.f;
    for (int r = 0; r < kWin; ++r)
      for (int c = 0; c < kWin; ++c)
        acc = __fadd_rn(acc, fabsf(__fsub_rn(patch[warp][r * kWin + c], strip[warp][r * kStrip + c + lane])));
    sads[warp][lane] = acc;
  }
  __syncwarp();
  if (lane != 0) return;
  const float* s = sads[warp];
  int best = 0;
  for (int d = 1; d < kShifts; ++d)
    if (s[d] < s[best]) best = d;
  const int bi = min(max(best, 1), kShifts - 2);
  const float s0 = s[bi], sm = s[bi - 1], sp = s[bi + 1];
  const float denom = __fadd_rn(__fsub_rn(sm, __fmul_rn(2.f, s0)), sp);
  float frac = 0.f;
  if (fabsf(denom) > 1e-6f) frac = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(sm, sp)), fmaxf(denom, 1e-6f));
  frac = fminf(fmaxf(frac, -1.f), 1.f);
  const bool interior = best > 0 && best < kShifts - 1;
  const float off = interior ? __fadd_rn(static_cast<float>(bi - kSearch), frac) : 0.f;
  ur[k] = matched[k] ? __fadd_rn(rintf(u0), off) : -1.f;
}

}  // namespace

// (H,W) f32 images, (N,2) f32 keypoints, (N,) f32 ur0, (N,) uint8 flags ->
// (N,) f32 ur, one launch on `stream` (nothing for N = 0); returns the
// launch's cudaError_t.
extern "C" int viorb_stereo_sad(const void* img_l, const void* img_r, int h, int w, const void* xy_l,
                                const void* ur0, const void* matched, int n, void* ur, void* stream) {
  if (n <= 0) return 0;
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stereo_sad_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img_l), static_cast<const float*>(img_r), h, w, static_cast<const float*>(xy_l),
      static_cast<const float*>(ur0), static_cast<const uint8_t*>(matched), n, static_cast<float*>(ur));
  return static_cast<int>(cudaGetLastError());
}
