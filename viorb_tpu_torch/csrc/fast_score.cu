// FAST-9/16 arc-strength score map, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel viorb_tpu/features/fast_pallas.py::_fast_kernel
// (called through fast_score_map_pallas). Same function, same min/max tree:
// for every pixel c and its 16 radius-3 Bresenham neighbours p_i,
//     d_i   = p_i - c                  (bright)   and  -d_i  (dark)
//     m9_k  = min over the 9 consecutive d_{k..k+8 mod 16}
//             (tree: m2 -> m4 -> m8 -> min(m8, d_{k+8}))
//     score = max(max_k m9_k(bright), max_k m9_k(dark), 0)
// with a 3 px border set to 0. Subtraction, negation, min and max are exact
// in f32, so the output is bit-equal to the plain PyTorch version
// (viorb_tpu_torch/features/fast.py::_fast_score_map_torch) and to the
// reference's jnp and Pallas versions.
//
// What bounds it on the H100: memory. Per pixel it reads 4 B and writes
// 4 B (plus a 3 px halo per tile, ~40 % extra reads at 32x32 tiles, served
// mostly from L2) against ~60 min/max/sub ops: ~8 ops per byte, far below
// the ~20 f32 ops per byte at which the SMs would be the limit
// (67 TFLOP/s / 3.35 TB/s). The design answers that by touching device
// memory once each way: a block stages its 32x32 tile plus the halo in
// shared memory (38x38 f32, 5.8 KB), and every thread scores its pixels
// from there with all 16 differences in registers. The TPU kernel's
// 64-row VMEM chunks are not carried over. At these sizes (at most
// 480x752 = 1.4 MB a level) the launch itself is a large part of the
// time; fusing the 8 levels and the per-cell argmax into one launch is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;          // output tile edge (pixels)
constexpr int kRowsPerThread = 4;  // block is kTile x (kTile / kRowsPerThread)
constexpr int kPad = 3;            // circle radius
constexpr int kSmem = kTile + 2 * kPad;

// Bresenham circle of radius 3 as (dy, dx), clockwise from 12 o'clock:
// the order of CIRCLE_OFFSETS in features/fast.py.
__device__ __constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                       3,  3,  2,  1,  0, -1, -2, -3};
__device__ __constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                       0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float arc_strength(const float (&d)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(d[k], d[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m8[k] = fminf(m4[k], m4[(k + 4) & 15]);
  float out = fminf(m8[0], d[8]);
#pragma unroll
  for (int k = 1; k < 16; ++k) out = fmaxf(out, fminf(m8[k], d[(k + 8) & 15]));
  return out;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int h, int w) {
  __shared__ float tile[kSmem][kSmem];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // Stage the tile and its halo. Pixels outside the image load as 0: only
  // the zeroed 3 px border ever reads them.
  for (int i = tid; i < kSmem * kSmem; i += nthreads) {
    const int sy = i / kSmem;
    const int sx = i - sy * kSmem;
    const int gy = y0 + sy - kPad;
    const int gx = x0 + sx - kPad;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = img[gy * w + gx];
    tile[sy][sx] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= w) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ty = threadIdx.y + r * (kTile / kRowsPerThread);
    const int y = y0 + ty;
    if (y >= h) break;
    float score = 0.0f;
    if (y >= kPad && y < h - kPad && x >= kPad && x < w - kPad) {
      const int cy = ty + kPad;
      const int cx = threadIdx.x + kPad;
      const float c = tile[cy][cx];
      float bright[16], dark[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        bright[k] = tile[cy + kDy[k]][cx + kDx[k]] - c;
        dark[k] = -bright[k];
      }
      score = fmaxf(fmaxf(arc_strength(bright), arc_strength(dark)), 0.0f);
    }
    out[y * w + x] = score;
  }
}

}  // namespace

// C interface for ctypes. img/out: contiguous (h, w) f32 device buffers;
// stream: a cudaStream_t (PyTorch's current stream). Returns the
// cudaGetLastError() code of the launch (0 on success). Does not
// synchronise and allocates nothing.
extern "C" int viorb_fast_score_map(const void* img, void* out, int h, int w,
                                    void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(kTile, kTile / kRowsPerThread);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
