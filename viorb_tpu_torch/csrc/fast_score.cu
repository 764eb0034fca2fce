// FAST-9/16 arc strength for a whole image pyramid in one launch, with the
// per-16x16-cell maximum and argmax fused in; hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel viorb_tpu/features/fast_pallas.py::_fast_kernel
// (called through fast_score_map_pallas) and, in its cell mode, the
// mask-and-argmax half of viorb_tpu/features/fast.py::grid_topk_keypoints.
// Two entry points share one __global__ template:
//
//   viorb_fast_score_map  one image -> its score map, 3 px border zeroed:
//                         the TPU kernel's exact function;
//   viorb_fast_cells      up to 8 pyramid levels -> for every 16x16 cell of
//                         every level the best score inside
//                         [border, h-border) x [border, w-border) and the
//                         in-cell index row*16+col of its first occurrence.
//                         No score map is written.
//
// The function. For a pixel c and its 16 radius-3 Bresenham neighbours p_i,
//     score = max(0, max_k min_{i in W_k}(p_i - c), max_k min_{i in W_k}(c - p_i))
// over the 16 circular windows W_k of 9 consecutive neighbours. Rounding is
// monotone, so min_i fl(p_i - c) = fl(min_i p_i - c): the window minima and
// maxima are taken on the pixels themselves and c is subtracted twice, not
// 16 times. min, max, one subtraction and a negation are exact in f32, so
// the result is equal, value for value, to the plain PyTorch version
// (features/fast.py::_fast_score_map_torch and _fast_cells_pyramid_torch)
// and to the reference's jnp and Pallas versions.
//
// What bounds it on the H100. Bytes: the 8 levels of a 752x480 frame are
// 1,117,367 f32 pixels, 4.47 MB read, and 4262 cells, 51 KB written (f32
// best, i64 arg): 1.35 us at 3.35 TB/s, the kernel's bound. Operations:
// 84 instructions on each of the 913,345 pixels inside the border, 1.15 us
// at the 67 TFLOP/s f32 peak; but that peak counts an FMA as two and none
// of these is an FMA, so the ALUs need 2.3 us or more: they, not the
// memory, are what this kernel fills, and an empty launch alone takes
// 1.6 us back to back (chip_smoke.py, H100 80GB HBM3 at 700 W). The design
// answers each:
//   - one launch for all levels: a flat 1-D grid, each block finds its
//     (level, tile) in a table of at most 8 entries passed by value as the
//     kernel parameter (__grid_constant__, no device-side table, no copy,
//     no host sync);
//   - tiles aligned to cells: a block owns 32x32 pixels = 2x2 cells, stages
//     them and a 3 px halo in shared memory once (38x38 words, 5.8 KB), and
//     reduces each cell inside the block: registers, 16-lane shuffles, one
//     pass through shared memory. Nothing crosses blocks: no atomics, no
//     second pass. Tiles wholly outside the border are not loaded;
//   - fewer ALU operations: pixels are staged as order-preserving integer
//     keys, so the window minima and maxima are 3-input integer min/max
//     (Hopper's DPX instructions): windows of 9 = 3 x 3, 40 instructions a
//     polarity against 80 for a 2-input tree on the 16 differences;
//   - one wait for memory a block: a thread issues all its 6 staging loads
//     before it uses the first;
//   - ties: a score is a non-negative f32, so its bits order as an unsigned
//     integer; a cell reduces the 64-bit key (score bits << 32) | ~index
//     with max, which yields the best score and its lowest index at once;
//   - loads are 4-byte and coalesced: level widths (627, 522, 435, ...) give
//     row pitches that are no multiple of 16 bytes, so neither TMA tiles nor
//     float4 loads apply to the pyramid as it is laid out.
// The TPU kernel's 64-row VMEM chunks and 128-lane padding are not carried
// over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kCell = 16;          // cell edge (pixels)
constexpr int kTile = 32;          // tile edge: 2x2 cells
constexpr int kRowsPerThread = 4;  // block is kTile x (kTile / kRowsPerThread)
constexpr int kWarps = kTile / kRowsPerThread;
constexpr int kPad = 3;            // circle radius
constexpr int kSmem = kTile + 2 * kPad;

struct FastLevel {
  const float* img;  // (h, w) contiguous f32
  float* score;      // (h, w) score map; score mode only
  int h, w;
  int y_end, x_end;  // scored pixels are [border, y_end) x [border, x_end)
  int tiles_x;       // tiles in a tile row
  int tile_end;      // first block index past this level's tiles
  int hc, wc;        // cells of this level; cell mode only
  int cell_off;      // offset of its cells in the flat outputs
};

struct FastParams {
  FastLevel lv[kMaxLevels];
  float* cell_best;      // flat f32, cell mode only
  long long* cell_arg;   // flat i64, cell mode only
  int n_levels;
  int border;
};

// f32 bits -> a signed integer with the same order (and back: the map is
// its own inverse). -0.0 sorts just below +0.0, which no result shows.
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// FAST score of the pixel at tile[cy][cx] from its ring of 16 keys.
__device__ __forceinline__ float fast_score(const int (&tile)[kSmem][kSmem],
                                            int cy, int cx) {
  // Bresenham circle of radius 3 as (dy, dx), clockwise from 12 o'clock:
  // the order of CIRCLE_OFFSETS in features/fast.py.
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  int p[16], lo3[16], hi3[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = tile[cy + dy[k]][cx + dx[k]];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo3[k] = __vimin3_s32(p[k], p[(k + 1) & 15], p[(k + 2) & 15]);
    hi3[k] = __vimax3_s32(p[k], p[(k + 1) & 15], p[(k + 2) & 15]);
  }
  // min / max over each window of 9 = three windows of 3
  int lo9[16], hi9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    lo9[k] = __vimin3_s32(lo3[k], lo3[(k + 3) & 15], lo3[(k + 6) & 15]);
    hi9[k] = __vimax3_s32(hi3[k], hi3[(k + 3) & 15], hi3[(k + 6) & 15]);
  }
  // brightest window minimum, darkest window maximum
  int lo[6], hi[6];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    lo[k] = __vimax3_s32(lo9[3 * k], lo9[3 * k + 1], lo9[3 * k + 2]);
    hi[k] = __vimin3_s32(hi9[3 * k], hi9[3 * k + 1], hi9[3 * k + 2]);
  }
  lo[5] = lo9[15];
  hi[5] = hi9[15];
  const int best_lo = max(__vimax3_s32(lo[0], lo[1], lo[2]), __vimax3_s32(lo[3], lo[4], lo[5]));
  const int best_hi = min(__vimin3_s32(hi[0], hi[1], hi[2]), __vimin3_s32(hi[3], hi[4], hi[5]));
  const float c = __int_as_float(order_key(tile[cy][cx]));
  const float bright = __int_as_float(order_key(best_lo)) - c;
  const float dark = c - __int_as_float(order_key(best_hi));
  return fmaxf(fmaxf(bright, dark), 0.0f);
}

// kCells = false: write the score map of prm.lv[0] (n_levels = 1).
// kCells = true: write cell_best / cell_arg of every level, no score map.
template <bool kCells>
__global__ void __launch_bounds__(kTile * kWarps)
    fast_kernel(const __grid_constant__ FastParams prm) {
  __shared__ int tile[kSmem][kSmem];
  __shared__ unsigned long long warp_key[kWarps][4];

  int l = 0;
  while (l + 1 < prm.n_levels && static_cast<int>(blockIdx.x) >= prm.lv[l].tile_end) ++l;
  const FastLevel& lv = prm.lv[l];
  const int t = blockIdx.x - (l == 0 ? 0 : prm.lv[l - 1].tile_end);
  const int tile_y = t / lv.tiles_x;
  const int tile_x = t - tile_y * lv.tiles_x;
  const int x0 = tile_x * kTile;
  const int y0 = tile_y * kTile;
  const int h = lv.h, w = lv.w, border = prm.border;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  if (kCells) {
    // a tile with no scored pixel: its cells are all zero, first index 0
    const bool live = y0 < lv.y_end && y0 + kTile > border &&
                      x0 < lv.x_end && x0 + kTile > border;
    if (!live) {
      const int cy = tile_y * 2 + (tid >> 1), cx = tile_x * 2 + (tid & 1);
      if (tid < 4 && cy < lv.hc && cx < lv.wc) {
        prm.cell_best[lv.cell_off + cy * lv.wc + cx] = 0.0f;
        prm.cell_arg[lv.cell_off + cy * lv.wc + cx] = 0;
      }
      return;
    }
  }

  // Stage the tile and its halo as ordered keys. Pixels outside the image
  // load as 0: no scored pixel reads them, since border >= kPad. All of a
  // thread's loads are issued before the first is used, so a block waits
  // for device memory once.
  constexpr int kThreads = kTile * kWarps;
  constexpr int kLoads = (kSmem * kSmem + kThreads - 1) / kThreads;
  float staged[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kThreads;
    const int sy = i / kSmem;
    const int gy = y0 + sy - kPad;
    const int gx = x0 + (i - sy * kSmem) - kPad;
    staged[j] = 0.0f;
    if (i < kSmem * kSmem && gy >= 0 && gy < h && gx >= 0 && gx < w)
      staged[j] = lv.img[gy * w + gx];
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = tid + j * kThreads;
    if (i < kSmem * kSmem) (&tile[0][0])[i] = order_key(__float_as_int(staged[j]));
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const bool x_scored = x >= border && x < lv.x_end;
  // this thread's best key in the upper and the lower cell of its column
  // (its rows ty + r * kWarps lie in cell row r * kWarps / kCell)
  unsigned long long key[2] = {0ull, 0ull};
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ty = threadIdx.y + r * kWarps;
    const int y = y0 + ty;
    float score = 0.0f;
    if (x_scored && y >= border && y < lv.y_end)
      score = fast_score(tile, ty + kPad, threadIdx.x + kPad);
    if (kCells) {
      const unsigned flat = (ty & (kCell - 1)) * kCell + (threadIdx.x & (kCell - 1));
      // score > 0 keeps -0.0 and 0.0 one key
      const unsigned bits = score > 0.0f ? __float_as_uint(score) : 0u;
      const unsigned long long k64 =
          (static_cast<unsigned long long>(bits) << 32) | (0xffffffffu - flat);
      key[r * kWarps / kCell] = max(key[r * kWarps / kCell], k64);
    } else if (y < h && x < w) {
      lv.score[y * w + x] = score;
    }
  }

  if (kCells) {
    // 16 lanes share a cell column: reduce inside each half warp
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = kCell / 2; off > 0; off >>= 1)
        key[c] = max(key[c], __shfl_xor_sync(0xffffffffu, key[c], off));
    }
    if ((threadIdx.x & (kCell - 1)) == 0) {
      const int col = threadIdx.x / kCell;
      warp_key[threadIdx.y][0 * 2 + col] = key[0];
      warp_key[threadIdx.y][1 * 2 + col] = key[1];
    }
    __syncthreads();
    if (tid < 4) {
      unsigned long long best = warp_key[0][tid];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) best = max(best, warp_key[wi][tid]);
      const int cy = tile_y * 2 + (tid >> 1), cx = tile_x * 2 + (tid & 1);
      if (cy < lv.hc && cx < lv.wc) {
        prm.cell_best[lv.cell_off + cy * lv.wc + cx] =
            __uint_as_float(static_cast<unsigned>(best >> 32));
        prm.cell_arg[lv.cell_off + cy * lv.wc + cx] =
            0xffffffffu - static_cast<unsigned>(best & 0xffffffffu);
      }
    }
  }
}

__global__ void empty_kernel() {}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int imin(int a, int b) { return a < b ? a : b; }

}  // namespace

// C interface for ctypes. Every function launches on `stream` (a
// cudaStream_t: PyTorch's current stream), returns the cudaGetLastError()
// code of its launch (0 on success), does not synchronise and allocates
// nothing.

// img, out: contiguous (h, w) f32 device buffers.
extern "C" int viorb_fast_score_map(const void* img, void* out, int h, int w,
                                    void* stream) {
  if (h <= 0 || w <= 0) return 0;
  FastParams prm = {};
  FastLevel& lv = prm.lv[0];
  lv.img = static_cast<const float*>(img);
  lv.score = static_cast<float*>(out);
  lv.h = h;
  lv.w = w;
  lv.y_end = h - kPad;
  lv.x_end = w - kPad;
  lv.tiles_x = ceil_div(w, kTile);
  lv.tile_end = lv.tiles_x * ceil_div(h, kTile);
  prm.n_levels = 1;
  prm.border = kPad;
  fast_kernel<false><<<lv.tile_end, dim3(kTile, kWarps), 0,
                       static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// imgs: n_levels device pointers to contiguous (hs[l], ws[l]) f32 images
// (host array); cell_offs: n_levels offsets into the flat outputs (host
// array), level l holding (hs[l] / 16) * (ws[l] / 16) cells row-major;
// cell_best: f32, cell_arg: i64 device buffers. Needs 1 <= n_levels <= 8
// and border >= 3 (then no scored pixel's circle leaves the image);
// returns cudaErrorInvalidValue otherwise.
extern "C" int viorb_fast_cells(const void* const* imgs, const int* hs,
                                const int* ws, const int* cell_offs,
                                int n_levels, int border, void* cell_best,
                                void* cell_arg, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || border < kPad)
    return static_cast<int>(cudaErrorInvalidValue);
  FastParams prm = {};
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    FastLevel& lv = prm.lv[l];
    lv.img = static_cast<const float*>(imgs[l]);
    lv.h = hs[l];
    lv.w = ws[l];
    lv.hc = hs[l] / kCell;
    lv.wc = ws[l] / kCell;
    // pixels past the last whole cell belong to no cell
    lv.y_end = imin(lv.h - border, lv.hc * kCell);
    lv.x_end = imin(lv.w - border, lv.wc * kCell);
    lv.tiles_x = ceil_div(lv.wc * kCell, kTile);
    tiles += lv.tiles_x * ceil_div(lv.hc * kCell, kTile);
    lv.tile_end = tiles;
    lv.cell_off = cell_offs[l];
  }
  prm.cell_best = static_cast<float*>(cell_best);
  prm.cell_arg = static_cast<long long*>(cell_arg);
  prm.n_levels = n_levels;
  prm.border = border;
  if (tiles == 0) return 0;
  fast_kernel<true><<<tiles, dim3(kTile, kWarps), 0,
                      static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// One empty block: the least a launch costs on this card.
extern "C" int viorb_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
