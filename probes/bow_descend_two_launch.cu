// The earlier, two-launch version of K8 (the walk, then a one-block
// normalization, after the caller's memset of the counts), kept only for
// probes/k8_variants.py, which times it beside csrc/bow_descend.cu in one
// call on the same card.
// K8: the bag-of-words vocabulary-tree descent with the tf-idf word
// histogram, hand-written for Hopper (sm_90a).
//
// Replaces viorb_tpu/bow/vocabulary.py::_descend_device, an XLA program
// the reference wrote in TPU form: at each of up to 8 levels it gathers
// every descriptor's children's centers as {-1,+1} f32 rows and takes the
// argmax of the +-1 dot product on the matrix unit; then a scatter-add of
// idf weights into a word histogram, L1-normalized. Here the same function
// runs as bit operations:
//
//   * descriptors arrive as (N, 256) uint8 {0,1} rows and are packed into
//     8 u32 words INSIDE the kernel: a warp owns a descriptor, lane l reads
//     its bytes 8l..8l+7 as one 8-byte load (the row is one coalesced 256 B
//     transaction) and the 32 bytes of bits are gathered by shuffles;
//   * the node centers are packed once, at vocabulary upload, to
//     (nodes, 8) u32 (bit b of the descriptor is bit b%32 of word b/32, as
//     here) and staged in shared memory when they fit (1111 nodes of the
//     stock tree: 35.5 KB);
//   * the walk: at each level lane j < k scores child slot j as the Hamming
//     distance sum_w popc(d_w ^ c_w) (invalid slots score INT_MAX), and one
//     warp min over the key (distance << 8 | slot) picks the nearest child,
//     ties to the lowest slot. The reference's argmax of the +-1 dot, ties
//     to the first, is the same choice: dot = 256 - 2 * hamming, exactly.
//     A leaf stops the walk; at most 8 levels, as the reference's loop;
//   * the histogram: one int32 atomicAdd per valid word (exact, so the
//     result does not depend on the order), then a second one-block pass
//     forms counts * idf and divides by its sum (the reference's
//     hist / max(sum, 1e-12)).
//
// What bounds it on the H100. Bytes: at N = 1000 a keyframe's descriptors
// are 256 KB, the stock tree's centers 35.5 KB and children 44 KB: ~0.1 us
// at 3.35 TB/s. Operations: <= 3 levels x 10 children x 8 popcounts =
// 240 a descriptor, 240,000 at N = 1000, ~0.06 us at the 16 popcounts a
// clock an SM (CUDA C++ Programming Guide, compute capability 9.0) of 132
// SMs. Both are far below a launch (~2 us): the kernel is launch- and
// latency-bound, a chain of dependent levels per warp. The design keeps it
// to two launches (the walk, the normalization) on the caller's stream,
// no host sync, no allocation; the caller zeroes the counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;          // warps (descriptors in flight) a block
constexpr int kMaxDepth = 8;        // the reference's fori_loop bound
constexpr int kMaxChildren = 32;    // one lane a child slot
constexpr int kWords = 8;           // 256 bits

template <bool kShared>
__global__ void __launch_bounds__(kWarps * 32)
descend_kernel(const uint8_t* __restrict__ desc, const uint8_t* __restrict__ valid, int n,
               const uint32_t* __restrict__ centers, const int* __restrict__ children,
               const uint8_t* __restrict__ is_leaf, const int* __restrict__ word_id,
               int n_nodes, int k, int* __restrict__ words, int* __restrict__ counts) {
  extern __shared__ uint32_t s_centers[];
  if (kShared) {
    for (int i = threadIdx.x; i < n_nodes * kWords; i += blockDim.x) s_centers[i] = centers[i];
    __syncthreads();
  }
  const uint32_t* cen = kShared ? s_centers : centers;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    // pack: lane l holds bits 8l..8l+7 as one byte
    const uint2 raw = reinterpret_cast<const uint2*>(desc + static_cast<size_t>(row) * 256)[lane];
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      byte |= ((raw.x >> (8 * j)) & 1u) << j;
      byte |= ((raw.y >> (8 * j)) & 1u) << (j + 4);
    }
    // word w = bytes of lanes 4w..4w+3, little-endian
    uint32_t word = byte;
    word |= __shfl_down_sync(0xffffffffu, byte, 1) << 8;
    word |= __shfl_down_sync(0xffffffffu, byte, 2) << 16;
    word |= __shfl_down_sync(0xffffffffu, byte, 3) << 24;
    uint32_t d[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) d[w] = __shfl_sync(0xffffffffu, word, 4 * w);

    int node = 0;
    for (int level = 0; level < kMaxDepth; ++level) {
      if (is_leaf[node]) break;  // uniform across the warp
      int child = lane < k ? children[node * k + lane] : -1;
      uint32_t key = 0xffffffffu;
      if (child >= 0) {
        const uint32_t* c = cen + child * kWords;
        uint32_t dist = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) dist += __popc(d[w] ^ c[w]);
        key = (dist << 8) | static_cast<uint32_t>(lane);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
      if (key == 0xffffffffu) break;  // no valid child: stays here (a malformed tree)
      node = children[node * k + static_cast<int>(key & 0xffu)];
    }
    if (lane == 0) {
      int w = valid[row] ? word_id[node] : -1;
      words[row] = w;
      if (w >= 0) atomicAdd(counts + w, 1);
    }
  }
}

// One block: weights = counts * idf / max(sum, 1e-12).
__global__ void __launch_bounds__(1024)
normalize_kernel(const int* __restrict__ counts, const float* __restrict__ idf, int n_words,
                 float* __restrict__ weights) {
  __shared__ float partial[32];
  float sum = 0.f;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sum += static_cast<float>(counts[i]) * idf[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < (blockDim.x >> 5) ? partial[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) partial[0] = s;
  }
  __syncthreads();
  const float denom = fmaxf(partial[0], 1e-12f);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    weights[i] = static_cast<float>(counts[i]) * idf[i] / denom;
}

}  // namespace

// desc: (n, 256) uint8 {0,1}, rows 8-byte aligned; valid: (n,) uint8;
// centers: (n_nodes, 8) u32 packed; children: (n_nodes, k) int32 (-1 =
// none); is_leaf: (n_nodes,) uint8; word_id: (n_nodes,) int32; idf:
// (n_words,) f32. Out: words (n,) int32, counts (n_words,) int32 (ZEROED
// by the caller), weights (n_words,) f32. Needs 1 <= k <= 32; returns
// cudaErrorInvalidValue otherwise, else the launches' cudaGetLastError().
extern "C" int viorb_bow_descend(const void* desc, const void* valid, int n, const void* centers,
                                 const void* children, const void* is_leaf, const void* word_id,
                                 int n_nodes, int k, const void* idf, int n_words, void* words,
                                 void* counts, void* weights, void* stream) {
  if (k < 1 || k > kMaxChildren || n < 0 || n_nodes < 1 || n_words < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    const size_t smem = static_cast<size_t>(n_nodes) * kWords * sizeof(uint32_t);
    int dev = 0, max_smem = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    auto* d = static_cast<const uint8_t*>(desc);
    auto* v = static_cast<const uint8_t*>(valid);
    auto* c = static_cast<const uint32_t*>(centers);
    auto* ch = static_cast<const int*>(children);
    auto* leaf = static_cast<const uint8_t*>(is_leaf);
    auto* wid = static_cast<const int*>(word_id);
    if (smem <= static_cast<size_t>(max_smem)) {
      if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(descend_kernel<true>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      descend_kernel<true><<<blocks, kWarps * 32, smem, s>>>(
          d, v, n, c, ch, leaf, wid, n_nodes, k, static_cast<int*>(words), static_cast<int*>(counts));
    } else {
      descend_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
          d, v, n, c, ch, leaf, wid, n_nodes, k, static_cast<int*>(words), static_cast<int*>(counts));
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_words > 0) {
    normalize_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(counts), static_cast<const float*>(idf),
                                        n_words, static_cast<float*>(weights));
  }
  return static_cast<int>(cudaGetLastError());
}
