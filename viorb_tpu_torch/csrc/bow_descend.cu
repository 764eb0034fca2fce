// K8: the bag-of-words vocabulary-tree descent with the tf-idf word
// histogram, hand-written for Hopper (sm_90a).
//
// Replaces viorb_tpu/bow/vocabulary.py::_descend_device, an XLA program
// the reference wrote in TPU form: at each of up to 8 levels it gathers
// every descriptor's children's centers as {-1,+1} f32 rows and takes the
// argmax of the +-1 dot product on the matrix unit; then a scatter-add of
// idf weights into a word histogram, L1-normalized. Here the same function
// runs as bit operations, in ONE launch of one thread-block cluster:
//
//   * descriptors arrive as (N, 256) uint8 {0,1} rows and are packed into
//     8 u32 words INSIDE the kernel: a group of lanes owns a descriptor (16
//     lanes when a node has at most 16 children, as the stock tree's 10,
//     else a warp), lane l of a group of G reads its bytes (256/G)l.. as one
//     16- or 8-byte load (the row is one coalesced 256 B transaction) and
//     the 32 bytes of bits are gathered by shuffles;
//   * the node centers are packed once, at vocabulary upload, to
//     (nodes, 8) u32 (bit b of the descriptor is bit b%32 of word b/32, as
//     here) and read through the read-only path (L1 / L2): the walks of a
//     keyframe touch a few hundred of the tree's nodes, and staging the
//     whole tree in every block cost more than the walks;
//   * the walk: at each level lane j < k of the group scores child slot j as
//     the Hamming distance sum_w popc(d_w ^ c_w) (invalid slots score
//     INT_MAX), and one group min over the key (distance << 8 | slot) picks the nearest child,
//     ties to the lowest slot. The reference's argmax of the +-1 dot, ties
//     to the first, is the same choice: dot = 256 - 2 * hamming, exactly.
//     The chosen child's id and leaf flag come from its lane by a shuffle,
//     so a level is one round of loads. A leaf stops the walk; at most 8
//     levels, as the reference's loop;
//   * the histogram: the cluster's CTAs descend disjoint descriptors and add
//     one int32 count per valid word into ONE histogram, with integer
//     atomics (exact, so the result does not depend on their order):
//       - shared path (the histogram fits in shared memory, as the stock
//         tree's 1000 words do): the leader CTA's shared memory, reached
//         from every CTA of the cluster as distributed shared memory. The
//         leader zeroes it before the first cluster barrier; after the
//         second, it alone forms counts * idf and divides by their sum;
//       - global path (a tree whose words do not fit): a scratch histogram
//         in device memory that the caller allocates per call, zeroed by
//         the cluster before the first barrier; after the second, every CTA
//         sums the whole histogram in the same fixed order and writes its
//         share of the weights;
//     the sum runs in a fixed order (a thread's strided words, a warp's
//     xor tree, then the warps' partials), as the reference's
//     hist / max(sum, 1e-12).
//
// So one call is one kernel on the caller's stream: no memset, no second
// launch, no host sync, and no scratch that two calls in flight could share
// (the worker's keyframes and the main thread's load_map call it).
//
// What bounds it on the H100. Bytes: at N = 1000 a keyframe's descriptors
// are 256 KB and the visited nodes of the stock tree ~50 KB: ~0.09 us at
// 3.35 TB/s. Operations: <= 3 levels x 10 children x 8 popcounts = 240 a
// descriptor, 240,000 at N = 1000, ~0.06 us at the 16 popcounts a clock an
// SM (CUDA C++ Programming Guide, compute capability 9.0) of 132 SMs. Both
// are far below one launch (~2 us): the kernel is launch- and latency-bound,
// a chain of dependent levels per group, and a cluster of 16 CTAs x 64
// groups holds a keyframe's 1000 descriptors in flight at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;          // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDepth = 8;        // the reference's fori_loop bound
constexpr int kMaxChildren = 32;    // one lane a child slot
constexpr int kMaxCluster = 16;     // Hopper's largest (non-portable) cluster

// The block's fixed-order sum of counts[i] * idf[i] over i = first, first +
// step, ... < n_words (each thread's strided terms, a warp xor tree, then
// warp 0 over the warps' partials), broadcast to every thread.
template <bool kCacheGlobal>
__device__ float weighted_sum(const int* counts, const float* __restrict__ idf, int n_words, float* partial) {
  float sum = 0.f;
  for (int i = threadIdx.x; i < n_words; i += kThreads) {
    const int c = kCacheGlobal ? __ldcg(counts + i) : counts[i];
    sum += static_cast<float>(c) * idf[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = partial[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) partial[kWarps] = s;
  }
  __syncthreads();
  return partial[kWarps];
}

template <bool kSharedHist, int kGroup>
__global__ void __launch_bounds__(kThreads)
descend_kernel(const uint8_t* __restrict__ desc, const uint8_t* __restrict__ valid, int n,
               const uint4* __restrict__ centers, const int* __restrict__ children,
               const uint8_t* __restrict__ is_leaf, const int* __restrict__ word_id, int k,
               const float* __restrict__ idf, int n_words, int* __restrict__ words,
               float* __restrict__ weights, int* __restrict__ global_hist) {
  static_assert(kGroup == 16 || kGroup == 32, "a descriptor takes a half warp or a warp");
  constexpr int kBytes = 256 / kGroup;  // bytes (= bits packed) a lane reads of its row
  extern __shared__ int s_hist[];  // the leader's histogram (shared path)
  __shared__ float partial[kWarps + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int sub = lane & (kGroup - 1);  // the lane's place in its group
  const unsigned mask = kGroup == 32 ? 0xffffffffu : (0xffffu << (lane & 16));

  int* hist;
  if (kSharedHist) {
    if (rank == 0)
      for (int i = threadIdx.x; i < n_words; i += kThreads) s_hist[i] = 0;
    hist = cluster.map_shared_rank(s_hist, 0);
  } else {
    for (int i = rank * kThreads + threadIdx.x; i < n_words; i += ctas * kThreads) global_hist[i] = 0;
    hist = global_hist;
  }
  cluster.sync();  // the histogram is zero before any count lands

  const bool root_leaf = is_leaf[0];
  constexpr int kGroups = kThreads / kGroup;  // descriptors in flight a block
  for (int row = rank * kGroups + static_cast<int>(threadIdx.x) / kGroup; row < n; row += ctas * kGroups) {
    // pack: the lane's kBytes bytes of its row (one 8- or 16-byte load; a
    // group reads the 256 B row in one coalesced pass) -> kBytes bits
    const uint8_t* src = desc + static_cast<size_t>(row) * 256 + sub * kBytes;
    uint32_t bits = 0;
    if (kGroup == 32) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bits |= ((raw.x >> (8 * j)) & 1u) << j;
        bits |= ((raw.y >> (8 * j)) & 1u) << (j + 4);
      }
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(src);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bits |= ((raw.x >> (8 * j)) & 1u) << j;
        bits |= ((raw.y >> (8 * j)) & 1u) << (j + 4);
        bits |= ((raw.z >> (8 * j)) & 1u) << (j + 8);
        bits |= ((raw.w >> (8 * j)) & 1u) << (j + 12);
      }
    }
    // word w of the descriptor = the bits of lanes (32 / kBytes) w .. of the
    // group, little-endian
    constexpr int kPerWord = 32 / kBytes;
    uint32_t word = bits;
#pragma unroll
    for (int j = 1; j < kPerWord; ++j) word |= __shfl_down_sync(mask, bits, j, kGroup) << (kBytes * j);
    uint32_t d[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) d[w] = __shfl_sync(mask, word, kPerWord * w, kGroup);

    int node = 0;
    bool leaf = root_leaf;
    for (int level = 0; level < kMaxDepth && !leaf; ++level) {
      const int child = sub < k ? __ldg(children + node * k + sub) : -1;
      uint32_t key = 0xffffffffu;
      int child_leaf = 0;
      if (child >= 0) {
        const uint4 c0 = __ldg(centers + 2 * child);
        const uint4 c1 = __ldg(centers + 2 * child + 1);
        child_leaf = __ldg(is_leaf + child);
        const uint32_t dist = __popc(d[0] ^ c0.x) + __popc(d[1] ^ c0.y) + __popc(d[2] ^ c0.z) +
                              __popc(d[3] ^ c0.w) + __popc(d[4] ^ c1.x) + __popc(d[5] ^ c1.y) +
                              __popc(d[6] ^ c1.z) + __popc(d[7] ^ c1.w);
        key = (dist << 8) | static_cast<uint32_t>(sub);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) key = min(key, __shfl_xor_sync(mask, key, off, kGroup));
      if (key == 0xffffffffu) break;  // no valid child: stays here (a malformed tree)
      const int slot = static_cast<int>(key & 0xffu);
      node = __shfl_sync(mask, child, slot, kGroup);
      leaf = __shfl_sync(mask, child_leaf, slot, kGroup) != 0;
    }
    if (sub == 0) {
      const int w = valid[row] ? word_id[node] : -1;
      words[row] = w;
      if (w >= 0) atomicAdd(hist + w, 1);
    }
  }
  cluster.sync();  // every count has landed; nobody touches the leader's memory after this

  if (kSharedHist) {
    if (rank != 0) return;
    const float denom = fmaxf(weighted_sum<false>(s_hist, idf, n_words, partial), 1e-12f);
    for (int i = threadIdx.x; i < n_words; i += kThreads)
      weights[i] = static_cast<float>(s_hist[i]) * idf[i] / denom;
  } else {
    const float denom = fmaxf(weighted_sum<true>(global_hist, idf, n_words, partial), 1e-12f);
    for (int i = rank * kThreads + threadIdx.x; i < n_words; i += ctas * kThreads)
      weights[i] = static_cast<float>(__ldcg(global_hist + i)) * idf[i] / denom;
  }
}

template <bool kSharedHist, int kGroup>
cudaError_t launch(int cluster, size_t smem, cudaStream_t s, const uint8_t* d, const uint8_t* v, int n,
                   const uint4* c, const int* ch, const uint8_t* leaf, const int* wid, int k, const float* idf,
                   int n_words, int* words, float* weights, int* global_hist) {
  auto kernel = descend_kernel<kSharedHist, kGroup>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, d, v, n, c, ch, leaf, wid, k, idf, n_words, words, weights, global_hist);
}

}  // namespace

// desc: (n, 256) uint8 {0,1}, rows 16-byte aligned; valid: (n,) uint8;
// centers: (n_nodes, 8) u32 packed, 16-byte aligned; children: (n_nodes, k)
// int32 (-1 = none); is_leaf: (n_nodes,) uint8; word_id: (n_nodes,) int32;
// idf: (n_words,) f32. Out: words (n,) int32, weights (n_words,) f32.
// global_hist: NULL for the shared path (n_words int32 must fit in a
// block's shared memory), else (n_words,) int32 scratch of this call alone,
// any contents. cluster: CTAs in the one cluster, 1..16. Needs 1 <= k <= 32;
// returns cudaErrorInvalidValue otherwise, else the launch's error.
extern "C" int viorb_bow_descend(const void* desc, const void* valid, int n, const void* centers,
                                 const void* children, const void* is_leaf, const void* word_id,
                                 int n_nodes, int k, const void* idf, int n_words, void* words,
                                 void* weights, void* global_hist, int cluster, void* stream) {
  if (k < 1 || k > kMaxChildren || n < 0 || n_nodes < 1 || n_words < 1 || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<const uint8_t*>(desc);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* c = static_cast<const uint4*>(centers);
  auto* ch = static_cast<const int*>(children);
  auto* leaf = static_cast<const uint8_t*>(is_leaf);
  auto* wid = static_cast<const int*>(word_id);
  auto* w_idf = static_cast<const float*>(idf);
  auto* out_words = static_cast<int*>(words);
  auto* out_weights = static_cast<float*>(weights);
  const size_t smem = static_cast<size_t>(n_words) * sizeof(int);
  auto* gh = static_cast<int*>(global_hist);
  cudaError_t e;
  if (gh == nullptr) {
    e = k <= 16 ? launch<true, 16>(cluster, smem, s, d, v, n, c, ch, leaf, wid, k, w_idf, n_words, out_words,
                                   out_weights, nullptr)
                : launch<true, 32>(cluster, smem, s, d, v, n, c, ch, leaf, wid, k, w_idf, n_words, out_words,
                                   out_weights, nullptr);
  } else {
    e = k <= 16 ? launch<false, 16>(cluster, 0, s, d, v, n, c, ch, leaf, wid, k, w_idf, n_words, out_words,
                                    out_weights, gh)
                : launch<false, 32>(cluster, 0, s, d, v, n, c, ch, leaf, wid, k, w_idf, n_words, out_words,
                                    out_weights, gh);
  }
  return static_cast<int>(e);
}

// The shared path's histogram limit in words on the current device: the
// largest dynamic shared memory a block may opt in to, less this kernel's
// static shared memory.
extern "C" int viorb_bow_shared_hist_max_words() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, descend_kernel<true, 16>) != cudaSuccess) return -1;
  return static_cast<int>((static_cast<size_t>(optin) - attr.sharedSizeBytes) / sizeof(int));
}
