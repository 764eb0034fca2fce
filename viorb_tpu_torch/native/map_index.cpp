// Native map-index kernels: the host-side graph bookkeeping hot paths.
//
// The reference does all of this in C++ inside KeyFrame/MapPoint
// (reference: KeyFrame::UpdateConnections covisibility counting,
// Optimizer.cc graph assembly loops). Here the map lives in
// struct-of-arrays numpy buffers; these kernels run the per-keyframe
// Python-loop-free passes over them. The port's own copy of
// viorb_tpu/native/map_index.cpp: built with g++ at first use by
// viorb_tpu_torch/native/__init__.py and called through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Count co-observations: for each point in pt_ids, walk its observation
// slots and accumulate counts per observing keyframe (excluding one kf).
// obs_kf: (max_points, slots) int32, -1 = empty.
void covis_count(const int64_t* pt_ids, int64_t n_pts,
                 const int32_t* obs_kf, int64_t slots,
                 int32_t exclude_kf, int32_t* out_counts,
                 int64_t max_kf) {
    for (int64_t i = 0; i < n_pts; ++i) {
        const int32_t* row = obs_kf + pt_ids[i] * slots;
        for (int64_t s = 0; s < slots; ++s) {
            int32_t k = row[s];
            if (k >= 0 && k != exclude_kf && k < max_kf) {
                out_counts[k] += 1;
            }
        }
    }
}

// Mark points observed by any of the given keyframes.
// point_idx: concatenated per-kf feature->point arrays (n_kfs * n_feat).
void union_points(const int32_t* point_idx, int64_t n_entries,
                  const uint8_t* active, int64_t max_points,
                  uint8_t* out_mask) {
    for (int64_t i = 0; i < n_entries; ++i) {
        int32_t p = point_idx[i];
        if (p >= 0 && p < max_points && active[p]) {
            out_mask[p] = 1;
        }
    }
}

// Assemble the landmark-major BA observation grid.
// For each selected point row, scan its observation slots; if the
// observing keyframe is in the window (slot_of_kf[kf] >= 0), emit
// kf-slot, uv (gathered from per-kf keypoint arrays), inv_sigma2
// (from per-kf levels) and validity.
//  pt_ids: (m,) selected point ids
//  obs_kf/obs_feat: (max_points, slots)
//  slot_of_kf: (max_kf,) int32, -1 if not in window
//  kf_xy: (n_kfs_total_padded) flattened as kf_rows x n_feat x 2 where
//         kf_rows indexes by slot_of_kf value? -> we pass per-kf arrays
//         via a flat buffer: xy_all (n_window_kfs, n_feat, 2) and
//         level_all (n_window_kfs, n_feat), indexed by slot.
void build_ba_grid(const int64_t* pt_ids, int64_t m,
                   const int32_t* obs_kf, const int32_t* obs_feat,
                   int64_t slots,
                   const int32_t* slot_of_kf, int64_t max_kf,
                   const float* xy_all, const int32_t* level_all,
                   int64_t n_feat,
                   const float* inv_sigma2_of_level,
                   int32_t* out_kf_idx, float* out_uv,
                   float* out_inv_sigma2, uint8_t* out_valid) {
    for (int64_t row = 0; row < m; ++row) {
        const int32_t* okf = obs_kf + pt_ids[row] * slots;
        const int32_t* oft = obs_feat + pt_ids[row] * slots;
        for (int64_t s = 0; s < slots; ++s) {
            int64_t o = row * slots + s;
            int32_t k = okf[s];
            if (k < 0 || k >= max_kf) continue;
            int32_t slot = slot_of_kf[k];
            if (slot < 0) continue;
            int32_t f = oft[s];
            out_kf_idx[o] = slot;
            out_uv[o * 2 + 0] = xy_all[(slot * n_feat + f) * 2 + 0];
            out_uv[o * 2 + 1] = xy_all[(slot * n_feat + f) * 2 + 1];
            out_inv_sigma2[o] = inv_sigma2_of_level[level_all[slot * n_feat + f]];
            out_valid[o] = 1;
        }
    }
}

// Recompute per-point distinctive descriptor (min median Hamming over the
// point's observations, reference MapPoint::ComputeDistinctiveDescriptors),
// mean viewing normal, and scale-invariance distance range
// (UpdateNormalAndDepth). The per-keyframe descriptor/level payloads are
// passed as POINTER TABLES indexed by keyframe id (each keyframe owns its
// own numpy arrays; descriptors are packed to 4x uint64 per feature so the
// pairwise distances are XOR+popcount).
//  pt_ids: (n,) point rows to refresh
//  obs_kf/obs_feat: (max_points, slots) int32
//  desc_ptrs: (max_kf,) uint64 addresses of (n_feat_k, 4) uint64 packed bits
//  level_ptrs: (max_kf,) uint64 addresses of (n_feat_k,) int32 levels
//  centers: (max_kf, 3) float camera centers (0 for dead slots)
//  kf_alive: (max_kf,) uint8
//  outputs: pt_desc01 (max_points,256) u8 {0,1}, pt_normal (max_points,3),
//           pt_min_dist/pt_max_dist (max_points,)
void update_point_stats(const int64_t* pt_ids, int64_t n,
                        const int32_t* obs_kf, const int32_t* obs_feat,
                        int64_t slots,
                        const uint64_t* desc_ptrs, const uint64_t* level_ptrs,
                        const float* centers, const uint8_t* kf_alive,
                        int64_t max_kf,
                        const float* pt_xyz,
                        uint8_t* pt_desc01, float* pt_normal,
                        float* pt_min_dist, float* pt_max_dist) {
    const float inv_scale7 = 1.0f / std::pow(1.2f, 7.0f);
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = pt_ids[i];
        const int32_t* okf = obs_kf + p * slots;
        const int32_t* oft = obs_feat + p * slots;
        int cnt = 0;
        int32_t ks[64], fs[64];
        for (int64_t s = 0; s < slots && cnt < 64; ++s) {
            int32_t k = okf[s];
            if (k >= 0 && k < max_kf && kf_alive[k]) {
                ks[cnt] = k;
                fs[cnt] = oft[s];
                ++cnt;
            }
        }
        if (cnt == 0) continue;
        uint64_t D[64][4];
        for (int a = 0; a < cnt; ++a) {
            const uint64_t* d =
                reinterpret_cast<const uint64_t*>(desc_ptrs[ks[a]]) +
                static_cast<int64_t>(fs[a]) * 4;
            std::memcpy(D[a], d, 32);
        }
        int best = 0;
        if (cnt > 1) {
            float best_med = 1e30f;
            int dists[64];
            for (int a = 0; a < cnt; ++a) {
                for (int b = 0; b < cnt; ++b) {
                    int h = 0;
                    for (int w = 0; w < 4; ++w)
                        h += __builtin_popcountll(D[a][w] ^ D[b][w]);
                    dists[b] = h;
                }
                std::sort(dists, dists + cnt);
                float med = (cnt & 1)
                                ? static_cast<float>(dists[cnt / 2])
                                : 0.5f * (dists[cnt / 2 - 1] + dists[cnt / 2]);
                if (med < best_med) {
                    best_med = med;
                    best = a;
                }
            }
        }
        uint8_t* out = pt_desc01 + p * 256;
        for (int w = 0; w < 4; ++w) {
            uint64_t v = D[best][w];
            for (int b = 0; b < 64; ++b) out[w * 64 + b] = (v >> b) & 1u;
        }
        const float* X = pt_xyz + p * 3;
        float nx = 0, ny = 0, nz = 0;
        bool any = false;
        for (int a = 0; a < cnt; ++a) {
            const float* c = centers + static_cast<int64_t>(ks[a]) * 3;
            float dx = X[0] - c[0], dy = X[1] - c[1], dz = X[2] - c[2];
            float nrm = std::sqrt(dx * dx + dy * dy + dz * dz);
            if (nrm > 1e-9f) {
                nx += dx / nrm;
                ny += dy / nrm;
                nz += dz / nrm;
                any = true;
            }
        }
        if (any) {
            float nn = std::sqrt(nx * nx + ny * ny + nz * nz);
            if (nn > 1e-9f) {
                pt_normal[p * 3 + 0] = nx / nn;
                pt_normal[p * 3 + 1] = ny / nn;
                pt_normal[p * 3 + 2] = nz / nn;
            }
        }
        int32_t rk = ks[cnt - 1], rf = fs[cnt - 1];
        const float* c = centers + static_cast<int64_t>(rk) * 3;
        float dx = X[0] - c[0], dy = X[1] - c[1], dz = X[2] - c[2];
        float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
        int32_t level =
            reinterpret_cast<const int32_t*>(level_ptrs[rk])[rf];
        float mx = dist * std::pow(1.2f, static_cast<float>(level));
        pt_max_dist[p] = mx;
        pt_min_dist[p] = mx * inv_scale7;
    }
}

}  // extern "C"
