// The port's copy of mitsuba3_tpu/native/bvh.cpp, unchanged below this
// note. mitsuba3_tpu_torch/ops/native.py builds it with g++ and the JAX
// package's flags (-O3 -march=native -shared -fPIC -std=c++17), so its
// leaves are bit-equal to the JAX package's; mitsuba3_tpu_torch/native
// binds it with ctypes.
//
// Binned-SAH BVH builder — the native-code counterpart of the reference's
// kd-tree builder (include/mitsuba/render/kdtree.h: SAH cost model +
// min-max binning, kdtree.h:801). Builds a binary BVH whose leaves are
// *clusters* of up to `leaf_size` triangles, which is the layout the TPU
// Pallas traversal kernel consumes (cluster-major triangle order, fixed
// leaf capacity).
//
// Exported C ABI (ctypes):
//   int mi_build_bvh(const float* bbmin, const float* bbmax, int n,
//                    int leaf_size,
//                    int*   prim_order,   // [n] permutation (out)
//                    float* node_bounds,  // [2n, 6] (out)
//                    int*   node_meta,    // [2n, 2] (out)
//                    int*   leaf_first,   // [n_leaves] first prim slot
//                    int*   leaf_count)   // returns node count, <0 on error
//
// node_meta[i] = (left_child, right_child) for inner nodes, or
//                (~leaf_index, count) for leaves.
// prim_order is the DFS-leaf-order permutation of [0, n); leaf L owns
// prim_order[leaf_first[L] : leaf_first[L] + leaf_count[L]]. Cluster
// padding to a fixed capacity happens on the Python side.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
    float mn[3], mx[3];
    void reset() {
        for (int k = 0; k < 3; ++k) { mn[k] = 1e30f; mx[k] = -1e30f; }
    }
    void grow(const Box &b) {
        for (int k = 0; k < 3; ++k) {
            mn[k] = std::min(mn[k], b.mn[k]);
            mx[k] = std::max(mx[k], b.mx[k]);
        }
    }
    void grow_pt(const float *p) {
        for (int k = 0; k < 3; ++k) {
            mn[k] = std::min(mn[k], p[k]);
            mx[k] = std::max(mx[k], p[k]);
        }
    }
    float area() const {
        float dx = std::max(0.f, mx[0] - mn[0]);
        float dy = std::max(0.f, mx[1] - mn[1]);
        float dz = std::max(0.f, mx[2] - mn[2]);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Builder {
    const float *bbmin, *bbmax;
    int leaf_size;
    std::vector<int> prims;          // permuted primitive ids
    std::vector<float> centroid;     // [n, 3]
    std::vector<Box> node_bounds;
    std::vector<int> node_left, node_right;  // meta
    std::vector<int> leaf_first_v, leaf_count_v;

    Box prim_box(int p) const {
        Box b;
        for (int k = 0; k < 3; ++k) {
            b.mn[k] = bbmin[3 * p + k];
            b.mx[k] = bbmax[3 * p + k];
        }
        return b;
    }

    // Binned SAH split (16 bins), midpoint fallback. Returns node index.
    int build(int begin, int end) {
        Box bounds; bounds.reset();
        Box cbounds; cbounds.reset();
        for (int i = begin; i < end; ++i) {
            bounds.grow(prim_box(prims[i]));
            cbounds.grow_pt(&centroid[3 * prims[i]]);
        }
        int node = (int)node_bounds.size();
        node_bounds.push_back(bounds);
        node_left.push_back(0);
        node_right.push_back(0);

        int count = end - begin;
        if (count <= leaf_size) {
            int leaf = (int)leaf_first_v.size();
            leaf_first_v.push_back(begin);
            leaf_count_v.push_back(count);
            node_left[node] = ~leaf;
            node_right[node] = count;
            return node;
        }

        // choose axis = widest centroid extent
        int axis = 0;
        float ext[3];
        for (int k = 0; k < 3; ++k) ext[k] = cbounds.mx[k] - cbounds.mn[k];
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] < 1e-12f) {
            mid = begin + count / 2;  // degenerate: split evenly
        } else {
            constexpr int NB = 16;
            Box bin_box[NB];
            int bin_cnt[NB] = {0};
            for (auto &b : bin_box) b.reset();
            float inv = NB / ext[axis];
            auto bin_of = [&](int p) {
                int b = (int)((centroid[3 * p + axis] - cbounds.mn[axis]) * inv);
                return std::min(std::max(b, 0), NB - 1);
            };
            for (int i = begin; i < end; ++i) {
                int b = bin_of(prims[i]);
                bin_cnt[b]++;
                bin_box[b].grow(prim_box(prims[i]));
            }
            // sweep for best SAH split
            float right_area[NB];
            Box acc; acc.reset();
            int right_cnt[NB];
            int rc = 0;
            for (int b = NB - 1; b >= 1; --b) {
                acc.grow(bin_box[b]);
                rc += bin_cnt[b];
                right_area[b] = acc.area();
                right_cnt[b] = rc;
            }
            acc.reset();
            int lc = 0;
            float best_cost = 1e30f;
            int best_bin = -1;
            for (int b = 0; b < NB - 1; ++b) {
                acc.grow(bin_box[b]);
                lc += bin_cnt[b];
                if (lc == 0 || right_cnt[b + 1] == 0) continue;
                float cost = acc.area() * lc + right_area[b + 1] * right_cnt[b + 1];
                if (cost < best_cost) { best_cost = cost; best_bin = b; }
            }
            if (best_bin < 0) {
                mid = begin + count / 2;
                std::nth_element(prims.begin() + begin, prims.begin() + mid,
                                 prims.begin() + end, [&](int a, int b) {
                    return centroid[3 * a + axis] < centroid[3 * b + axis];
                });
            } else {
                auto it = std::partition(prims.begin() + begin,
                                         prims.begin() + end, [&](int p) {
                    return bin_of(p) <= best_bin;
                });
                mid = (int)(it - prims.begin());
                if (mid == begin || mid == end) mid = begin + count / 2;
            }
        }

        int l = build(begin, mid);
        int r = build(mid, end);
        node_left[node] = l;
        node_right[node] = r;
        return node;
    }
};

}  // namespace

extern "C" int mi_build_bvh(const float *bbmin, const float *bbmax, int n,
                            int leaf_size, int *prim_order,
                            float *node_bounds, int *node_meta,
                            int *leaf_first, int *leaf_count,
                            int *n_leaves_out) {
    if (n <= 0 || leaf_size <= 0) return -1;
    Builder b;
    b.bbmin = bbmin;
    b.bbmax = bbmax;
    b.leaf_size = leaf_size;
    b.prims.resize(n);
    b.centroid.resize(3 * n);
    for (int i = 0; i < n; ++i) {
        b.prims[i] = i;
        for (int k = 0; k < 3; ++k)
            b.centroid[3 * i + k] = 0.5f * (bbmin[3 * i + k] + bbmax[3 * i + k]);
    }
    b.build(0, n);
    int nn = (int)b.node_bounds.size();
    for (int i = 0; i < nn; ++i) {
        std::memcpy(node_bounds + 6 * i, b.node_bounds[i].mn, 12);
        std::memcpy(node_bounds + 6 * i + 3, b.node_bounds[i].mx, 12);
        node_meta[2 * i] = b.node_left[i];
        node_meta[2 * i + 1] = b.node_right[i];
    }
    int nl = (int)b.leaf_first_v.size();
    for (int i = 0; i < nl; ++i) {
        leaf_first[i] = b.leaf_first_v[i];
        leaf_count[i] = b.leaf_count_v[i];
    }
    std::memcpy(prim_order, b.prims.data(), sizeof(int) * (size_t)n);
    *n_leaves_out = nl;
    return nn;
}
