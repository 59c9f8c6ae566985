// terra_native: host-side native kernels for terra_tpu.
//
// Native replacement for the scene-build hot paths, mirroring how the
// reference keeps its whole builder in C (its src/TerraBVH.c):
//   * terra_lbvh_build — Morton-ordered cluster LBVH with preorder
//     threading (dfs_next / dfs_skip ropes) and bottom-up AABBs. Output
//     layout matches terra_tpu.accel.lbvh.LBVH exactly; ~50x faster than
//     the NumPy fallback on 250k-triangle scenes.
//   * terra_obj_parse_faces — numeric heavy lifting of OBJ parsing
//     (v/vn/vt/f records); directives stay in Python.
//
// Build: g++ -O3 -shared -fPIC -o _terra_native.so terra_native.cpp
// (no external dependencies; loaded via ctypes).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- LBVH

static inline uint64_t expand_bits10(uint64_t v) {
    v = (v | (v << 16)) & 0x030000FFull;
    v = (v | (v << 8)) & 0x0300F00Full;
    v = (v | (v << 4)) & 0x030C30C3ull;
    v = (v | (v << 2)) & 0x09249249ull;
    return v;
}

static inline uint64_t morton3(float x, float y, float z) {
    // x, y, z in [0, 1]
    uint64_t qx = (uint64_t)std::min(std::max(x * 1024.0f, 0.0f), 1023.0f);
    uint64_t qy = (uint64_t)std::min(std::max(y * 1024.0f, 0.0f), 1023.0f);
    uint64_t qz = (uint64_t)std::min(std::max(z * 1024.0f, 0.0f), 1023.0f);
    return (expand_bits10(qx) << 2) | (expand_bits10(qy) << 1) | expand_bits10(qz);
}

namespace {

struct BuildCtx {
    const float* pos;        // (V, 3)
    const int32_t* vidx;     // (T, 3)
    int64_t num_tris;
    int leaf_size;
    int64_t num_leaves;      // C
    int64_t ni;              // C - 1
    std::vector<uint64_t> leaf_code;
    // outputs
    int32_t* leaf_tri;
    int32_t* left;
    int32_t* right;
    float* box_min;          // (ni + C, 3)
    float* box_max;
    int32_t* dfs_next;
    int32_t* dfs_skip;
    int32_t next_internal = 0;
};

// returns unified node id; fills boxes bottom-up; threads preorder links.
// cont = node following this subtree in preorder (-1 at the end).
static int32_t build_range(BuildCtx& B, int64_t lo, int64_t hi, int32_t cont, int bit) {
    if (hi - lo == 1) {
        int32_t id = (int32_t)(B.ni + lo);
        B.dfs_next[id] = cont;
        B.dfs_skip[id] = cont;
        return id;
    }
    // split: highest bit where codes differ (morton-prefix split); fall
    // back to the median when the range shares all inspected bits.
    int64_t mid = -1;
    while (bit >= 0) {
        uint64_t mask = 1ull << bit;
        if ((B.leaf_code[lo] & mask) != (B.leaf_code[hi - 1] & mask)) {
            // binary search first index with the bit set
            int64_t a = lo, b = hi - 1;
            while (a < b) {
                int64_t m = (a + b) / 2;
                if (B.leaf_code[m] & mask) b = m; else a = m + 1;
            }
            mid = a;
            break;
        }
        --bit;
    }
    if (mid < 0) mid = (lo + hi) / 2;

    int32_t id = B.next_internal++;
    int32_t r = build_range(B, mid, hi, cont, bit - 1);
    int32_t l = build_range(B, lo, mid, r, bit - 1);
    B.left[id] = l;
    B.right[id] = r;
    B.dfs_next[id] = l;
    B.dfs_skip[id] = cont;
    for (int k = 0; k < 3; ++k) {
        B.box_min[id * 3 + k] = std::min(B.box_min[l * 3 + k], B.box_min[r * 3 + k]);
        B.box_max[id * 3 + k] = std::max(B.box_max[l * 3 + k], B.box_max[r * 3 + k]);
    }
    return id;
}

}  // namespace

// Builds the cluster LBVH. Caller allocates all outputs:
//   leaf_tri (C*L), left/right (ni), box_min/box_max ((ni+C)*3),
//   dfs_next/dfs_skip (ni+C), tri_order (T)
// with C = ceil(T / leaf_size), ni = C - 1. Returns 0 on success.
int terra_lbvh_build(
    const float* positions, int64_t num_vertices,
    const int32_t* tri_vidx, int64_t num_tris,
    int leaf_size,
    int32_t* leaf_tri,
    int32_t* left, int32_t* right,
    float* box_min, float* box_max,
    int32_t* dfs_next, int32_t* dfs_skip,
    int32_t* tri_order) {
    (void)num_vertices;
    if (num_tris <= 0 || leaf_size <= 0) return 1;
    const int64_t T = num_tris;
    const int64_t C = (T + leaf_size - 1) / leaf_size;
    const int64_t ni = C - 1;

    // centroids + scene bounds
    std::vector<float> cx(T), cy(T), cz(T);
    float lo[3] = {1e38f, 1e38f, 1e38f}, hi[3] = {-1e38f, -1e38f, -1e38f};
    for (int64_t t = 0; t < T; ++t) {
        float c[3] = {0, 0, 0};
        for (int k = 0; k < 3; ++k) {
            const float* p = positions + (int64_t)tri_vidx[t * 3 + k] * 3;
            c[0] += p[0]; c[1] += p[1]; c[2] += p[2];
        }
        cx[t] = c[0] / 3.0f; cy[t] = c[1] / 3.0f; cz[t] = c[2] / 3.0f;
        lo[0] = std::min(lo[0], cx[t]); hi[0] = std::max(hi[0], cx[t]);
        lo[1] = std::min(lo[1], cy[t]); hi[1] = std::max(hi[1], cy[t]);
        lo[2] = std::min(lo[2], cz[t]); hi[2] = std::max(hi[2], cz[t]);
    }
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12f);

    // morton order
    std::vector<std::pair<uint64_t, int32_t>> keyed(T);
    for (int64_t t = 0; t < T; ++t) {
        keyed[t] = {morton3((cx[t] - lo[0]) / ext[0], (cy[t] - lo[1]) / ext[1],
                            (cz[t] - lo[2]) / ext[2]),
                    (int32_t)t};
    }
    std::stable_sort(keyed.begin(), keyed.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (int64_t t = 0; t < T; ++t) tri_order[t] = keyed[t].second;

    // leaf table (pad with the last valid triangle) + leaf codes + leaf boxes
    BuildCtx B;
    B.pos = positions; B.vidx = tri_vidx; B.num_tris = T;
    B.leaf_size = leaf_size; B.num_leaves = C; B.ni = ni;
    B.leaf_tri = leaf_tri; B.left = left; B.right = right;
    B.box_min = box_min; B.box_max = box_max;
    B.dfs_next = dfs_next; B.dfs_skip = dfs_skip;
    B.leaf_code.resize(C);
    for (int64_t c = 0; c < C; ++c) {
        float bmin[3] = {1e38f, 1e38f, 1e38f}, bmax[3] = {-1e38f, -1e38f, -1e38f};
        for (int s = 0; s < leaf_size; ++s) {
            int64_t src = std::min(c * leaf_size + s, T - 1);
            int32_t tri = keyed[src].second;
            leaf_tri[c * leaf_size + s] = tri;
            for (int k = 0; k < 3; ++k) {
                const float* p = positions + (int64_t)tri_vidx[tri * 3 + k] * 3;
                for (int a = 0; a < 3; ++a) {
                    bmin[a] = std::min(bmin[a], p[a]);
                    bmax[a] = std::max(bmax[a], p[a]);
                }
            }
        }
        for (int a = 0; a < 3; ++a) {
            box_min[(ni + c) * 3 + a] = bmin[a];
            box_max[(ni + c) * 3 + a] = bmax[a];
        }
        B.leaf_code[c] = (keyed[std::min(c * leaf_size, T - 1)].first << 32) | (uint64_t)c;
    }

    if (C == 1) {
        dfs_next[0] = -1;
        dfs_skip[0] = -1;
        return 0;
    }
    build_range(B, 0, C, -1, 61);  // codes occupy bits [32, 62)
    return 0;
}

// ----------------------------------------------------------- binned SAH

namespace {

struct SahCtx {
    const float* pos;
    const int32_t* vidx;
    int64_t T;
    int leaf_size;
    int64_t min_side;        // balance floor: both split sides >= this
    // per-triangle precomputed AABBs + centroids (in tri-id order)
    std::vector<float> tmin, tmax, cen;  // (T,3) each
    std::vector<int32_t> order;          // permutation being partitioned
    // outputs (worst-case allocated by caller)
    int32_t* leaf_tri;
    int32_t* left;
    int32_t* right;
    float* box_min;          // (ni_max + C_max, 3) — unified ids use actual ni
    float* box_max;
    int32_t* dfs_next;
    int32_t* dfs_skip;
    int64_t ni;              // actual internal count (= num_leaves - 1)
    int32_t next_internal = 0;
    int32_t next_leaf = 0;
};

struct Box {
    float lo[3] = {1e38f, 1e38f, 1e38f};
    float hi[3] = {-1e38f, -1e38f, -1e38f};
    void grow(const float* a, const float* b) {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], a[k]);
            hi[k] = std::max(hi[k], b[k]);
        }
    }
    void grow(const Box& o) { grow(o.lo, o.hi); }
    float area() const {
        float dx = std::max(hi[0] - lo[0], 0.0f);
        float dy = std::max(hi[1] - lo[1], 0.0f);
        float dz = std::max(hi[2] - lo[2], 0.0f);
        return dx * dy + dy * dz + dz * dx;
    }
};

constexpr int SAH_BINS = 16;

// Returns unified node id (internal < ni, leaf >= ni), threading preorder
// links and filling boxes bottom-up. cont = preorder successor of the
// whole subtree (-1 at the end).
static int32_t sah_range(SahCtx& B, int64_t lo, int64_t hi, int32_t cont,
                         Box* out_box) {
    const int64_t n = hi - lo;
    // centroid bounds + range box
    Box cb, rb;
    for (int64_t i = lo; i < hi; ++i) {
        int32_t t = B.order[i];
        rb.grow(&B.tmin[t * 3], &B.tmax[t * 3]);
        cb.grow(&B.cen[t * 3], &B.cen[t * 3]);
    }
    bool make_leaf = n <= B.leaf_size;
    int best_axis = -1, best_bin = -1;
    float best_cost = 1e38f;
    float cb_ext[3], cb_inv[3];
    // balance floor: keeps leaves >= leaf_size/2 full AND bounds the
    // recursion depth (both sides >= n/16 => depth = O(log n))
    const int64_t min_side = std::max(B.min_side, n / 16);
    int64_t forced_mid = -1;
    const int64_t L = B.leaf_size;
    // Window measured optimal at 4L: extending the forced splits to 8L
    // lifted mean fill 0.85 -> 0.92 but box quality paid for it (242k
    // primary 28.26 -> 27.51 Mrays/s, mega flat) — r5 A/B.
    if (!make_leaf && n <= 4 * L) {
        // Chunk-packing splits (round 5): the Pallas dense leaf test runs
        // in 8-triangle chunks, and padded slots repeat triangles — pure
        // wasted VPU work (measured 23.6% of all chunks at 1M tris with
        // SAH's balanced [L/2, L] leaves). Small ranges split at forced
        // points that minimize the LEAF COUNT (each visit costs a full
        // ceil(L/8) chunks regardless of fill) while keeping spatial
        // locality via a widest-axis nth_element:
        //   (L, 2L] : 8-aligned near-half point, exactly 2 leaves
        //   (2L,3L] : one FULL leaf + a packed (L, 2L] pair -> 3 leaves
        //   (3L,4L] : 8-aligned near-half -> two (L, 2L] sides -> 4
        // (sah_count mirrors these leaf counts exactly.)
        for (int k = 0; k < 3; ++k) cb_ext[k] = cb.hi[k] - cb.lo[k];
        int axis = 0;
        for (int k = 1; k < 3; ++k)
            if (cb_ext[k] > cb_ext[axis]) axis = k;
        int64_t na;
        if (n <= 2 * L) {
            na = std::min<int64_t>(L, 8 * ((n + 15) / 16));
            if (na < n - L) na = n - L;
        } else if (n <= 3 * L) {
            na = L;
        } else {
            na = 8 * ((n + 15) / 16);
            na = std::min(na, 2 * L);
            if (na < n - 2 * L) na = n - 2 * L;
        }
        if (na <= 0 || na >= n) na = n / 2;
        std::nth_element(
            B.order.begin() + lo, B.order.begin() + lo + na,
            B.order.begin() + hi,
            [&](int32_t a, int32_t b) {
                return B.cen[a * 3 + axis] < B.cen[b * 3 + axis];
            });
        best_axis = -2;
        forced_mid = lo + na;
    } else if (!make_leaf) {
        for (int k = 0; k < 3; ++k) {
            cb_ext[k] = cb.hi[k] - cb.lo[k];
            cb_inv[k] = cb_ext[k] > 1e-12f ? SAH_BINS / cb_ext[k] : 0.0f;
        }
        // binned SAH over all 3 axes (the reference sweeps x only,
        // TerraBVH.c:79-126; full-axis binning builds strictly better trees)
        for (int axis = 0; axis < 3; ++axis) {
            if (cb_inv[axis] == 0.0f) continue;
            int cnt[SAH_BINS] = {0};
            Box bins[SAH_BINS];
            for (int64_t i = lo; i < hi; ++i) {
                int32_t t = B.order[i];
                int b = (int)((B.cen[t * 3 + axis] - cb.lo[axis]) * cb_inv[axis]);
                b = std::min(std::max(b, 0), SAH_BINS - 1);
                ++cnt[b];
                bins[b].grow(&B.tmin[t * 3], &B.tmax[t * 3]);
            }
            // suffix areas/counts
            float rarea[SAH_BINS];
            int64_t rcnt[SAH_BINS];
            Box acc;
            int64_t c = 0;
            for (int b = SAH_BINS - 1; b > 0; --b) {
                acc.grow(bins[b]);
                c += cnt[b];
                rarea[b] = acc.area();
                rcnt[b] = c;
            }
            // prefix sweep
            Box lacc;
            int64_t lcnt = 0;
            for (int b = 0; b < SAH_BINS - 1; ++b) {
                lacc.grow(bins[b]);
                lcnt += cnt[b];
                int64_t rc = rcnt[b + 1];
                if (lcnt < min_side || rc < min_side) continue;
                float cost = lacc.area() * lcnt + rarea[b + 1] * rc;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                }
            }
        }
        if (best_axis < 0) {
            // no balanced SAH split available: median split on widest axis
            int axis = 0;
            for (int k = 1; k < 3; ++k)
                if (cb_ext[k] > cb_ext[axis]) axis = k;
            std::nth_element(
                B.order.begin() + lo, B.order.begin() + lo + n / 2,
                B.order.begin() + hi,
                [&](int32_t a, int32_t b) {
                    return B.cen[a * 3 + axis] < B.cen[b * 3 + axis];
                });
            best_axis = -2;  // marker: already partitioned at lo + n/2
        }
    }

    if (make_leaf) {
        int32_t leaf = B.next_leaf++;
        int32_t id = (int32_t)(B.ni + leaf);
        for (int s = 0; s < B.leaf_size; ++s) {
            int64_t src = lo + std::min<int64_t>(s, n - 1);  // pad w/ last tri
            B.leaf_tri[(int64_t)leaf * B.leaf_size + s] = B.order[src];
        }
        for (int k = 0; k < 3; ++k) {
            B.box_min[id * 3 + k] = rb.lo[k];
            B.box_max[id * 3 + k] = rb.hi[k];
        }
        B.dfs_next[id] = cont;
        B.dfs_skip[id] = cont;
        *out_box = rb;
        return id;
    }

    int64_t mid;
    if (best_axis == -2) {
        mid = forced_mid >= 0 ? forced_mid : lo + n / 2;
    } else {
        auto it = std::partition(
            B.order.begin() + lo, B.order.begin() + hi,
            [&](int32_t t) {
                int b = (int)((B.cen[t * 3 + best_axis] - cb.lo[best_axis]) *
                              cb_inv[best_axis]);
                b = std::min(std::max(b, 0), SAH_BINS - 1);
                return b <= best_bin;
            });
        mid = it - B.order.begin();
        if (mid <= lo || mid >= hi) mid = lo + n / 2;  // numeric edge guard
    }

    int32_t id = B.next_internal++;
    Box rbox, lbox;
    int32_t r = sah_range(B, mid, hi, cont, &rbox);
    int32_t l = sah_range(B, lo, mid, r, &lbox);
    B.left[id] = l;
    B.right[id] = r;
    B.dfs_next[id] = l;
    B.dfs_skip[id] = cont;
    for (int k = 0; k < 3; ++k) {
        B.box_min[id * 3 + k] = std::min(lbox.lo[k], rbox.lo[k]);
        B.box_max[id * 3 + k] = std::max(lbox.hi[k], rbox.hi[k]);
    }
    *out_box = lbox;
    out_box->grow(rbox);
    return id;
}

// Count leaves of the SAH recursion WITHOUT building (to size the unified
// id space before emitting node ids). Mirrors sah_range's split decisions
// exactly — both must stay in lockstep.
static int64_t sah_count(SahCtx& B, int64_t lo, int64_t hi);

}  // namespace

// Binned-SAH BVH with uniform padded leaves (the reference's builder is a
// sweep SAH on x only, TerraBVH.c:79-126; this is the standard 16-bin
// 3-axis version). Leaves hold [leaf_size/2, leaf_size] triangles (padded
// by repetition), so caller allocates for C_max = max(2*ceil(T/L), 1):
//   leaf_tri (C_max*L), left/right (C_max-1), box_min/max ((2*C_max-1)*3),
//   dfs_next/skip (2*C_max-1), tri_order (T).
// Writes the actual leaf count to *num_leaves_out. Returns 0 on success.
int terra_sah_build(
    const float* positions, int64_t num_vertices,
    const int32_t* tri_vidx, int64_t num_tris,
    int leaf_size,
    int32_t* leaf_tri,
    int32_t* left, int32_t* right,
    float* box_min, float* box_max,
    int32_t* dfs_next, int32_t* dfs_skip,
    int32_t* tri_order,
    int64_t* num_leaves_out) {
    (void)num_vertices;
    if (num_tris <= 0 || leaf_size <= 0) return 1;
    SahCtx B;
    B.pos = positions;
    B.vidx = tri_vidx;
    B.T = num_tris;
    B.leaf_size = leaf_size;
    B.min_side = std::max<int64_t>((leaf_size + 1) / 2, 1);
    B.leaf_tri = leaf_tri;
    B.left = left;
    B.right = right;
    B.box_min = box_min;
    B.box_max = box_max;
    B.dfs_next = dfs_next;
    B.dfs_skip = dfs_skip;

    B.tmin.resize(num_tris * 3);
    B.tmax.resize(num_tris * 3);
    B.cen.resize(num_tris * 3);
    B.order.resize(num_tris);
    for (int64_t t = 0; t < num_tris; ++t) {
        B.order[t] = (int32_t)t;
        float lo[3] = {1e38f, 1e38f, 1e38f}, hi[3] = {-1e38f, -1e38f, -1e38f};
        for (int k = 0; k < 3; ++k) {
            const float* p = positions + (int64_t)tri_vidx[t * 3 + k] * 3;
            for (int a = 0; a < 3; ++a) {
                lo[a] = std::min(lo[a], p[a]);
                hi[a] = std::max(hi[a], p[a]);
            }
        }
        for (int a = 0; a < 3; ++a) {
            B.tmin[t * 3 + a] = lo[a];
            B.tmax[t * 3 + a] = hi[a];
            B.cen[t * 3 + a] = 0.5f * (lo[a] + hi[a]);
        }
    }

    // Pass 1: count leaves (identical split logic) to fix the id split.
    std::vector<int32_t> saved_order = B.order;
    int64_t C = sah_count(B, 0, num_tris);
    B.order = saved_order;
    B.ni = C - 1;
    *num_leaves_out = C;

    if (C == 1) {
        Box rb;
        for (int64_t i = 0; i < num_tris; ++i)
            rb.grow(&B.tmin[i * 3], &B.tmax[i * 3]);
        for (int s = 0; s < leaf_size; ++s)
            leaf_tri[s] = B.order[std::min<int64_t>(s, num_tris - 1)];
        for (int k = 0; k < 3; ++k) {
            box_min[k] = rb.lo[k];
            box_max[k] = rb.hi[k];
        }
        dfs_next[0] = -1;
        dfs_skip[0] = -1;
        for (int64_t t = 0; t < num_tris; ++t) tri_order[t] = B.order[t];
        return 0;
    }

    Box root;
    sah_range(B, 0, num_tris, -1, &root);
    for (int64_t t = 0; t < num_tris; ++t) tri_order[t] = B.order[t];
    return (B.next_leaf == C && B.next_internal == (int32_t)B.ni) ? 0 : 2;
}

namespace {

static int64_t sah_count(SahCtx& B, int64_t lo, int64_t hi) {
    const int64_t n = hi - lo;
    const int64_t L = B.leaf_size;
    if (n <= L) return 1;
    // mirrors sah_range's chunk-packing splits exactly: the forced split
    // points give deterministic leaf counts and no deeper decision
    // depends on these ranges' partition order
    if (n <= 2 * L) return 2;
    if (n <= 3 * L) return 3;
    if (n <= 4 * L) return 4;
    const int64_t min_side = std::max(B.min_side, n / 16);
    Box cb;
    for (int64_t i = lo; i < hi; ++i)
        cb.grow(&B.cen[B.order[i] * 3], &B.cen[B.order[i] * 3]);
    float cb_ext[3], cb_inv[3];
    for (int k = 0; k < 3; ++k) {
        cb_ext[k] = cb.hi[k] - cb.lo[k];
        cb_inv[k] = cb_ext[k] > 1e-12f ? SAH_BINS / cb_ext[k] : 0.0f;
    }
    int best_axis = -1, best_bin = -1;
    float best_cost = 1e38f;
    for (int axis = 0; axis < 3; ++axis) {
        if (cb_inv[axis] == 0.0f) continue;
        int cnt[SAH_BINS] = {0};
        Box bins[SAH_BINS];
        for (int64_t i = lo; i < hi; ++i) {
            int32_t t = B.order[i];
            int b = (int)((B.cen[t * 3 + axis] - cb.lo[axis]) * cb_inv[axis]);
            b = std::min(std::max(b, 0), SAH_BINS - 1);
            ++cnt[b];
            bins[b].grow(&B.tmin[t * 3], &B.tmax[t * 3]);
        }
        float rarea[SAH_BINS];
        int64_t rcnt[SAH_BINS];
        Box acc;
        int64_t c = 0;
        for (int b = SAH_BINS - 1; b > 0; --b) {
            acc.grow(bins[b]);
            c += cnt[b];
            rarea[b] = acc.area();
            rcnt[b] = c;
        }
        Box lacc;
        int64_t lcnt = 0;
        for (int b = 0; b < SAH_BINS - 1; ++b) {
            lacc.grow(bins[b]);
            lcnt += cnt[b];
            int64_t rc = rcnt[b + 1];
            if (lcnt < min_side || rc < min_side) continue;
            float cost = lacc.area() * lcnt + rarea[b + 1] * rc;
            if (cost < best_cost) {
                best_cost = cost;
                best_axis = axis;
                best_bin = b;
            }
        }
    }
    int64_t mid;
    if (best_axis < 0) {
        int axis = 0;
        for (int k = 1; k < 3; ++k)
            if (cb_ext[k] > cb_ext[axis]) axis = k;
        std::nth_element(
            B.order.begin() + lo, B.order.begin() + lo + n / 2,
            B.order.begin() + hi,
            [&](int32_t a, int32_t b) {
                return B.cen[a * 3 + axis] < B.cen[b * 3 + axis];
            });
        mid = lo + n / 2;
    } else {
        auto it = std::partition(
            B.order.begin() + lo, B.order.begin() + hi,
            [&](int32_t t) {
                int b = (int)((B.cen[t * 3 + best_axis] - cb.lo[best_axis]) *
                              cb_inv[best_axis]);
                b = std::min(std::max(b, 0), SAH_BINS - 1);
                return b <= best_bin;
            });
        mid = it - B.order.begin();
        if (mid <= lo || mid >= hi) mid = lo + n / 2;
    }
    return sah_count(B, lo, mid) + sah_count(B, mid, hi);
}

}  // namespace

// ------------------------------------------------------------- OBJ parse

// Pass 1: count records. Returns 0 on success.
int terra_obj_count(const char* text, int64_t len,
                    int64_t* nv, int64_t* nn, int64_t* nt, int64_t* nfaces) {
    *nv = *nn = *nt = *nfaces = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        // start of line
        if (p[0] == 'v') {
            if (p + 1 < end && (p[1] == ' ' || p[1] == '\t')) ++*nv;
            else if (p + 2 < end && p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) ++*nn;
            else if (p + 2 < end && p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) ++*nt;
        } else if (p[0] == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            // count triangles in the (possibly polygonal) face: corners - 2
            int corners = 0;
            const char* q = p + 1;
            while (q < end && *q != '\n') {
                while (q < end && (*q == ' ' || *q == '\t')) ++q;
                if (q < end && *q != '\n' && *q != '\r' && *q != '#') {
                    ++corners;
                    while (q < end && *q != ' ' && *q != '\t' && *q != '\n') ++q;
                } else break;
            }
            if (corners >= 3) *nfaces += corners - 2;
        }
        while (p < end && *p != '\n') ++p;
        ++p;
    }
    return 0;
}

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    return p;
}

// Pass 2: fill arrays. face_idx: (nfaces, 3, 3) int32 (v, vt, vn per corner,
// -1 when absent); face_line: (nfaces,) int32 line numbers (for Python-side
// usemtl/object association). Returns 0 on success.
int terra_obj_parse(const char* text, int64_t len,
                    float* verts, float* norms, float* uvs,
                    int32_t* face_idx, int32_t* face_line) {
    const char* p = text;
    const char* end = text + len;
    int64_t iv = 0, in_ = 0, it = 0, fi = 0;
    int32_t line = 0;
    while (p < end) {
        const char* q = p;
        if (q[0] == 'v' && q + 1 < end && (q[1] == ' ' || q[1] == '\t')) {
            char* e;
            q += 1;
            for (int k = 0; k < 3; ++k) { verts[iv * 3 + k] = strtof(q, &e); q = e; }
            ++iv;
        } else if (q[0] == 'v' && q + 2 < end && q[1] == 'n' && (q[2] == ' ' || q[2] == '\t')) {
            char* e;
            q += 2;
            for (int k = 0; k < 3; ++k) { norms[in_ * 3 + k] = strtof(q, &e); q = e; }
            ++in_;
        } else if (q[0] == 'v' && q + 2 < end && q[1] == 't' && (q[2] == ' ' || q[2] == '\t')) {
            char* e;
            q += 2;
            for (int k = 0; k < 2; ++k) { uvs[it * 2 + k] = strtof(q, &e); q = e; }
            ++it;
        } else if (q[0] == 'f' && q + 1 < end && (q[1] == ' ' || q[1] == '\t')) {
            int32_t corner[64][3];
            int n_corners = 0;
            q += 1;
            while (q < end && *q != '\n' && n_corners < 64) {
                q = skip_ws(q, end);
                if (q >= end || *q == '\n' || *q == '\r' || *q == '#') break;
                // parse i[/j][/k] with negative-index support resolved later
                long v = strtol(q, (char**)&q, 10);
                long vt = 0, vn = 0;
                bool has_vt = false, has_vn = false;
                if (q < end && *q == '/') {
                    ++q;
                    if (q < end && *q != '/') { vt = strtol(q, (char**)&q, 10); has_vt = true; }
                    if (q < end && *q == '/') { ++q; vn = strtol(q, (char**)&q, 10); has_vn = true; }
                }
                corner[n_corners][0] = (int32_t)(v > 0 ? v - 1 : (v < 0 ? iv + v : -1));
                corner[n_corners][1] = has_vt ? (int32_t)(vt > 0 ? vt - 1 : (vt < 0 ? it + vt : -1)) : -1;
                corner[n_corners][2] = has_vn ? (int32_t)(vn > 0 ? vn - 1 : (vn < 0 ? in_ + vn : -1)) : -1;
                ++n_corners;
            }
            for (int c = 1; c + 1 < n_corners; ++c) {  // fan triangulation
                for (int k = 0; k < 3; ++k) {
                    face_idx[(fi * 3 + 0) * 3 + k] = corner[0][k];
                    face_idx[(fi * 3 + 1) * 3 + k] = corner[c][k];
                    face_idx[(fi * 3 + 2) * 3 + k] = corner[c + 1][k];
                }
                face_line[fi] = line;
                ++fi;
            }
        }
        while (p < end && *p != '\n') ++p;
        ++p;
        ++line;
    }
    return 0;
}

}  // extern "C"
