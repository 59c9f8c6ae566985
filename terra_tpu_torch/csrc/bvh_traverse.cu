// Ordered-stack BVH traversal for Hopper (sm_90a): one thread per ray.
//
// Replaces the Pallas TPU kernel terra_tpu/accel/pallas_traverse.py
// (_kernel, launched by _traverse_pallas). For every ray it returns the
// smallest accepted leaf-test t and that triangle's id, with the rules of
// the TPU kernel:
//   * inverse direction 1/d, clamped to 1e12 where |d| <= 1e-12;
//   * slab test  tmax >= max(tmin, 0) && tmin < best_t  (>=: flat boxes of
//     axis-aligned walls stay visible);
//   * within a leaf, equal t goes to the lowest triangle id; a leaf wins
//     only with t strictly below the running best;
//   * occlusion: best_t starts at the ray's t_max (HAS_TMAX), and ANY_HIT
//     stops the ray at its first accepted hit with best_t = 0 (the TPU
//     kernel sets best_t to 0 there; no later leaf can beat it).
// The leaf test is Moller-Trumbore or the Wald2013-style watertight test
// (ALGO), written with the operation order of terra_tpu_torch/intersect.py.
//
// Design. The TPU kernel walks 1024-ray packets with a scalar stack in
// SMEM because its vector unit has no per-lane control flow. On Hopper
// each thread walks its own ray through the binary SAH tree (unified id
// space: internal nodes 0..ni-1, leaf k at ni+k) with a private stack,
// children pushed far-first so the near one pops next. The kernel is
// bound by the latency of divergent, dependent loads of node boxes and
// triangles, not by arithmetic or DRAM bandwidth: the 242k-triangle
// courtyard's tables (2 MiB of nodes, 10 MiB of triangle slots at leaf 8)
// sit in the 50 MB L2. The design keeps those loads few and wide: a node box is two
// 16-byte loads (min.xyz max.x | max.yz pad), both children's boxes are
// tested before either is pushed, and any-hit rays stop at their first
// hit. There are no matrix products, so wgmma and the tensor cores play
// no part. Wider nodes (BVH4) and ray sorting come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -DTERRA_STACK_CAP=<n>
// No --use_fast_math: approximate reciprocals move t at triangle edges and
// flip hit masks against the reference. -fmad=false keeps every product
// rounded on its own, as PyTorch's elementwise ops round them, so the
// kernel and its plain PyTorch version give the same bits.
//
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; terra_bvh_raycast returns cudaGetLastError().

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#ifndef TERRA_STACK_CAP
#error "build with -DTERRA_STACK_CAP=<n> (the wrapper's STACK_CAP)"
#endif

namespace {

constexpr float T_FAR = 3.4e38f;
constexpr float EPS = 1e-4f;
constexpr int BLOCK = 128;

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float inv_dir(float v) {
    return fabsf(v) > 1e-12f ? 1.0f / v : 1e12f;
}

// Entry t of the ray into node ``c``'s box, T_FAR when the slab test
// fails or the box starts beyond best_t.
__device__ __forceinline__ float entry(const float4* __restrict__ nodes, int c,
                                       const Ray& r, float ix, float iy, float iz,
                                       float best_t) {
    const float4 a = __ldg(&nodes[2 * c]);      // minx miny minz maxx
    const float4 b = __ldg(&nodes[2 * c + 1]);  // maxy maxz -    -
    const float t1x = (a.x - r.ox) * ix;
    const float t2x = (a.w - r.ox) * ix;
    const float t1y = (a.y - r.oy) * iy;
    const float t2y = (b.x - r.oy) * iy;
    const float t1z = (a.z - r.oz) * iz;
    const float t2z = (b.y - r.oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    const float tmax = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    const bool hit = (tmax >= fmaxf(tmin, 0.0f)) && (tmin < best_t);
    return hit ? tmin : T_FAR;
}

// Moller-Trumbore (intersect.mt_components).
__device__ __forceinline__ bool isect_mt(const Ray& r, const float* __restrict__ p, float& t) {
    const float ax = __ldg(p + 0), ay = __ldg(p + 1), az = __ldg(p + 2);
    const float bx = __ldg(p + 3), by = __ldg(p + 4), bz = __ldg(p + 5);
    const float cx = __ldg(p + 6), cy = __ldg(p + 7), cz = __ldg(p + 8);
    const float e1x = bx - ax, e1y = by - ay, e1z = bz - az;
    const float e2x = cx - ax, e2y = cy - ay, e2z = cz - az;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const bool ok_det = fabsf(det) > EPS;
    const float inv = 1.0f / (ok_det ? det : 1.0f);
    const float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
    const float u = inv * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = inv * (r.dx * qx + r.dy * qy + r.dz * qz);
    t = inv * (e2x * qx + e2y * qy + e2z * qz);
    return ok_det && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > EPS);
}

// Per-ray constants of the watertight test: the permutation that moves
// the dominant direction axis to z, the winding swap and the shear.
struct Shear {
    bool m0, m1, swap;
    float sx, sy, sz;
};

__device__ __forceinline__ void perm(const Shear& s, float vx, float vy, float vz,
                                     float& px, float& py, float& pz) {
    pz = s.m0 ? vx : (s.m1 ? vy : vz);
    px = s.m0 ? vy : (s.m1 ? vz : vx);
    py = s.m0 ? vz : (s.m1 ? vx : vy);
}

__device__ __forceinline__ Shear make_shear(const Ray& r) {
    Shear s;
    const float adx = fabsf(r.dx), ady = fabsf(r.dy), adz = fabsf(r.dz);
    s.m0 = (adx >= ady) && (adx >= adz);
    s.m1 = (!s.m0) && (ady >= adz);
    s.swap = false;
    float dpx, dpy, dpz;
    perm(s, r.dx, r.dy, r.dz, dpx, dpy, dpz);
    s.swap = dpz < 0.0f;
    if (s.swap) {
        const float tmp = dpx;
        dpx = dpy;
        dpy = tmp;
    }
    s.sz = 1.0f / (dpz != 0.0f ? dpz : 1.0f);
    s.sx = dpx * s.sz;
    s.sy = dpy * s.sz;
    return s;
}

__device__ __forceinline__ void shear(const Shear& s, const Ray& r, float vx, float vy, float vz,
                                      float& qx, float& qy, float& qz) {
    float px, py, pz;
    perm(s, vx - r.ox, vy - r.oy, vz - r.oz, px, py, pz);
    if (s.swap) {
        const float tmp = px;
        px = py;
        py = tmp;
    }
    qx = px - s.sx * pz;
    qy = py - s.sy * pz;
    qz = pz;
}

// p1*p2 - q1*q2, snapped to 0 within a few ulps of full cancellation.
__device__ __forceinline__ float dop(float p1, float p2, float q1, float q2) {
    const float p = p1 * p2;
    const float q = q1 * q2;
    const float d = p - q;
    const bool snap = fabsf(d) <= fmaxf(fabsf(p), fabsf(q)) * 4e-7f;
    return snap ? 0.0f : d;
}

// Wald2013-style watertight test (intersect.watertight_components).
__device__ __forceinline__ bool isect_wt(const Ray& r, const Shear& s,
                                         const float* __restrict__ p, float& t) {
    float axp, ayp, azp, bxp, byp, bzp, cxp, cyp, czp;
    shear(s, r, __ldg(p + 0), __ldg(p + 1), __ldg(p + 2), axp, ayp, azp);
    shear(s, r, __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), bxp, byp, bzp);
    shear(s, r, __ldg(p + 6), __ldg(p + 7), __ldg(p + 8), cxp, cyp, czp);
    const float u = dop(cxp, byp, cyp, bxp);
    const float v = dop(axp, cyp, ayp, cxp);
    const float w = dop(bxp, ayp, byp, axp);
    const bool any_neg = (u < 0.0f) || (v < 0.0f) || (w < 0.0f);
    const bool any_pos = (u > 0.0f) || (v > 0.0f) || (w > 0.0f);
    const float det = u + v + w;
    const float t_scaled = (u * azp + v * bzp + w * czp) * s.sz;
    t = t_scaled / (det != 0.0f ? det : 1.0f);
    return !(any_neg && any_pos) && (det != 0.0f) && (t > EPS);
}

// Dense test of leaf ``leaf``: returns true when it improved best_t.
template <int ALGO, bool ANY_HIT>
__device__ __forceinline__ bool leaf_test(const float* __restrict__ tris,
                                          const int32_t* __restrict__ tri_id,
                                          int leaf, int leaf_size, const Ray& r,
                                          const Shear& s, float& best_t, int& best_i) {
    float lt = T_FAR;
    int li = INT_MAX;
    const int64_t base = (int64_t)leaf * leaf_size;
    for (int k = 0; k < leaf_size; ++k) {
        float t;
        const float* p = tris + 9 * (base + k);
        const bool ok = ALGO == 0 ? isect_mt(r, p, t) : isect_wt(r, s, p, t);
        const float tm = ok ? t : T_FAR;
        const int id = __ldg(tri_id + base + k);
        if (tm < lt || (tm == lt && id < li)) {
            lt = tm;
            li = id;
        }
    }
    if (lt < best_t) {
        best_i = li;
        best_t = ANY_HIT ? 0.0f : lt;
        return true;
    }
    return false;
}

template <int ALGO, bool HAS_TMAX, bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, const float4* __restrict__ nodes,
                    const int2* __restrict__ links, const float* __restrict__ tris,
                    const int32_t* __restrict__ tri_id, int64_t n, int ni, int leaf_size,
                    float* __restrict__ out_t, int32_t* __restrict__ out_i) {
    const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    Ray r;
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
    Shear s{};
    if (ALGO == 1) s = make_shear(r);
    float best_t = HAS_TMAX ? t_max[i] : T_FAR;
    int best_i = 0;

    if (ni == 0) {  // single-leaf tree
        leaf_test<ALGO, ANY_HIT>(tris, tri_id, 0, leaf_size, r, s, best_t, best_i);
    } else {
        int stack[TERRA_STACK_CAP];
        int sp = 0;
        stack[sp++] = 0;
        while (sp > 0) {
            const int node = stack[--sp];
            if (node >= ni) {
                if (leaf_test<ALGO, ANY_HIT>(tris, tri_id, node - ni, leaf_size, r, s,
                                             best_t, best_i) && ANY_HIT)
                    break;
                continue;
            }
            const int2 lr = __ldg(&links[node]);
            const float el = entry(nodes, lr.x, r, ix, iy, iz, best_t);
            const float er = entry(nodes, lr.y, r, ix, iy, iz, best_t);
            const bool near_first = el <= er;
            const int first = near_first ? lr.x : lr.y;
            const int second = near_first ? lr.y : lr.x;
            if (fmaxf(el, er) < T_FAR) stack[sp++] = second;
            if (fminf(el, er) < T_FAR) stack[sp++] = first;
        }
    }
    out_t[i] = best_t;
    out_i[i] = best_i;
}

template <int ALGO, bool HAS_TMAX, bool ANY_HIT>
void launch(const float* o, const float* d, const float* t_max, const float* nodes,
            const int32_t* links, const float* tris, const int32_t* tri_id, int64_t n,
            int ni, int leaf_size, float* out_t, int32_t* out_i, cudaStream_t stream) {
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    bvh_traverse_kernel<ALGO, HAS_TMAX, ANY_HIT><<<grid, BLOCK, 0, stream>>>(
        o, d, t_max, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const int2*>(links), tris, tri_id, n, ni, leaf_size, out_t, out_i);
}

template <int ALGO>
void launch_algo(const float* o, const float* d, const float* t_max, const float* nodes,
                 const int32_t* links, const float* tris, const int32_t* tri_id, int64_t n,
                 int ni, int leaf_size, int any_hit, float* out_t, int32_t* out_i,
                 cudaStream_t stream) {
    if (t_max != nullptr) {
        if (any_hit)
            launch<ALGO, true, true>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
        else
            launch<ALGO, true, false>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
    } else {
        if (any_hit)
            launch<ALGO, false, true>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
        else
            launch<ALGO, false, false>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
    }
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 or null; nodes: (ni + C, 8) f32 boxes
// [minx miny minz maxx maxy maxz 0 0]; links: (max(ni, 1), 2) i32 children;
// tris: (C * leaf_size, 9) f32 corners; tri_id: (C * leaf_size,) i32;
// algo 0 = Moller-Trumbore, 1 = watertight. Outputs best_t (n,) f32 and
// best_i (n,) i32. The tree depth + 2 must not exceed TERRA_STACK_CAP
// (checked by the wrapper). Returns cudaGetLastError() after the launch.
extern "C" int terra_bvh_raycast(const float* o, const float* d, const float* t_max,
                                 const float* nodes, const int32_t* links,
                                 const float* tris, const int32_t* tri_id, int64_t n,
                                 int ni, int leaf_size, int algo, int any_hit,
                                 float* out_t, int32_t* out_i, void* stream) {
    if (n > 0) {
        cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
        if (algo == 0)
            launch_algo<0>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, any_hit, out_t, out_i, st);
        else
            launch_algo<1>(o, d, t_max, nodes, links, tris, tri_id, n, ni, leaf_size, any_hit, out_t, out_i, st);
    }
    return (int)cudaGetLastError();
}
