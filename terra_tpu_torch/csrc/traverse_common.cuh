// Shared device code of the traversal kernels (bvh_traverse.cu, the
// binary tree, and bvh4_traverse.cu, the BVH4 overlay): the ray, the
// clamped inverse direction and the leaf tests, written with the operation
// order of terra_tpu_torch/intersect.py so that each kernel and its plain
// PyTorch version give the same bits (built with -fmad=false, no fast math).
#pragma once

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#ifndef TERRA_STACK_CAP
#error "build with -DTERRA_STACK_CAP=<n> (the wrapper's STACK_CAP)"
#endif

namespace terra {

constexpr float T_FAR = 3.4e38f;
constexpr float EPS = 1e-4f;

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ float inv_dir(float v) {
    return fabsf(v) > 1e-12f ? 1.0f / v : 1e12f;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int64_t i) {
    Ray r;
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    return r;
}

// Entry t of the ray into the box [min, max], T_FAR when the slab test
// fails or the box starts beyond best_t. >= keeps flat boxes of
// axis-aligned walls visible; a +inf point box (an empty BVH4 slot) never
// passes, since its tmin is +inf or its tmax is -inf.
__device__ __forceinline__ float slab(float x0, float y0, float z0, float x1, float y1, float z1,
                                      const Ray& r, float ix, float iy, float iz, float best_t) {
    const float t1x = (x0 - r.ox) * ix;
    const float t2x = (x1 - r.ox) * ix;
    const float t1y = (y0 - r.oy) * iy;
    const float t2y = (y1 - r.oy) * iy;
    const float t1z = (z0 - r.oz) * iz;
    const float t2z = (z1 - r.oz) * iz;
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

}  // namespace terra
