// Shared device code of the traversal kernels (bvh_traverse.cu, the
// binary tree, and bvh4_traverse.cu, the BVH4 overlay): the ray, the
// clamped inverse direction, the traversal stack, the leaf slot and the
// leaf tests,
// written with the operation order of terra_tpu_torch/intersect.py so that
// each kernel and its plain PyTorch version give the same bits (built with
// -fmad=false, no fast math).
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

// A thread's traversal stack, in local memory: only the entries a walk
// touches occupy L1. A column of shared memory per thread, sized from the
// tree, measured 0.5-2% slower on the render's batches, and a ring of 8
// shared entries spilling to local memory no faster (PERF.md): a shared
// stack's carve-out takes L1 from the node and triangle loads.
struct Stack {
    int entry[TERRA_STACK_CAP];
    int sp = 0;

    __device__ __forceinline__ void push(int v) { entry[sp++] = v; }
    __device__ __forceinline__ int pop() { return entry[--sp]; }
    __device__ __forceinline__ bool empty() const { return sp == 0; }
};

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

// One leaf slot: the corners a, b, c and the triangle id, read from a
// 40-byte row [ax ay az bx by bz cx cy cz id] as five 8-byte loads.
struct Slot {
    float ax, ay, az, bx, by, bz, cx, cy, cz;
    int id;
};

__device__ __forceinline__ Slot load_slot(const float2* __restrict__ p) {
    const float2 w0 = __ldg(p), w1 = __ldg(p + 1), w2 = __ldg(p + 2), w3 = __ldg(p + 3),
                 w4 = __ldg(p + 4);
    return Slot{w0.x, w0.y, w1.x, w1.y, w2.x, w2.y, w3.x, w3.y, w4.x, __float_as_int(w4.y)};
}

// Moller-Trumbore (intersect.mt_components).
__device__ __forceinline__ bool isect_mt(const Ray& r, const Slot& p, float& t) {
    const float e1x = p.bx - p.ax, e1y = p.by - p.ay, e1z = p.bz - p.az;
    const float e2x = p.cx - p.ax, e2y = p.cy - p.ay, e2z = p.cz - p.az;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * hx + e1y * hy + e1z * hz;
    const bool ok_det = fabsf(det) > EPS;
    const float inv = 1.0f / (ok_det ? det : 1.0f);
    const float sx = r.ox - p.ax, sy = r.oy - p.ay, sz = r.oz - p.az;
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
__device__ __forceinline__ bool isect_wt(const Ray& r, const Shear& s, const Slot& p, float& t) {
    float axp, ayp, azp, bxp, byp, bzp, cxp, cyp, czp;
    shear(s, r, p.ax, p.ay, p.az, axp, ayp, azp);
    shear(s, r, p.bx, p.by, p.bz, bxp, byp, bzp);
    shear(s, r, p.cx, p.cy, p.cz, cxp, cyp, czp);
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

// Dense test of leaf ``leaf`` (rows [leaf * leaf_size, (leaf + 1) *
// leaf_size) of ``slots``): returns true when it improved best_t. The next
// slot's loads go out before this slot's test, so each test waits on loads
// issued one test earlier. Every slot is tested, the padding too: the
// lanes of a warp test their leaves in step, so a lane that stopped at its
// leaf's padding would wait for the others, and the check measured 1-5%
// slower on two of the three render batches (PERF.md).
template <int ALGO, bool ANY_HIT>
__device__ __forceinline__ bool leaf_test(const float2* __restrict__ slots, int leaf,
                                          int leaf_size, const Ray& r, const Shear& s,
                                          float& best_t, int& best_i) {
    float lt = T_FAR;
    int li = INT_MAX;
    const float2* p = slots + (int64_t)leaf * leaf_size * 5;
    Slot tri = load_slot(p);
    for (int k = 1;; ++k) {
        const bool more = k < leaf_size;
        Slot next = tri;
        if (more) next = load_slot(p + 5 * k);
        float t;
        const bool ok = ALGO == 0 ? isect_mt(r, tri, t) : isect_wt(r, s, tri, t);
        const float tm = ok ? t : T_FAR;
        if (tm < lt || (tm == lt && tri.id < li)) {
            lt = tm;
            li = tri.id;
        }
        if (!more) break;
        tri = next;
    }
    if (lt < best_t) {
        best_i = li;
        best_t = ANY_HIT ? 0.0f : lt;
        return true;
    }
    return false;
}

}  // namespace terra
