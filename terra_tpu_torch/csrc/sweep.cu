// The brute-force closest hit: every ray against every triangle, one
// thread a ray (sm_90a).
//
// Replaces no Pallas kernel. The JAX package's brute-force sweep is plain
// jnp code (terra_tpu/intersect.py: raycast_brute), which XLA fuses. The
// port's plain twin is the same dense (rays x triangle-block) grid
// (terra_tpu_torch/intersect.py: raycast_brute), which CPU tensors still
// take; on the card it was ~75 elementwise and reduce kernels a raycast,
// each streaming an (N, TB) f32 intermediate through device memory. Here a
// raycast is one launch that keeps every intermediate in registers.
//
// The triangles are the slot rows the traversal kernels read (40 bytes:
// the corners a, b, c and the id's i32 bits; intersect.pack_sweep), in id
// order. A block stages them kTile rows at a time in shared memory, where
// the lanes of a warp read the same row at once (a broadcast). Each thread
// tests its ray against every triangle in ascending id order with
// traverse_common.cuh's isect_mt / isect_wt, which repeat the grid's f32
// operations in its order (built with -fmad=false, no fast math), and takes
// a hit only when its t is strictly smaller: the lowest id wins at equal t,
// as the grid's block minimum and its strict merge across blocks give.
// There is no any-hit early-out: the render keeps the closest hit's
// triangle of an occluded shadow ray.
//
// Per ray it writes t (T_FAR on a miss), the triangle (0 on a miss) and
// hit. With t_max (HAS_TMAX) hit is t < t_max and the triangle 0 where it
// is not, t still the closest hit's: the render's ranged occlusion query.
//
// Bound (cornell.render: 262,144 rays x 32 triangles a raycast): 46 f32
// operations a pair for Moller-Trumbore with the edges counted once a
// triangle, 386 MFLOP, 5.8 us at the 67 TFLOP/s FMA rate; under -fmad=false
// every multiply and add is an instruction of its own, so the pipe reaches
// half of that rate at most. The bytes (the rays read and the hits written
// once, 9.4 MB) take 2.8 us at 3.35 TB/s. Nothing is allocated here and
// nothing is read back; the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "traverse_common.cuh"

namespace {

using terra::Ray;
using terra::Slot;
using terra::T_FAR;

constexpr int kBlock = 128;
// Slot rows a block stages at once: 20 KB of shared memory.
constexpr int kTile = 512;

template <int ALGO, bool HAS_TMAX>
__global__ void __launch_bounds__(kBlock)
sweep_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ t_max, const float2* __restrict__ slots, int64_t n,
             int64_t tris, float* __restrict__ out_t, int32_t* __restrict__ out_tri,
             bool* __restrict__ out_hit) {
    __shared__ float2 tile[kTile * 5];
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    const bool live = i < n;
    // a thread past the last ray tests ray 0 and writes nothing: every
    // thread of the block stages the tiles
    const Ray r = terra::load_ray(o, d, live ? i : 0);
    const terra::Shear s = terra::make_shear(r);
    float best_t = T_FAR;
    int best_i = 0;
    for (int64_t base = 0; base < tris; base += kTile) {
        const int count = static_cast<int>(tris - base < kTile ? tris - base : kTile);
        __syncthreads();  // every thread is done with the last tile
        for (int k = threadIdx.x; k < count * 5; k += kBlock) tile[k] = __ldg(slots + base * 5 + k);
        __syncthreads();
        for (int j = 0; j < count; ++j) {
            const float2* p = tile + 5 * j;
            const float2 w0 = p[0], w1 = p[1], w2 = p[2], w3 = p[3], w4 = p[4];
            const Slot tri{w0.x, w0.y, w1.x, w1.y, w2.x, w2.y, w3.x, w3.y, w4.x,
                           __float_as_int(w4.y)};
            float t;
            const bool ok = ALGO == 0 ? terra::isect_mt(r, tri, t) : terra::isect_wt(r, s, tri, t);
            if (ok && t < best_t) {
                best_t = t;
                best_i = tri.id;
            }
        }
    }
    if (!live) return;
    const bool hit = HAS_TMAX ? best_t < __ldg(t_max + i) : best_t < T_FAR;
    out_t[i] = best_t;
    out_tri[i] = hit ? best_i : 0;
    out_hit[i] = hit;
}

template <int ALGO, bool HAS_TMAX>
void launch(const float* o, const float* d, const float* t_max, const float2* slots, int64_t n,
            int64_t tris, float* out_t, int32_t* out_tri, bool* out_hit, cudaStream_t s) {
    sweep_kernel<ALGO, HAS_TMAX><<<static_cast<unsigned>((n + kBlock - 1) / kBlock), kBlock, 0, s>>>(
        o, d, t_max, slots, n, tris, out_t, out_tri, out_hit);
}

}  // namespace

// The closest hit of n rays (o, d: f32 (n, 3)) over tris triangles (slots:
// f32 (tris, 10) rows, id order), by intersector algo (0 Moller-Trumbore,
// 1 watertight), with t_max (f32 (n,)) or without (null), into out_t (f32),
// out_tri (int32) and out_hit (bool, one byte), each (n,). One launch on
// stream, none for n == 0; an unknown algo launches nothing and returns
// cudaErrorInvalidValue. Returns cudaGetLastError().
extern "C" int terra_sweep(const float* o, const float* d, const float* t_max,
                           const float* slots, int64_t n, int64_t tris, int algo, float* out_t,
                           int32_t* out_tri, bool* out_hit, void* stream) {
    if (algo != 0 && algo != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float2* rows = reinterpret_cast<const float2*>(slots);
    if (algo == 0) {
        if (t_max) launch<0, true>(o, d, t_max, rows, n, tris, out_t, out_tri, out_hit, s);
        else launch<0, false>(o, d, t_max, rows, n, tris, out_t, out_tri, out_hit, s);
    } else {
        if (t_max) launch<1, true>(o, d, t_max, rows, n, tris, out_t, out_tri, out_hit, s);
        else launch<1, false>(o, d, t_max, rows, n, tris, out_t, out_tri, out_hit, s);
    }
    return static_cast<int>(cudaGetLastError());
}
