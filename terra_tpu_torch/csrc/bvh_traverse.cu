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
//     kernel sets best_t to 0 there; no later leaf can beat it);
//   * start links (the TPU kernel's has_starts mode, one link per packet
//     there): with ``start`` given, ray i's stack starts from start[i] (an
//     internal id, or ni + leaf id) instead of the root, popped without a
//     box test as the root is. A runtime pointer test, not a template
//     parameter: the branch is taken once per ray.
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
// no part. The BVH4 overlay has its own kernel, bvh4_traverse.cu; the
// ray, the slab rule and the leaf tests are shared (traverse_common.cuh).
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

#include "traverse_common.cuh"

namespace {

using namespace terra;

constexpr int BLOCK = 128;

// Entry t of the ray into node ``c``'s box, T_FAR when the slab test
// fails or the box starts beyond best_t.
__device__ __forceinline__ float entry(const float4* __restrict__ nodes, int c,
                                       const Ray& r, float ix, float iy, float iz,
                                       float best_t) {
    const float4 a = __ldg(&nodes[2 * c]);      // minx miny minz maxx
    const float4 b = __ldg(&nodes[2 * c + 1]);  // maxy maxz -    -
    return slab(a.x, a.y, a.z, a.w, b.x, b.y, r, ix, iy, iz, best_t);
}

template <int ALGO, bool HAS_TMAX, bool ANY_HIT>
__global__ void __launch_bounds__(BLOCK)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, const int32_t* __restrict__ start,
                    const float4* __restrict__ nodes, const int2* __restrict__ links,
                    const float* __restrict__ tris,
                    const int32_t* __restrict__ tri_id, int64_t n, int ni, int leaf_size,
                    float* __restrict__ out_t, int32_t* __restrict__ out_i) {
    const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    const Ray r = load_ray(o, d, i);
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
        stack[sp++] = start ? __ldg(start + i) : 0;
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
void launch(const float* o, const float* d, const float* t_max, const int32_t* start,
            const float* nodes, const int32_t* links, const float* tris, const int32_t* tri_id, int64_t n,
            int ni, int leaf_size, float* out_t, int32_t* out_i, cudaStream_t stream) {
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    bvh_traverse_kernel<ALGO, HAS_TMAX, ANY_HIT><<<grid, BLOCK, 0, stream>>>(
        o, d, t_max, start, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const int2*>(links), tris, tri_id, n, ni, leaf_size, out_t, out_i);
}

template <int ALGO>
void launch_algo(const float* o, const float* d, const float* t_max, const int32_t* start,
                 const float* nodes, const int32_t* links, const float* tris, const int32_t* tri_id, int64_t n,
                 int ni, int leaf_size, int any_hit, float* out_t, int32_t* out_i,
                 cudaStream_t stream) {
    if (t_max != nullptr) {
        if (any_hit)
            launch<ALGO, true, true>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
        else
            launch<ALGO, true, false>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
    } else {
        if (any_hit)
            launch<ALGO, false, true>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
        else
            launch<ALGO, false, false>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, out_t, out_i, stream);
    }
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 or null; start: (n,) i32 start links in
// [0, ni + C) or null (the root; a single-leaf tree ignores them); nodes:
// (ni + C, 8) f32 boxes [minx miny minz maxx maxy maxz 0 0]; links:
// (max(ni, 1), 2) i32 children;
// tris: (C * leaf_size, 9) f32 corners; tri_id: (C * leaf_size,) i32;
// algo 0 = Moller-Trumbore, 1 = watertight. Outputs best_t (n,) f32 and
// best_i (n,) i32. The tree depth + 2 must not exceed TERRA_STACK_CAP
// (checked by the wrapper). Returns cudaGetLastError() after the launch.
extern "C" int terra_bvh_raycast(const float* o, const float* d, const float* t_max,
                                 const int32_t* start, const float* nodes, const int32_t* links,
                                 const float* tris, const int32_t* tri_id, int64_t n,
                                 int ni, int leaf_size, int algo, int any_hit,
                                 float* out_t, int32_t* out_i, void* stream) {
    if (n > 0) {
        cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
        if (algo == 0)
            launch_algo<0>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, any_hit, out_t, out_i, st);
        else
            launch_algo<1>(o, d, t_max, start, nodes, links, tris, tri_id, n, ni, leaf_size, any_hit, out_t, out_i, st);
    }
    return (int)cudaGetLastError();
}
