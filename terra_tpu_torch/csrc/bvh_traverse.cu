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
//     there): with ``start`` given, ray i's walk starts from start[i] (an
//     internal id, or ni + leaf id) instead of the root, taken without a
//     box test as the root is. A runtime pointer test, not a template
//     parameter: the branch is taken once per ray.
// The leaf test is Moller-Trumbore or the Wald2013-style watertight test
// (ALGO), written with the operation order of terra_tpu_torch/intersect.py.
//
// Design. The TPU kernel walks 1024-ray packets with a scalar stack in
// SMEM because its vector unit has no per-lane control flow. On Hopper
// each thread walks its own ray through the binary SAH tree (unified id
// space: internal nodes 0..ni-1, leaf k at ni+k). The kernel is bound by
// the latency of divergent, dependent loads of node boxes and triangles,
// not by arithmetic or DRAM bandwidth: the 242k-triangle courtyard's
// tables (2 MiB of nodes, 10 MiB of triangle slots at leaf 8) sit in the
// 50 MB L2, and a render's batch is a single wave of blocks. The design
// keeps the loads few and wide and the warps in step, as the BVH4 kernel
// (bvh4_traverse.cu) does: a node box is two 16-byte loads (min.xyz max.x
// | max.yz pad); both children's boxes are tested, the far hit child is
// pushed and the walk goes on with the near one, the entry the
// reference's stack pops next; the walk is the while-while of Aila and
// Laine without speculation (a lane visits nodes until it holds a leaf,
// then the lanes holding leaves test them in step), so each ray takes its
// entries in the reference's order; leaf slots are 40-byte rows read as
// 8-byte loads, the next slot's ahead of the current slot's test; any-hit
// rays stop at their first hit. There are no matrix products, so wgmma and
// the tensor cores play no part. The ray, the slab rule, the local-memory
// stack and the leaf tests are shared with the BVH4 kernel
// (traverse_common.cuh).
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
                    const float2* __restrict__ slots, int64_t n, int ni, int leaf_size,
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
        leaf_test<ALGO, ANY_HIT>(slots, 0, leaf_size, r, s, best_t, best_i);
    } else {
        Stack stack;
        int node = start ? __ldg(start + i) : 0;
        while (true) {
            while (node >= 0 && node < ni) {
                const int2 lr = __ldg(&links[node]);
                const float el = entry(nodes, lr.x, r, ix, iy, iz, best_t);
                const float er = entry(nodes, lr.y, r, ix, iy, iz, best_t);
                const bool near_first = el <= er;
                if (fmaxf(el, er) < T_FAR) stack.push(near_first ? lr.y : lr.x);
                if (fminf(el, er) < T_FAR) node = near_first ? lr.x : lr.y;
                else node = stack.empty() ? -1 : stack.pop();
            }
            if (node < 0) break;
            if (leaf_test<ALGO, ANY_HIT>(slots, node - ni, leaf_size, r, s, best_t, best_i) &&
                ANY_HIT)
                break;
            if (stack.empty()) break;
            node = stack.pop();
        }
    }
    out_t[i] = best_t;
    out_i[i] = best_i;
}

// A kernel instance with its launch and its occupancy.
template <int ALGO, bool HAS_TMAX, bool ANY_HIT>
struct Instance {
    int launch(const float* o, const float* d, const float* t_max, const int32_t* start,
               const float* nodes, const int32_t* links, const float* slots, int64_t n, int ni,
               int leaf_size, float* out_t, int32_t* out_i, cudaStream_t stream) const {
        const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
        bvh_traverse_kernel<ALGO, HAS_TMAX, ANY_HIT><<<grid, BLOCK, 0, stream>>>(
            o, d, t_max, start, reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const int2*>(links), reinterpret_cast<const float2*>(slots), n, ni,
            leaf_size, out_t, out_i);
        return (int)cudaGetLastError();
    }

    int query(int* out) const {
        out[1] = 0;
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, bvh_traverse_kernel<ALGO, HAS_TMAX, ANY_HIT>, BLOCK, 0);
    }
};

// f(Instance<...>{}) for the instance of these options.
template <typename F>
int dispatch(int algo, bool has_tmax, bool any_hit, F&& f) {
    switch (4 * (algo != 0) + 2 * has_tmax + any_hit) {
        case 0: return f(Instance<0, false, false>{});
        case 1: return f(Instance<0, false, true>{});
        case 2: return f(Instance<0, true, false>{});
        case 3: return f(Instance<0, true, true>{});
        case 4: return f(Instance<1, false, false>{});
        case 5: return f(Instance<1, false, true>{});
        case 6: return f(Instance<1, true, false>{});
        default: return f(Instance<1, true, true>{});
    }
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 or null; start: (n,) i32 start links in
// [0, ni + C) or null (the root; a single-leaf tree ignores them); nodes:
// (ni + C, 8) f32 boxes [minx miny minz maxx maxy maxz 0 0]; links:
// (max(ni, 1), 2) i32 children; slots: (C * leaf_size, 10) f32 rows,
// corners a, b, c and the triangle id's bits; algo 0 = Moller-Trumbore,
// 1 = watertight. Outputs best_t (n,) f32 and best_i (n,) i32. The tree
// depth + 2 must not exceed TERRA_STACK_CAP (checked by the wrapper).
// Returns 0 or a cudaError_t code.
extern "C" int terra_bvh_raycast(const float* o, const float* d, const float* t_max,
                                 const int32_t* start, const float* nodes, const int32_t* links,
                                 const float* slots, int64_t n, int ni, int leaf_size, int algo,
                                 int any_hit, float* out_t, int32_t* out_i, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    return dispatch(algo, t_max != nullptr, any_hit != 0, [&](auto inst) {
        return inst.launch(o, d, t_max, start, nodes, links, slots, n, ni, leaf_size, out_t,
                           out_i, reinterpret_cast<cudaStream_t>(stream));
    });
}

// Blocks per SM (out[0]) and dynamic shared memory bytes per block (out[1])
// of the instance terra_bvh_raycast would launch for these options, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; launches nothing.
// Returns 0 or a cudaError_t code.
extern "C" int terra_bvh_query(int has_tmax, int any_hit, int algo, int* out) {
    return dispatch(algo, has_tmax != 0, any_hit != 0,
                    [&](auto inst) { return inst.query(out); });
}
