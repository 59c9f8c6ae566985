// The tree's boxes recomputed for moved vertices on a fixed topology: a
// bottom-up refit with arrival counters (Karras, HPG 2012, section 4), sm_90a.
//
// Replaces no Pallas kernel. The JAX package refits in NumPy on the host
// (terra_tpu/accel/lbvh.py: _refit_host), level by level to a fix point;
// the port's plain twin is the same function (accel/lbvh.py: _refit_host),
// which CPU tensors still take. For CUDA tensors a refit was a read of the
// positions to the host, the NumPy passes and the copies back, with the
// card idle throughout; here it is two launches on the caller's stream
// that read and write no host memory.
//
// The tree is the port's flat SoA tree in the unified id space: internal
// nodes 0..ni-1 (node_left / node_right their children), leaf k at ni + k,
// ni + 1 leaves, root 0. Boxes are (ni + C, 3) f32 rows, internal rows
// then leaf rows.
//   1. parents_kernel, one thread per internal node i: parent[left[i]] =
//      parent[right[i]] = i and arrivals[i] = 0; the root's parent is -1.
//      The parents are derived at every call (a few us), so the tree holds
//      no field for them.
//   2. up_kernel, one thread per leaf k: the min and max over the 3 corners
//      of its leaf_size triangle slots (gathered through tri_vidx) to row
//      ni + k; then up the tree: __threadfence(), atomicAdd on the parent's
//      counter; the first thread to arrive stops, the second reads both
//      children's boxes (through L2, __ldcg: the sibling's row was written
//      by another SM) and writes the parent's, and goes on to its parent,
//      until the root (-1). A node that more than two threads reach (a tree
//      that is not the builder's) passes none of them up, so every walk
//      ends.
// Boxes are min / max selections, so the values equal the plain twin's
// whatever order the threads arrive in, and repeat from call to call. The
// selections are NumPy's: (a <= b || a != a) ? a : b for the minimum, so a
// NaN coordinate propagates to every box above it as np.minimum and
// np.maximum propagate it (fminf and fmaxf would drop it). Of two equal
// zeros the left operand is kept; NumPy's vector loops may keep the other,
// so a zero's sign may differ from the twin's.
//
// Bound (the 242k courtyard's SAH tree at leaf 8: 33,168 leaves): the slot
// ids (4 B), the vertex ids (12 B) and the corners (36 B) of 8 slots a leaf
// read once, 13.8 MB; the topology, parents and counters, the children's
// boxes read and every box written once, 4.4 MB: 5.4 us at 3.35 TB/s. The
// walk up is serial in the depth, one atomic and two dependent L2 reads a
// level: a refit takes 49 us on an H100 (both launches, in a CUDA graph),
// against ~140 ms for the host refit. Nothing is allocated here and
// nothing is read back; the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float min_np(float a, float b) { return (a <= b || a != a) ? a : b; }
__device__ __forceinline__ float max_np(float a, float b) { return (a >= b || a != a) ? a : b; }

__global__ void __launch_bounds__(kBlock)
parents_kernel(const int32_t* __restrict__ left, const int32_t* __restrict__ right, int64_t ni,
               int32_t* __restrict__ parent, int32_t* __restrict__ arrivals) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (i == 0) parent[0] = -1;
    if (i >= ni) return;
    parent[left[i]] = static_cast<int32_t>(i);
    parent[right[i]] = static_cast<int32_t>(i);
    arrivals[i] = 0;
}

__global__ void __launch_bounds__(kBlock)
up_kernel(const float* __restrict__ pos, const int32_t* __restrict__ vidx,
          const int32_t* __restrict__ leaf_tri, int leaf_size, const int32_t* __restrict__ left,
          const int32_t* __restrict__ right, const int32_t* __restrict__ parent,
          int32_t* arrivals, int64_t ni, int64_t leaves, float* box_min, float* box_max) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    if (k >= leaves) return;
    float lo[3], hi[3];
    const int32_t* slots = leaf_tri + k * leaf_size;
    for (int j = 0; j < leaf_size; ++j) {
        const int64_t t = __ldg(slots + j);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float* p = pos + 3 * static_cast<int64_t>(__ldg(vidx + 3 * t + c));
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const float x = __ldg(p + a);
                lo[a] = j == 0 && c == 0 ? x : min_np(lo[a], x);
                hi[a] = j == 0 && c == 0 ? x : max_np(hi[a], x);
            }
        }
    }
    int64_t node = ni + k;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        box_min[3 * node + a] = lo[a];
        box_max[3 * node + a] = hi[a];
    }
    for (int32_t p = __ldg(parent + node); p >= 0; p = __ldg(parent + p)) {
        __threadfence();  // this thread's box before its arrival
        if (atomicAdd(arrivals + p, 1) != 1) return;  // first here, or a malformed tree
        __threadfence();  // the sibling's box after its arrival
        const int64_t l = __ldg(left + p), r = __ldg(right + p);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            box_min[3 * static_cast<int64_t>(p) + a] =
                min_np(__ldcg(box_min + 3 * l + a), __ldcg(box_min + 3 * r + a));
            box_max[3 * static_cast<int64_t>(p) + a] =
                max_np(__ldcg(box_max + 3 * l + a), __ldcg(box_max + 3 * r + a));
        }
    }
}

}  // namespace

// The boxes of a tree of ni internal nodes (node_left / node_right, int32)
// and ni + 1 leaves (leaf_tri, int32 (ni + 1, leaf_size) triangle ids) for
// the vertices pos (f32 (V, 3)) of the triangles tri_vidx (int32 (T, 3)),
// written to box_min / box_max (f32 (2 ni + 1, 3)). parent (int32,
// 2 ni + 1) and arrivals (int32, max(ni, 1)) are the caller's scratch, left
// uninitialised. Ids are not checked. Two launches on stream; returns
// cudaGetLastError().
extern "C" int terra_bvh_refit(const float* pos, const int32_t* tri_vidx, const int32_t* leaf_tri,
                               int leaf_size, const int32_t* node_left,
                               const int32_t* node_right, int64_t ni, int32_t* parent,
                               int32_t* arrivals, float* box_min, float* box_max, void* stream) {
    const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int64_t leaves = ni + 1;
    const int64_t inner = ni > 0 ? ni : 1;
    parents_kernel<<<static_cast<unsigned>((inner + kBlock - 1) / kBlock), kBlock, 0, s>>>(
        node_left, node_right, ni, parent, arrivals);
    up_kernel<<<static_cast<unsigned>((leaves + kBlock - 1) / kBlock), kBlock, 0, s>>>(
        pos, tri_vidx, leaf_tri, leaf_size, node_left, node_right, parent, arrivals, ni, leaves,
        box_min, box_max);
    return static_cast<int>(cudaGetLastError());
}
