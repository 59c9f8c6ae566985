// Ordered-stack traversal of the BVH4 overlay for Hopper (sm_90a): one
// thread per ray.
//
// Replaces the Pallas TPU kernel terra_tpu/accel/pallas_traverse.py
// (_kernel at arity=4, launched by _traverse_pallas) in its three table
// encodings and with its step counters:
//   * ENC 0: f32 child boxes (pack_tables_wide(box_enc="f32"));
//   * ENC 1: bf16-pair boxes, one 32-bit word per child and axis, min in
//     the high half-word rounded toward -inf and max in the low half-word
//     rounded toward +inf (conservatively dilated: exact results, more
//     visits); decoded as min = bits(w & 0xFFFF0000), max = bits(w << 16)
//     on uint32 (_load_box, _bf16_*_bits);
//   * PAGED: wide nodes [0, S) in the resident encoding ENC, staged once
//     per block into shared memory; nodes >= S read as f32 from device
//     memory per visit (pack_tables_paged, round_body_paged). On the TPU
//     the resident part sat in SMEM and the rest was DMA'd per visit;
//   * COUNT: per-ray pops, leaf tests and paged-node visits (count_steps;
//     the wrapper's count_decode aggregates them per warp);
//   * start links (has_starts, one link per packet way on the TPU): with
//     ``start`` given, ray i's walk starts from start[i], a wide id or
//     num_wide + leaf id (the stack's own encoding), taken without a box
//     test as the root is. The compacted two-phase traversal starts each
//     ray in the subtree of its current (ray, subtree) pair. A runtime
//     pointer test, not a template parameter, so the 64 instances stay 64;
//     it runs once per ray.
// For every ray it returns the smallest accepted leaf-test t and that
// triangle's id with the rules of bvh_traverse.cu (slab test, ties,
// t_max / any-hit occlusion, MT or watertight; traverse_common.cuh).
//
// Design. A visited wide node loads its four child boxes (96 B in f32 or
// 48 B in bf16, plus 16 B of links, as 16-byte vector loads), tests all
// four, sorts the hit children by entry t with the reference's 5-exchange
// network (pairs (0,1) (2,3) (0,2) (1,3) (1,2), swapping on strictly
// smaller entry, decide_push4), pushes the others far-first and goes on
// with the nearest, the entry the reference's stack pops next. An empty
// child slot keeps the reference's +inf point box, which the slab test
// never enters. The kernel is bound by the latency of dependent, divergent
// loads, not by arithmetic or DRAM bandwidth: a render's batch is a single
// wave of blocks, so the slowest warps set the time. Three things shorten
// a warp's path (PERF.md has the A/B of each):
//   * the walk is Aila and Laine's while-while: a lane visits wide nodes
//     until it holds a leaf, then the lanes that hold leaves test them in
//     step, instead of node visits and leaf tests taking turns in one
//     loop. Each lane stops at its first leaf (no speculation), so each
//     ray takes its entries in the reference's order: the same tie
//     winners, the same any-hit stop, the same counters;
//   * the nearest hit child stays in a register instead of being pushed
//     and popped at once;
//   * a leaf slot is one 40-byte row read as five 8-byte loads, and the
//     next slot's loads go out before the current slot's test
//     (traverse_common.cuh, leaf_test).
// The stack stays in local memory (traverse_common.cuh, Stack).
// The paged mode launches a persistent grid (blocks that fit at once, each
// striding over the rays) so the staging of S nodes is paid once per
// block, not once per 128 rays.
//
// Build: as bvh_traverse.cu (nvcc sm_90a, -fmad=false, no fast math, so
// the kernel and raycast4_plain give the same bits).
//
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; terra_bvh4_raycast returns the launch's error code.

#include "traverse_common.cuh"

namespace {

using namespace terra;

constexpr int BLOCK = 128;
constexpr int PAGED_BLOCK = 256;

struct Args {
    const float* o;
    const float* d;
    const float* t_max;
    const int32_t* start;  // (n,) start links, or null for the root
    const void* nodes;     // ENC 0: (R, 24) f32; ENC 1: (R, 12) u32
    const int4* links;     // (R, 4)
    const float4* pboxes;  // paged: (W - S, 24) f32
    const int4* plinks;    // paged: (W - S, 4)
    const float2* slots;   // (C * leaf_size, 10) f32 rows, the id's bits last
    int64_t n;
    int num_wide, s_res, leaf_size;
    float* out_t;
    int32_t* out_i;
    int32_t* counts;       // COUNT: (n, 3)
    int* query;            // set: report [blocks per SM, dynamic smem bytes], launch nothing
};

// 16-byte words per node of each encoding.
template <int ENC>
__host__ __device__ constexpr int node_words() { return ENC == 0 ? 6 : 3; }

template <bool GLOBAL>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
    if constexpr (GLOBAL) return __ldg(p);
    else return *p;
}

// The four child boxes of node ``idx`` of a table in encoding ENC.
template <int ENC, bool GLOBAL>
__device__ __forceinline__ void load_boxes(const uint4* __restrict__ table, int idx,
                                           float (&lo)[4][3], float (&hi)[4][3]) {
    const uint4* p = table + (int64_t)node_words<ENC>() * idx;
    if constexpr (ENC == 0) {
        float f[24];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            const uint4 v = ld16<GLOBAL>(p + k);
            f[4 * k] = __uint_as_float(v.x);
            f[4 * k + 1] = __uint_as_float(v.y);
            f[4 * k + 2] = __uint_as_float(v.z);
            f[4 * k + 3] = __uint_as_float(v.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                lo[c][a] = f[6 * c + a];
                hi[c][a] = f[6 * c + 3 + a];
            }
    } else {
        uint32_t w[12];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const uint4 v = ld16<GLOBAL>(p + k);
            w[4 * k] = v.x;
            w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z;
            w[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                lo[c][a] = __uint_as_float(w[3 * c + a] & 0xFFFF0000u);
                hi[c][a] = __uint_as_float(w[3 * c + a] << 16);
            }
    }
}

// One exchange of the sorting network: swap on strictly smaller entry.
template <int P, int Q>
__device__ __forceinline__ void exchange(float (&e)[4], int (&l)[4]) {
    if (e[Q] < e[P]) {
        const float te = e[P];
        e[P] = e[Q];
        e[Q] = te;
        const int tl = l[P];
        l[P] = l[Q];
        l[Q] = tl;
    }
}

template <int ALGO, bool HAS_TMAX, bool ANY_HIT, int ENC, bool PAGED, bool COUNT>
__global__ void __launch_bounds__(PAGED ? PAGED_BLOCK : BLOCK)
bvh4_traverse_kernel(const Args a) {
    // paged: the resident nodes' words, then their links
    extern __shared__ uint4 smem[];
    const uint4* res_nodes = static_cast<const uint4*>(a.nodes);
    const int4* res_links = a.links;
    if constexpr (PAGED) {
        const int nw = a.s_res * node_words<ENC>();
        for (int k = threadIdx.x; k < nw; k += blockDim.x)
            smem[k] = __ldg(static_cast<const uint4*>(a.nodes) + k);
        for (int k = threadIdx.x; k < a.s_res; k += blockDim.x)
            smem[nw + k] = __ldg(reinterpret_cast<const uint4*>(a.links) + k);
        __syncthreads();
        res_nodes = smem;
        res_links = reinterpret_cast<const int4*>(smem + nw);
    }
    const int w_count = a.num_wide;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const Ray r = load_ray(a.o, a.d, i);
        const float ix = inv_dir(r.dx), iy = inv_dir(r.dy), iz = inv_dir(r.dz);
        Shear s{};
        if (ALGO == 1) s = make_shear(r);
        float best_t = HAS_TMAX ? a.t_max[i] : T_FAR;
        int best_i = 0;
        int pops = 1, leaves = 0, paged = 0;
        Stack stack;

        // Visits wide node ``node``: pushes its hit children far-first but
        // for the nearest, and returns the nearest (the entry the
        // reference pops next), else the next stack entry, else -1 (the
        // walk is over).
        auto visit = [&](int node) -> int {
            float lo[4][3], hi[4][3];
            int4 lk;
            if (!PAGED) {
                load_boxes<ENC, true>(res_nodes, node, lo, hi);
                lk = __ldg(res_links + node);
            } else if (node < a.s_res) {
                load_boxes<ENC, false>(res_nodes, node, lo, hi);
                lk = res_links[node];
            } else {
                if (COUNT) ++paged;
                load_boxes<0, true>(reinterpret_cast<const uint4*>(a.pboxes), node - a.s_res,
                                    lo, hi);
                lk = __ldg(a.plinks + (node - a.s_res));
            }
            float e[4];
            int l[4] = {lk.x, lk.y, lk.z, lk.w};
#pragma unroll
            for (int c = 0; c < 4; ++c)
                e[c] = slab(lo[c][0], lo[c][1], lo[c][2], hi[c][0], hi[c][1], hi[c][2], r, ix,
                            iy, iz, best_t);
            exchange<0, 1>(e, l);
            exchange<2, 3>(e, l);
            exchange<0, 2>(e, l);
            exchange<1, 3>(e, l);
            exchange<1, 2>(e, l);
            int near = -1;
#pragma unroll
            for (int k = 3; k >= 0; --k)  // far first; the nearest is kept
                if (e[k] < T_FAR) {
                    if (near >= 0) stack.push(near);
                    near = l[k];
                }
            if (near < 0) {
                if (stack.empty()) return -1;
                near = stack.pop();
            }
            if (COUNT) ++pops;
            return near;
        };

        int node = a.start ? __ldg(a.start + i) : 0;
        while (true) {
            while (node >= 0 && node < w_count) node = visit(node);
            if (node < 0) break;
            if (COUNT) ++leaves;
            if (leaf_test<ALGO, ANY_HIT>(a.slots, node - w_count, a.leaf_size, r, s, best_t,
                                         best_i) && ANY_HIT)
                break;
            if (stack.empty()) break;
            node = stack.pop();
            if (COUNT) ++pops;
        }
        a.out_t[i] = best_t;
        a.out_i[i] = best_i;
        if (COUNT) {
            a.counts[3 * i] = pops;
            a.counts[3 * i + 1] = leaves;
            a.counts[3 * i + 2] = paged;
        }
    }
}

template <int ALGO, bool HT, bool AH, int ENC, bool PG, bool CNT>
int launch(const Args& a, cudaStream_t st) {
    auto kernel = bvh4_traverse_kernel<ALGO, HT, AH, ENC, PG, CNT>;
    if constexpr (!PG) {
        if (a.query) {
            a.query[1] = 0;
            return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.query, kernel, BLOCK, 0);
        }
        const unsigned grid = (unsigned)((a.n + BLOCK - 1) / BLOCK);
        kernel<<<grid, BLOCK, 0, st>>>(a);
        return (int)cudaGetLastError();
    } else {
        const size_t bytes = (size_t)a.s_res * (node_words<ENC>() + 1) * sizeof(uint4);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        int dev = 0, sms = 0, per_sm = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PAGED_BLOCK, bytes);
        if (err != cudaSuccess) return (int)err;
        if (a.query) {
            a.query[0] = per_sm;
            a.query[1] = (int)bytes;
            return 0;
        }
        if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
        const int64_t need = (a.n + PAGED_BLOCK - 1) / PAGED_BLOCK;
        const unsigned grid = (unsigned)(need < (int64_t)per_sm * sms ? need : (int64_t)per_sm * sms);
        kernel<<<grid, PAGED_BLOCK, bytes, st>>>(a);
        return (int)cudaGetLastError();
    }
}

template <int ALGO, bool HT, bool AH, int ENC, bool PG>
int with_count(const Args& a, cudaStream_t st) {
    return a.counts ? launch<ALGO, HT, AH, ENC, PG, true>(a, st)
                    : launch<ALGO, HT, AH, ENC, PG, false>(a, st);
}

template <int ALGO, bool HT, bool AH, int ENC>
int with_paged(const Args& a, cudaStream_t st) {
    return a.s_res > 0 ? with_count<ALGO, HT, AH, ENC, true>(a, st)
                       : with_count<ALGO, HT, AH, ENC, false>(a, st);
}

template <int ALGO, bool HT, bool AH>
int with_enc(const Args& a, int enc, cudaStream_t st) {
    return enc ? with_paged<ALGO, HT, AH, 1>(a, st) : with_paged<ALGO, HT, AH, 0>(a, st);
}

template <int ALGO>
int with_rays(const Args& a, int enc, int any_hit, cudaStream_t st) {
    if (a.t_max != nullptr)
        return any_hit ? with_enc<ALGO, true, true>(a, enc, st)
                       : with_enc<ALGO, true, false>(a, enc, st);
    return any_hit ? with_enc<ALGO, false, true>(a, enc, st)
                   : with_enc<ALGO, false, false>(a, enc, st);
}

}  // namespace

// o, d: (n, 3) f32; t_max: (n,) f32 or null; start: (n,) i32 start links in
// [0, num_wide + C) or null (the root); nodes: (R, 24) f32 (enc 0) or
// (R, 12) u32 bf16 pairs (enc 1); links: (R, 4) i32 (wide id, or
// num_wide + leaf id); pboxes / plinks: (num_wide - s_res, 24) f32 and
// (num_wide - s_res, 4) i32 when s_res > 0 (paged: R == s_res), else
// unused (R == num_wide); slots: (C * leaf_size, 10) f32 rows, corners a,
// b, c and the triangle id's bits; algo 0 = Moller-Trumbore, 1 =
// watertight; counts: (n, 3) i32 pops / leaf tests / paged visits, or null.
// Outputs best_t (n,) f32 and best_i (n,) i32. 3 * wide_depth + 2 must not
// exceed TERRA_STACK_CAP and s_res resident nodes must fit a block's shared
// memory (both checked by the wrapper). Returns 0 or a cudaError_t code.
extern "C" int terra_bvh4_raycast(const float* o, const float* d, const float* t_max,
                                  const int32_t* start, const void* nodes,
                                  const int32_t* links, const float* pboxes,
                                  const int32_t* plinks, const float* slots, int64_t n,
                                  int num_wide, int s_res, int leaf_size, int enc, int algo,
                                  int any_hit, float* out_t, int32_t* out_i, int32_t* counts,
                                  void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const Args a{o, d, t_max, start, nodes, reinterpret_cast<const int4*>(links),
                 reinterpret_cast<const float4*>(pboxes), reinterpret_cast<const int4*>(plinks),
                 reinterpret_cast<const float2*>(slots), n, num_wide, s_res, leaf_size, out_t,
                 out_i, counts, nullptr};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    return algo == 0 ? with_rays<0>(a, enc, any_hit, st) : with_rays<1>(a, enc, any_hit, st);
}

// Blocks per SM (out[0]) and dynamic shared memory bytes per block (out[1])
// of the instance terra_bvh4_raycast would launch for these options, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; launches nothing.
// Returns 0 or a cudaError_t code.
extern "C" int terra_bvh4_query(int has_tmax, int any_hit, int enc, int s_res, int count,
                                int algo, int* out) {
    static const float t_flag = 0.0f;
    static int32_t count_flag = 0;
    Args a{};
    a.t_max = has_tmax ? &t_flag : nullptr;  // selects the instance only
    a.counts = count ? &count_flag : nullptr;
    a.n = 1;
    a.s_res = s_res;
    a.query = out;
    return algo == 0 ? with_rays<0>(a, enc, any_hit, nullptr)
                     : with_rays<1>(a, enc, any_hit, nullptr);
}
