// The Mosaic pattern probes, written for Hopper (sm_90a): one kernel per
// pallas_call site of the reference's probe scripts, one block of 8 warps.
//
// Replaces the six Pallas TPU kernels of
//   scripts/smem_dma_probe.py        probe_hbm_to_smem (:22, call :34),
//                                    probe_hbm_to_smem_i32_loop (:50, call :73),
//                                    probe_smem_dma_in_while (:93, call :111);
//   scripts/rowmask_patterns_probe.py _run (:31, call :32) with the bodies
//                                    of probe1 (:41), probe2 (:66), probe3 (:95),
//                                    and the inline kernel of probe4 (:123,
//                                    call :152);
//   scripts/paged_patterns_probe.py  _run (:24, call :25) with the bodies of
//                                    probe1 (:34) ... probe4 (:100).
// On the TPU these asked whether Mosaic compiles the patterns the paged
// traversal and the row-masked leaf test need. Here each kernel asks the
// same of Hopper, with one instruction for each TPU pattern:
//   * pltpu.make_async_copy(...).start() / .wait() into SMEM/VMEM scratch:
//     one thread arms an mbarrier with the byte count
//     (mbarrier.arrive.expect_tx) and issues the 1-D TMA bulk copy
//     cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes into
//     a 128-byte-aligned shared buffer; every thread waits on the barrier's
//     phase parity (mbarrier.try_wait.parity). A launch without clusters is
//     a cluster of one, so the shared::cluster destination is this block's.
//     Inside a loop the parity flips with every completed copy (wait on
//     iteration & 1), and a __syncthreads() plus an async-proxy fence come
//     before a copy that overwrites a buffer the threads have just read
//     (write after read across the generic and async proxies).
//   * scalar reads of SMEM scratch: shared-memory reads by every thread
//     (broadcast); the trip count of the i32 loop comes from the staged
//     words, as on the TPU.
//   * jnp.min over a (128,) row: a warp reduction with __shfl_xor_sync.
//   * row-activity bits: __ballot_sync per row, folded into an 8-bit word
//     in shared memory with atomicOr.
//   * pl.when row stores: per-row predicated stores after the output row is
//     zeroed, as the reference zeroes it.
//   * pl.run_scoped(SMEM((8,), int32)): a __shared__ int[8] stack.
// Warp r owns output row r; lane l covers columns l, l+32, l+64, l+96.
//
// Bound: each kernel moves at most 8 KiB (the staged rows in, one (8, 128)
// block out), a few nanoseconds at 3.35 TB/s, and does a few thousand
// operations; its time on the card is the launch and the round trip of the
// bulk copy, nothing the design can move. The probes answer "does it
// compile and give the right words", not "how fast".
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC -Xptxas -v
// Every value is an integer below 2^24 (or 1e9 plus one), exact in f32, so
// the kernels and their plain PyTorch versions (terra_tpu_torch/probes.py)
// agree word for word. Each launch goes on the caller's stream, never
// synchronises and allocates nothing; the C functions return
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 128;      // lanes of a row
constexpr int ROWS = 8;     // rows of the output block
constexpr int BLOCK = 256;  // 8 warps, one per output row
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises the barrier for one arrival; the fence makes the
// initialisation visible to the async proxy before any copy signals it.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// The make_async_copy(...).start(): thread 0 arms the barrier for ``bytes``
// and starts the bulk copy global -> shared. ``bytes`` is a multiple of 16,
// both addresses are 16-byte aligned (the wrappers check the input).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
    }
}

// The .wait(): every thread spins until the phase of parity ``parity``
// completes, i.e. the copy's bytes have landed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            " .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// min over a 128-wide shared row; every lane of the warp gets it.
__device__ __forceinline__ float row_min(const float* row) {
    const int lane = threadIdx.x & 31;
    float v = row[lane];
    for (int c = lane + 32; c < W; c += 32) v = fminf(v, row[c]);
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// Does any of row ``row``'s 128 lanes pass ``pred``? One ballot per
// 32-column chunk, the same answer in every lane.
template <typename Pred>
__device__ __forceinline__ bool row_any(const float* row, Pred pred) {
    const int lane = threadIdx.x & 31;
    unsigned any = 0;
    for (int c = lane; c < W; c += 32) any |= __ballot_sync(FULL, pred(row[c]));
    return any != 0;
}

template <typename T>
__device__ __forceinline__ void fill(T* __restrict__ out, T v) {
    for (int i = threadIdx.x; i < ROWS * W; i += BLOCK) out[i] = v;
}

}  // namespace

// probe_hbm_to_smem: rows 2-3 of x (64, 128) f32 into (2, 128) scratch;
// out = scr[0,0] + scr[1,1] + scr[0,127] everywhere.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_hbm_to_smem_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float scr[2][W];
    __shared__ uint64_t bar;
    barrier_init(&bar);
    bulk_load(scr, x + 2 * W, sizeof(scr), &bar);
    barrier_wait(&bar, 0);
    fill(out, scr[0][0] + scr[1][1] + scr[0][W - 1]);
}

// probe_hbm_to_smem_i32_loop: rows 0-3 of x (8, 128) i32 into (4, 128)
// scratch; n = scr[0,0]; acc = sum over i < n of scr[i % 4, i] (i < 128).
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_hbm_to_smem_i32_loop_kernel(const int32_t* __restrict__ x,
                                        int32_t* __restrict__ out) {
    __shared__ __align__(128) int32_t scr[4][W];
    __shared__ uint64_t bar;
    barrier_init(&bar);
    bulk_load(scr, x, sizeof(scr), &bar);
    barrier_wait(&bar, 0);
    const int32_t n = scr[0][0];
    int32_t acc = 0;
    for (int32_t i = 0; i < n && i < W; ++i) acc += scr[i % 4][i];
    fill(out, acc);
}

// probe_smem_dma_in_while: four iterations, each copies row i of x (8, 128)
// f32 into a (1, 128) scratch and adds scr[0, 0].
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_smem_dma_in_while_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float scr[W];
    __shared__ uint64_t bar;
    barrier_init(&bar);
    float acc = 0.0f;
    for (int i = 0; i < 4; ++i) {
        if (i > 0) __syncthreads();  // every thread has read scr before it is overwritten
        bulk_load(scr, x + i * W, sizeof(scr), &bar);
        barrier_wait(&bar, i & 1);
        acc += scr[0];
    }
    fill(out, acc);
}

// rowmask _run: rows 0-7 of x (16, 128) f32 into (8, 128) scratch, then
//   probe 1: out[r] = 2 x[r] where bit r of 0b10100110 is set, else 0;
//   probe 2: out[r, j] = min_k (x[k, r] x[r, j] + x[k, r]);
//   probe 3: out[r] = 1 where any x[r, :] > 700, else 0.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_rowmask_kernel(const float* __restrict__ x, float* __restrict__ out, int probe) {
    __shared__ __align__(128) float scr[ROWS][W];
    __shared__ uint64_t bar;
    __shared__ uint32_t bits;
    if (threadIdx.x == 0) bits = 0;
    barrier_init(&bar);
    bulk_load(scr, x, sizeof(scr), &bar);
    barrier_wait(&bar, 0);
    const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* orow = out + r * W;
    if (probe == 2) {
        for (int c = lane; c < W; c += 32) {
            float m = scr[0][r] * scr[r][c] + scr[0][r];
            for (int k = 1; k < ROWS; ++k) m = fminf(m, scr[k][r] * scr[r][c] + scr[k][r]);
            orow[c] = m;
        }
        return;
    }
    uint32_t row_bits = 0b10100110u;
    if (probe == 3) {
        if (row_any(scr[r], [](float v) { return v > 700.0f; }) && lane == 0)
            atomicOr(&bits, 1u << r);
        __syncthreads();
        row_bits = bits;
    }
    for (int c = lane; c < W; c += 32) orow[c] = 0.0f;
    if ((row_bits >> r) & 1u)
        for (int c = lane; c < W; c += 32) orow[c] = probe == 1 ? scr[r][c] * 2.0f : 1.0f;
}

// rowmask probe4: rows 0-7 of x (16, 128) f32; three mask planes
// m_s = where(x > 600 + 100 s, x, 1e9) stored into a (4, 8, 128) scratch in
// a loop, then out[r] = sum of m_s[r] over the planes whose row r has a lane
// below 1e9 (planes added in order 0, 1, 2).
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_rowmask_planes_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float plane[ROWS][W];
    __shared__ float mask[4][ROWS][W];
    __shared__ uint64_t bar;
    __shared__ uint32_t bits[3];
    if (threadIdx.x < 3) bits[threadIdx.x] = 0;
    barrier_init(&bar);
    bulk_load(plane, x, sizeof(plane), &bar);
    barrier_wait(&bar, 0);
    const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int s = 0; s < 3; ++s) {
        const float thr = 600.0f + 100.0f * static_cast<float>(s);
        for (int c = lane; c < W; c += 32) {
            const float v = plane[r][c];
            mask[s][r][c] = v > thr ? v : 1e9f;
        }
    }
    __syncthreads();
    for (int s = 0; s < 3; ++s)
        if (row_any(mask[s][r], [](float v) { return v < 1e9f; }) && lane == 0)
            atomicOr(&bits[s], 1u << r);
    __syncthreads();
    float* orow = out + r * W;
    for (int c = lane; c < W; c += 32) orow[c] = 0.0f;
    for (int s = 0; s < 3; ++s)
        if ((bits[s] >> r) & 1u)
            for (int c = lane; c < W; c += 32) orow[c] = orow[c] + mask[s][r][c];
}

// paged _run: three iterations, each copies rows 4i..4i+3 of x (16, 128)
// f32 into (4, 128) scratch, then adds
//   probe 1: min(row 1);  probe 2: scr[1, 3];  probe 3: min(row 2);
//   probe 4: link = int(min(row 2)); where link > 4 it is pushed onto an
//            8-entry shared stack at slot i and the slot is read back, else 0.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_paged_kernel(const float* __restrict__ x, float* __restrict__ out, int probe) {
    __shared__ __align__(128) float scr[4][W];
    __shared__ uint64_t bar;
    __shared__ int32_t stack[8];
    barrier_init(&bar);
    float acc = 0.0f;
    for (int i = 0; i < 3; ++i) {
        if (i > 0) __syncthreads();  // every thread has read scr before it is overwritten
        bulk_load(scr, x + 4 * W * i, sizeof(scr), &bar);
        barrier_wait(&bar, i & 1);
        float s;
        if (probe == 1) {
            s = row_min(scr[1]);
        } else if (probe == 2) {
            s = scr[1][3];
        } else if (probe == 3) {
            s = row_min(scr[2]);
        } else {
            const int32_t link = static_cast<int32_t>(row_min(scr[2]));
            const bool push = link > 4;
            if (push && threadIdx.x == 0) stack[i] = link;
            __syncthreads();
            s = static_cast<float>(push ? stack[i] : 0);
        }
        acc += s;
    }
    fill(out, acc);
}

// Launchers: x and out are the device pointers of the wrappers' checked
// tensors; ``probe`` selects the body where one site serves several.
extern "C" int terra_probe_hbm_to_smem(const float* x, float* out, void* stream) {
    terra_probe_hbm_to_smem_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_hbm_to_smem_i32_loop(const int32_t* x, int32_t* out, void* stream) {
    terra_probe_hbm_to_smem_i32_loop_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_smem_dma_in_while(const float* x, float* out, void* stream) {
    terra_probe_smem_dma_in_while_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_rowmask(const float* x, float* out, int probe, void* stream) {
    terra_probe_rowmask_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(x, out, probe);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_rowmask_planes(const float* x, float* out, void* stream) {
    terra_probe_rowmask_planes_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_paged(const float* x, float* out, int probe, void* stream) {
    terra_probe_paged_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(x, out, probe);
    return static_cast<int>(cudaGetLastError());
}
