// The Mosaic pattern probes, written for Hopper (sm_90a): one kernel per
// pallas_call site of the reference's probe scripts.
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
//     a 128-byte-aligned shared buffer; the threads that read it wait on the
//     barrier's phase parity (mbarrier.try_wait.parity). A launch without
//     clusters is a cluster of one, so the shared::cluster destination is
//     this block's. A barrier's parity flips with every completed copy; a
//     copy that overwrites a buffer the threads have read comes after a
//     barrier over those threads and an async-proxy fence (write after read
//     across the generic and async proxies).
//   * scalar reads of SMEM scratch: shared-memory reads by every thread
//     (broadcast); the trip count of the i32 loop comes from the staged
//     words, as on the TPU, and stops at the row's 128 words (past them
//     the TPU's read is out of bounds).
//   * jnp.min over a (128,) row: a warp reduction with __shfl_xor_sync.
//   * row-activity bits: __ballot_sync per row.
//   * pl.when row stores: per-row stores whose value the row's bit selects.
//   * pl.run_scoped(SMEM((8,), int32)): a __shared__ int[8] stack.
//
// Bound: each kernel moves at most 8 KiB (the staged rows in, one (8, 128)
// block out), 1.5-3.1 ns at 3.35 TB/s, and does at most ~25k operations.
// Its time on the card is the launch plus the copy round trips it leaves
// exposed and the synchronisation around them. On the H100 the launch of
// terra_probe_empty (same block, no work) takes 1.6-2.0 us back to back and
// one exposed round trip ~0.2 us (chip_smoke.py phase 5): the design can
// only cut the round trips, the block-wide synchronisation and the
// instructions around them.
//
// Every kernel is designed for Hopper:
//   * terra_probe_hbm_to_smem_kernel and
//     terra_probe_hbm_to_smem_i32_loop_kernel: one warp and one copy
//     (warp_load): lane 0 initialises the barrier and issues the copy into
//     a buffer nothing has touched, so no proxy fence comes first, and no
//     block barrier; every lane waits on parity 0 and reads the staged
//     words as broadcasts. The i32 loop's trip count n = scr[0, 0] still
//     gates which words are summed, but lane l sums only the four words
//     scr[i % 4, i] for i = l, l + 32, l + 64, l + 96 below n, and the warp
//     adds the 32 partial sums (__reduce_add_sync): int32 addition wraps
//     in two's complement and is associative, so every order gives the
//     serial loop's bits, without its chain of up to 128 dependent shared
//     loads and adds. The output is written as 16-byte stores (fill4).
//   * terra_probe_paged_kernel and terra_probe_smem_dma_in_while_kernel:
//     one warp (the body is one scalar a page or a row) and a ring of two
//     buffers with one mbarrier each (ring_top_up, ring_wait). Inside the
//     loop, before piece i is read, the ring is topped up with piece i + 1,
//     so the next copy is in flight while piece i is waited on and read.
//     Pieces 2 and 3 go into the buffers pieces 0 and 1 left: a __syncwarp
//     (every lane has read it) and the async-proxy fence come first, and
//     the wait is on the barrier's second completion (parity 1), the
//     pattern a paged walk with more pages than buffers runs. So the
//     dma-in-while kernel leaves about two of its four copy round trips
//     exposed instead of four. The trip loop is unrolled: compiled as a
//     loop (piece, buffer and parity in registers, the top-up a loop of its
//     own) the same ring read 0.25-0.32 us a launch slower on the H100, no
//     faster than four serial copies. Three buffers for the paged kernel
//     (every copy issued on the first trip, none reused) read 0.08-0.18 us
//     a launch faster than the ring as a loop on three of its four bodies,
//     but never reuse a buffer, so the ring stays at two (PERF.md).
//     Row minima take one 16-byte shared read a lane and five shuffles; the
//     stack push of paged probe 4 is ordered by __syncwarp; the output is
//     written as 16-byte stores.
//   * terra_probe_rowmask_kernel and terra_probe_rowmask_planes_kernel:
//     warp r computes output row r from what it stages itself. Row-mask
//     probes 1 and 3 and the mask planes read only row r: the warp's lane 0
//     arms the warp's own barrier and copies that row (probe 1 copies only
//     the rows its bits select), so no warp waits for another and nothing
//     is shared across warps; a row bit is the warp's own ballot. The mask
//     planes are saved to the warp's row of the (4, 8, 128) scratch at slot
//     s in a loop and read back behind __syncwarp, each output row summed
//     in registers in the reference's order. Probe 2 reads column r of
//     every row, so it waits for the whole block: one 4 KiB copy on one
//     barrier (a copy and a barrier a row, every warp waiting on all eight,
//     read 0.13-0.26 us a launch slower on the H100). Every output word is
//     written once, by a 16-byte store of the selected value.
// Device time on the H100 (PERF.md §6; 200 launches back to back, chip_smoke.py
// phase 5 and scripts/probe_ab.py): each kernel 2.0-2.9 us a launch against
// an empty kernel's 1.6-1.9, which moves up to 0.25 us from call to call.
// In one call against the block-wide designs they replace, the ring cut
// dma-in-while by 0.38 us and the per-warp rows the mask planes by 0.37;
// one warp cut the i32 loop by 0.27 us at 5 trips and 0.76 at 128 (the
// serial loop's chain), hbm_to_smem by 0.15, and the straight-line fill4
// every kernel that stores through it by 0.05-0.17.
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
constexpr int PAGE_ROWS = 4, PAGES = 3;  // the paged probes' (4, 128) pages
constexpr int DMA_TRIPS = 4;  // rows the dma-in-while probe copies, one a trip
constexpr int RING = 2;     // buffers of a one-warp ring (the paged and dma-in-while kernels)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise a barrier for one arrival (by the calling thread); the fence
// makes the initialisation visible to the async proxy before a copy
// signals it. The caller makes it visible to the other threads.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The make_async_copy(...).start() by the calling thread: arm the barrier
// for ``bytes`` and start the bulk copy global -> shared. ``bytes`` is a
// multiple of 16, both addresses are 16-byte aligned (the wrappers check
// the input).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Generic-proxy accesses of shared memory before async-proxy ones after.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The .wait(): spin until the phase of parity ``parity`` completes, i.e.
// the copy's bytes have landed.
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

// One copy that one warp waits on, on the warp's own barrier: lane 0
// initialises the barrier and copies into a buffer nothing has touched (so
// no proxy fence), the __syncwarp orders the initialisation before any
// lane's wait. No other warp takes part.
__device__ __forceinline__ void warp_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    if ((threadIdx.x & 31) == 0) {
        mbar_init(bar);
        bulk_copy(dst, src, bytes, bar);
    }
    __syncwarp();
    barrier_wait(bar, 0);
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// min over a 128-wide shared row from one 16-byte read a lane (columns
// 4l .. 4l+3); every lane of the warp gets it.
__device__ __forceinline__ float row_min4(const float* row) {
    const float4 v = reinterpret_cast<const float4*>(row)[threadIdx.x & 31];
    return warp_min(fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int32_t> { using type = int4; };

// The (8, 128) block set to ``v`` by one warp, 16 bytes a store: eight
// stores a lane, straight-line (as a loop from the lane's index the
// compiler keeps a trip counter, remainder branches and four copies of v).
template <typename T>
__device__ __forceinline__ void fill4(T* __restrict__ out, T v) {
    using V = typename Vec4<T>::type;
    V* o = reinterpret_cast<V*>(out) + (threadIdx.x & 31);
#pragma unroll
    for (int k = 0; k < ROWS * W / 4 / 32; ++k) o[32 * k] = V{v, v, v, v};
}

// A ring of RING shared buffers through which one warp streams ``items``
// consecutive pieces of x, LEN floats each: piece k lands in buf[k % RING],
// its copy the (k / RING)-th completion of that buffer's barrier. Called
// before piece i is read, ring_top_up has lane 0 issue every piece up to
// i + 1, so the next piece's copy is in flight while piece i is waited on
// and read; a buffer is refilled only behind a __syncwarp (every lane has
// read the piece it held) and the async-proxy fence. ring_wait waits for
// piece i and returns its buffer.
__device__ __forceinline__ void ring_init(uint64_t (&full)[RING], int lane) {
    if (lane == 0)
        for (int b = 0; b < RING; ++b) mbar_init(&full[b]);
    __syncwarp();  // the barriers initialised before any lane waits
}

template <int LEN>
__device__ __forceinline__ void ring_top_up(float (&buf)[RING][LEN], uint64_t (&full)[RING],
                                            const float* x, int items, int i, int& issued,
                                            int lane) {
    for (; issued < items && issued <= i + 1; ++issued) {
        const int b = issued % RING;
        if (issued >= RING) {  // buffer b held piece issued - RING, read at an earlier trip
            __syncwarp();
            if (lane == 0) fence_proxy_async();
        }
        if (lane == 0) bulk_copy(buf[b], x + issued * LEN, sizeof(buf[b]), &full[b]);
    }
}

template <int LEN>
__device__ __forceinline__ const float* ring_wait(float (&buf)[RING][LEN],
                                                  uint64_t (&full)[RING], int i) {
    barrier_wait(&full[i % RING], (i / RING) & 1);
    return buf[i % RING];
}

}  // namespace

// probe_hbm_to_smem: rows 2-3 of x (64, 128) f32 into (2, 128) scratch;
// out = scr[0,0] + scr[1,1] + scr[0,127] everywhere. One warp.
extern "C" __global__ void __launch_bounds__(32)
terra_probe_hbm_to_smem_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float scr[2][W];
    __shared__ uint64_t bar;
    warp_load(scr, x + 2 * W, sizeof(scr), &bar);
    fill4(out, scr[0][0] + scr[1][1] + scr[0][W - 1]);
}

// probe_hbm_to_smem_i32_loop: rows 0-3 of x (8, 128) i32 into (4, 128)
// scratch; n = scr[0,0]; acc = sum over i < n of scr[i % 4, i] (i < 128).
// One warp; lane l takes i = l + 32 k (row l % 4), then a warp sum.
extern "C" __global__ void __launch_bounds__(32)
terra_probe_hbm_to_smem_i32_loop_kernel(const int32_t* __restrict__ x,
                                        int32_t* __restrict__ out) {
    __shared__ __align__(128) int32_t scr[4][W];
    __shared__ uint64_t bar;
    const int lane = threadIdx.x;
    warp_load(scr, x, sizeof(scr), &bar);
    const int32_t n = scr[0][0];
    int32_t acc = 0;
#pragma unroll
    for (int k = 0; k < W / 32; ++k) {
        const int i = lane + 32 * k;
        const int32_t v = scr[lane & 3][i];  // i % 4 == lane % 4
        acc += i < n ? v : 0;
    }
    fill4(out, __reduce_add_sync(FULL, acc));
}

// probe_smem_dma_in_while: four iterations, each copies row i of x (8, 128)
// f32 into a (1, 128) scratch and adds scr[0, 0]. One warp; row i sits in
// buffer i % RING of a ring of row buffers.
extern "C" __global__ void __launch_bounds__(32)
terra_probe_smem_dma_in_while_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float row[RING][W];
    __shared__ uint64_t full[RING];
    const int lane = threadIdx.x;
    ring_init(full, lane);
    float acc = 0.0f;
    int issued = 0;
#pragma unroll  // straight-line code; as a loop the ring is ~0.3 us slower (source note)
    for (int i = 0; i < DMA_TRIPS; ++i) {
        ring_top_up(row, full, x, DMA_TRIPS, i, issued, lane);
        acc += ring_wait(row, full, i)[0];
    }
    fill4(out, acc);
}

// rowmask _run: rows 0-7 of x (16, 128) f32 staged in (8, 128) scratch, then
//   probe 1: out[r] = 2 x[r] where bit r of 0b10100110 is set, else 0;
//   probe 2: out[r, j] = min_k (x[k, r] x[r, j] + x[k, r]);
//   probe 3: out[r] = 1 where any x[r, :] > 700, else 0.
// Warp r writes row r; lane l columns 4l .. 4l+3.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_rowmask_kernel(const float* __restrict__ x, float* __restrict__ out, int probe) {
    __shared__ __align__(128) float scr[ROWS][W];
    __shared__ uint64_t bar[ROWS];
    const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float4* orow = reinterpret_cast<float4*>(out + r * W);
    if (probe == 2) {
        if (threadIdx.x == 0) {
            mbar_init(&bar[0]);
            bulk_copy(scr, x, sizeof(scr), &bar[0]);
        }
        __syncthreads();  // the barrier initialised before any warp waits on it
        barrier_wait(&bar[0], 0);
        const float4 v = reinterpret_cast<const float4*>(scr[r])[lane];
        float c = scr[0][r];
        float4 m = make_float4(c * v.x + c, c * v.y + c, c * v.z + c, c * v.w + c);
        for (int k = 1; k < ROWS; ++k) {
            c = scr[k][r];
            m = make_float4(fminf(m.x, c * v.x + c), fminf(m.y, c * v.y + c),
                            fminf(m.z, c * v.z + c), fminf(m.w, c * v.w + c));
        }
        orow[lane] = m;
        return;
    }
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (probe == 3 || ((0b10100110u >> r) & 1u)) {  // the rows this body reads
        if (lane == 0) {
            mbar_init(&bar[r]);
            bulk_copy(scr[r], x + r * W, sizeof(scr[r]), &bar[r]);
        }
        __syncwarp();  // the warp's barrier initialised before its lanes wait
        barrier_wait(&bar[r], 0);
        const float4 v = reinterpret_cast<const float4*>(scr[r])[lane];
        if (probe == 1) {
            o = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
        } else {
            const bool hit = v.x > 700.0f || v.y > 700.0f || v.z > 700.0f || v.w > 700.0f;
            const float f = __ballot_sync(FULL, hit) ? 1.0f : 0.0f;
            o = make_float4(f, f, f, f);
        }
    }
    orow[lane] = o;
}

// rowmask probe4: rows 0-7 of x (16, 128) f32; three mask planes
// m_s = where(x > 600 + 100 s, x, 1e9) stored into a (4, 8, 128) scratch in
// a loop, then out[r] = sum of m_s[r] over the planes whose row r has a lane
// below 1e9 (planes added to 0 in order 0, 1, 2). Row r of every plane
// depends on row r of x alone, so warp r stages that row on its own
// barrier, saves its row of each plane and reads it back, and takes the
// row bit as its own ballot; lane l holds columns 4l .. 4l+3.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_rowmask_planes_kernel(const float* __restrict__ x, float* __restrict__ out) {
    __shared__ __align__(128) float plane[ROWS][W];
    __shared__ float4 mask[4][ROWS][W / 4];
    __shared__ uint64_t bar[ROWS];
    const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        mbar_init(&bar[r]);
        bulk_copy(plane[r], x + r * W, sizeof(plane[r]), &bar[r]);
    }
    __syncwarp();  // the warp's barrier initialised before its lanes wait
    barrier_wait(&bar[r], 0);
    const float4 v = reinterpret_cast<const float4*>(plane[r])[lane];
    for (int s = 0; s < 3; ++s) {
        const float t = 600.0f + 100.0f * static_cast<float>(s);
        mask[s][r][lane] = make_float4(v.x > t ? v.x : 1e9f, v.y > t ? v.y : 1e9f,
                                       v.z > t ? v.z : 1e9f, v.w > t ? v.w : 1e9f);
    }
    __syncwarp();  // the planes saved before the drain reads them back
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < 3; ++s) {
        const float4 m = mask[s][r][lane];
        const bool hit = m.x < 1e9f || m.y < 1e9f || m.z < 1e9f || m.w < 1e9f;
        if (__ballot_sync(FULL, hit))  // bit r of plane s
            o = make_float4(o.x + m.x, o.y + m.y, o.z + m.z, o.w + m.w);
    }
    reinterpret_cast<float4*>(out + r * W)[lane] = o;
}

// paged _run: three iterations, each stages rows 4i..4i+3 of x (16, 128)
// f32 (page i) in a (4, 128) buffer, then adds
//   probe 1: min(row 1);  probe 2: scr[1, 3];  probe 3: min(row 2);
//   probe 4: link = int(min(row 2)); where link > 4 it is pushed onto an
//            8-entry shared stack at slot i and the slot is read back, else 0.
// One warp; page i sits in buffer i % RING of a ring of page buffers.
extern "C" __global__ void __launch_bounds__(32)
terra_probe_paged_kernel(const float* __restrict__ x, float* __restrict__ out, int probe) {
    __shared__ __align__(128) float page[RING][PAGE_ROWS * W];
    __shared__ uint64_t full[RING];
    __shared__ int32_t stack[8];
    const int lane = threadIdx.x;
    ring_init(full, lane);
    float acc = 0.0f;
    int issued = 0;
#pragma unroll  // straight-line code; as a loop the ring is ~0.3 us slower (source note)
    for (int i = 0; i < PAGES; ++i) {
        ring_top_up(page, full, x, PAGES, i, issued, lane);  // pages i and i + 1 in flight
        const float* scr = ring_wait(page, full, i);
        float s;
        if (probe == 1) {
            s = row_min4(scr + W);
        } else if (probe == 2) {
            s = scr[W + 3];
        } else if (probe == 3) {
            s = row_min4(scr + 2 * W);
        } else {
            const int32_t link = static_cast<int32_t>(row_min4(scr + 2 * W));
            const bool push = link > 4;
            if (push && lane == 0) stack[i] = link;
            __syncwarp();  // the push before the read-back
            s = static_cast<float>(push ? stack[i] : 0);
        }
        acc += s;
    }
    fill4(out, acc);
}

// The launch floor: a probe's launch shape (one block of ``block`` threads,
// 256, or 32 for the one-warp kernels; the same arguments) and no work.
// Replaces no TPU kernel; chip_smoke.py times it beside the probes.
extern "C" __global__ void __launch_bounds__(BLOCK)
terra_probe_empty_kernel(const float* __restrict__, float* __restrict__) {}

// Launchers: x and out are the device pointers of the wrappers' checked
// tensors; ``probe`` selects the body where one site serves several.
extern "C" int terra_probe_hbm_to_smem(const float* x, float* out, void* stream) {
    terra_probe_hbm_to_smem_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_hbm_to_smem_i32_loop(const int32_t* x, int32_t* out, void* stream) {
    terra_probe_hbm_to_smem_i32_loop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_smem_dma_in_while(const float* x, float* out, void* stream) {
    terra_probe_smem_dma_in_while_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
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
    terra_probe_paged_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(x, out, probe);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int terra_probe_empty(const float* x, float* out, int block, void* stream) {
    terra_probe_empty_kernel<<<1, block, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
    return static_cast<int>(cudaGetLastError());
}
