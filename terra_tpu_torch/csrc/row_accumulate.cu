// The backward of a row gather out = table[idx]: a deterministic segmented
// sum of the gradient rows of the lanes that named each table row (sm_90a).
//
// Replaces no Pallas kernel. The JAX package gathers rows with jnp
// (terra_tpu/surface.py: fetch_rows's take, terra_tpu/textures.py: _read,
// terra_tpu/scene.py: Geometry.corners), and XLA's transpose of a gather is
// a scatter-add. PyTorch's counterpart in deterministic mode sorts the ids
// and gives each distinct row one warp that adds the row's duplicates one
// after another, so a row named by many lanes is a serial chain: every lane
// that missed gathers triangle row 0, hundreds of thousands of lanes a
// bounce in an outdoor view. This kernel turns such runs into parallel
// tiles and a fixed tree over them, with no atomics, so the bits repeat.
//
// The ids are sorted once (stable) by the wrapper (ops/row_accumulate.py),
// giving sorted keys and the lane permutation. One launch is one level:
//   - A block owns kTile consecutive sorted positions. It gathers their
//     gradient rows through the permutation into shared memory, a warp's
//     loads running along a row's columns, and runs a segmented
//     Hillis-Steele scan over the positions in each column: at offset
//     d = 1, 2, ..., 128, x[i] = x[i - d] + x[i] where position i - d holds
//     i's key. A run's sum is then the value at its last position. Offsets
//     below 32 cross lanes by shuffles; 32, 64 and 128 stay in a lane,
//     which holds positions lane, lane + 32, ..., lane + 224 of a column.
//   - A run wholly inside the tile has one writer: it is stored to its row
//     of the zeroed output as sum + 0.0f (a row reached only by -0.0 reads
//     +0.0, as a scatter-add into zeros gives). The tile's first run, if it
//     continues from the tile before, and its last, if it continues into
//     the tile after, are cut: their partial sums go to two slots of the
//     next level's input, (2 x tiles) keys and rows, which the wrapper
//     allocates at a size fixed by n; a slot that carries nothing has key
//     -1. A tile that is one run puts its sum in the first slot and 0 in
//     the second, under its key.
//   - The next level is the same kernel on the slots (no permutation), and
//     so on until one tile holds them all. A run cut over many tiles, such
//     as row 0's, is summed by the same fixed tree one level up.
// The plain version (ops/row_accumulate.py: row_accumulate_plain) runs the
// same levels with PyTorch ops and gives the same words.
//
// Bound (the 242k courtyard's triangle table at 384 x 384 x 8 lanes): the
// gradient read once, 1,179,648 x 26 f32 (122.7 MB), the int64 ids (9.4
// MB) and the (241,764 x 26) f32 table written (25.1 MB): 157 MB, 47 us at
// 3.35 TB/s. A level-0 tile reads 256 gathered rows (104 B each) and adds
// 8 x 26 values a position in shared memory and registers; the levels
// above read 2 x 26 floats a tile. Nothing is allocated here and nothing
// is read back; a launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // positions a block owns, one thread each
constexpr int kChunk = kTile / 32;  // positions a lane holds in a column
constexpr int kCols = 32;  // columns a block sums; blockIdx.y picks the group
constexpr int kWarps = kTile / 32;
constexpr int kLoads = 8;  // gathered loads a thread keeps in flight
constexpr int32_t kNone = -1;  // key past n, and of a slot that carries nothing
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kTile, 3)
level_kernel(const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
             const float* __restrict__ vals, int64_t n, int cols, int64_t rows,
             float* __restrict__ out, int32_t* __restrict__ next_keys,
             float* __restrict__ next_vals) {
    __shared__ float sx[kTile * (kCols + 1)];
    __shared__ int32_t skey[kTile + 2];  // [0]: the key before the tile; [kTile + 1]: after
    __shared__ int64_t srow[kTile];
    __shared__ unsigned char swrite[kTile];
    __shared__ int s_first_end;

    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int64_t start = static_cast<int64_t>(blockIdx.x) * kTile;
    const int c0 = blockIdx.y * kCols;
    const int cw = min(kCols, cols - c0);
    const int cp = cw | 1;  // odd pitch: a warp's column reads fall in 32 banks

    const int64_t p = start + t;
    skey[1 + t] = p < n ? keys[p] : kNone;
    srow[t] = p < n ? (perm != nullptr ? perm[p] : p) : -1;
    if (t == 0) skey[0] = start > 0 ? keys[start - 1] : kNone;
    if (t == 1) skey[kTile + 1] = start + kTile < n ? keys[start + kTile] : kNone;
    __syncthreads();

    // the tile's rows, element e = t + kTile j at (e / cw, e % cw): a warp's
    // loads run along a row; kLoads of a thread's loads are in flight at once
    for (int j0 = 0; j0 < cw; j0 += kLoads) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int e = t + kTile * (j0 + u);
            const int pos = e / cw, col = e - pos * cw;
            const int64_t row = j0 + u < cw ? srow[pos] : -1;
            v[u] = row >= 0 ? __ldg(vals + row * cols + c0 + col) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
            const int e = t + kTile * (j0 + u);
            const int pos = e / cw, col = e - pos * cw;
            if (j0 + u < cw) sx[pos * cp + col] = v[u];
        }
    }
    // bit 8 k + s of mask: position lane + 32 k and the one 2^s before it share a key
    uint64_t mask = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
        const int pos = lane + 32 * k;
        const int32_t key = skey[1 + pos];
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            const int d = 1 << s;
            if (pos >= d && skey[1 + pos - d] == key) mask |= 1ull << (8 * k + s);
        }
    }
    __syncthreads();

    for (int col = warp; col < cw; col += kWarps) {
        float r[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) r[k] = sx[(lane + 32 * k) * cp + col];
#pragma unroll
        for (int s = 0; s < 5; ++s) {  // offsets 1..16: position - d is in this chunk
            const int d = 1 << s;      // at lane - d, or in the one before at lane - d + 32
            float y[kChunk];
#pragma unroll
            for (int k = 0; k < kChunk; ++k) y[k] = __shfl_sync(kFull, r[k], (lane - d) & 31);
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                const float before = lane >= d ? y[k] : (k > 0 ? y[k - 1] : 0.0f);
                if ((mask >> (8 * k + s)) & 1u) r[k] = before + r[k];
            }
        }
#pragma unroll
        for (int s = 5; s < 8; ++s) {  // offsets 32, 64, 128: chunk k - j of this lane
            const int j = 1 << (s - 5);
#pragma unroll
            for (int k = kChunk - 1; k >= j; --k)
                if ((mask >> (8 * k + s)) & 1u) r[k] = r[k - j] + r[k];
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) sx[(lane + 32 * k) * cp + col] = r[k];
    }

    const int32_t first = skey[1], last = skey[kTile];
    {
        const int32_t key = skey[1 + t];
        const bool end = t == kTile - 1 || skey[2 + t] != key;
        const bool cut = (key == first && skey[0] == key) ||
                         (t == kTile - 1 && skey[kTile + 1] == key);
        swrite[t] = end && key >= 0 && key < rows && !cut;
        if (end && key >= 0 && key == first) s_first_end = t;
    }
    __syncthreads();

    for (int e = t; e < kTile * cw; e += kTile) {
        const int pos = e / cw, col = e - pos * cw;
        if (swrite[pos])
            out[static_cast<int64_t>(skey[1 + pos]) * cols + c0 + col] = sx[pos * cp + col] + 0.0f;
    }
    if (next_keys == nullptr) return;
    const bool head_cut = first >= 0 && (skey[0] == first ||
                                         (s_first_end == kTile - 1 && skey[kTile + 1] == first));
    const bool single = first == last;
    const bool tail_cut = !single && last >= 0 && skey[kTile + 1] == last;
    const int32_t head_key = head_cut ? first : kNone;
    const int64_t slot = 2 * static_cast<int64_t>(blockIdx.x);
    if (blockIdx.y == 0 && t == 0) {
        next_keys[slot] = head_key;
        next_keys[slot + 1] = single ? head_key : (tail_cut ? last : kNone);
    }
    for (int col = t; col < cw; col += kTile) {
        next_vals[slot * cols + c0 + col] = head_cut ? sx[s_first_end * cp + col] : 0.0f;
        next_vals[(slot + 1) * cols + c0 + col] = tail_cut ? sx[(kTile - 1) * cp + col] : 0.0f;
    }
}

}  // namespace

// One level over n sorted keys (int32) and their rows: perm (int64, n) maps
// position i to row perm[i] of vals, or is null for row i; vals is (*, cols)
// f32 row-major. Writes the runs that end in their tile to out (rows x cols,
// zeroed by the caller) and, when next_keys is not null, the cut runs'
// partial sums to next_keys (2 x tiles) and next_vals (2 x tiles, cols).
// Keys outside [0, rows) are never written. Returns cudaGetLastError().
extern "C" int terra_row_accumulate_level(const int32_t* keys, const int64_t* perm,
                                          const float* vals, int64_t n, int cols, int64_t rows,
                                          float* out, int32_t* next_keys, float* next_vals,
                                          void* stream) {
    if (n <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
    const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                    static_cast<unsigned>((cols + kCols - 1) / kCols));
    level_kernel<<<grid, kTile, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        keys, perm, vals, n, cols, rows, out, next_keys, next_vals);
    return static_cast<int>(cudaGetLastError());
}

// The tile a block owns (the plain version's tile size must equal it).
extern "C" int terra_row_accumulate_tile() { return kTile; }
