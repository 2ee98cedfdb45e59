// The backward of a row gather from a small table, out = table[idx], for
// Hopper (sm_90a): grad_table[r, :] = sum over lanes i with idx[i] == r of
// grad_out[i, :], in a fixed order.
//
// Replaces no TPU kernel: the JAX package leaves this gather's backward
// (a scatter-add) to XLA. It was added because PyTorch's own backward of
// table[idx], index_put_(accumulate=True), sorts the indices and then
// walks each run of equal indices serially: the renderer's tables hold 1
// to a few hundred rows (the emitters' radiance, the bsdf reflectances,
// a small mesh's vertices) and are read by 2^18 to 2^21 lanes, so a few
// runs of 10^5 to 10^6 duplicates are summed one element at a time.
//
// What bounds it: reading each lane's gradient and index once,
// N * (4 C + sizeof(index)) bytes (42 MB, 12.5 us at 3.35 TB/s for
// 2^21 lanes of 3 channels and int64 indices); the table's gradient is a
// few hundred floats. What the design does about the serialisation:
//
// * Pass 1 cuts the lanes into at most MAX_BLOCKS contiguous slices, one
//   a block. Each warp of a block keeps a private copy of the table's
//   gradient (rows * C floats) in shared memory and walks steps of
//   CHUNKS x 32 lanes of its block's slice, the chunks' loads in flight
//   together.
// * In each 32 lanes __match_any_sync groups the lanes of equal rows. A
//   tree over the ranks of each group (rank = the lane's place among its
//   group's lanes) sums each channel with shuffles in log2(32) steps; the
//   group's lowest lane adds the sum to its warp's copy. Leaders have
//   distinct rows, so no two lanes write one address at once, and the
//   chunks' leaders write in chunk order, a __syncwarp apart. A row read
//   by every lane costs five shuffles a channel, not 32 serial adds.
// * The block adds its warps' copies in warp order and writes
//   partial[block, rows * C]; pass 2 sums partial over the blocks in block
//   order, one warp an element (lane-strided, then a fixed butterfly).
//
// Every sum runs in an order that depends on the inputs' values and n
// alone, so the same inputs give the same bits run after run, as the
// sort-based path does; no atomics touch device memory. An index outside
// [-rows, rows) traps, as torch's indexing asserts; a negative one counts
// from the end, as table[idx] reads it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 8;                    // warps a block of pass 1
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNKS = 4;                   // 32-lane chunks a warp step
constexpr int STEP = 32 * CHUNKS;           // lanes a warp step
constexpr int BLOCK_STEP = STEP * WARPS;    // lanes a block step
constexpr int MAX_BLOCKS = 264;             // two blocks on each of the H100's 132 SMs
constexpr int MAX_FLOATS = 48 * 1024 / (4 * WARPS);  // rows * C: WARPS copies in 48 KB
constexpr int TREE = 5;                     // log2(32) steps of the rank tree

template <typename Index>
__global__ void __launch_bounds__(THREADS)
gather_backward_partial(const float* __restrict__ grad, const Index* __restrict__ idx,
                        long long n, int rows, int c, long long per_block,
                        float* __restrict__ partial) {
    extern __shared__ float copies[];       // WARPS x (rows * c)
    const int rc = rows * c;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* mine = copies + warp * rc;
    for (int e = threadIdx.x; e < WARPS * rc; e += THREADS) copies[e] = 0.0f;
    __syncthreads();

    const long long begin = (long long)blockIdx.x * per_block;
    const long long end = begin + per_block < n ? begin + per_block : n;
    for (long long base = begin + (long long)warp * STEP; base < end;
         base += BLOCK_STEP) {
        int row[CHUNKS];
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
            const long long i = base + k * 32 + lane;
            row[k] = -1;                    // past the slice: a group of its own
            if (i < end) {
                long long r = (long long)idx[i];
                if (r < 0) r += rows;
                if (r < 0 || r >= rows) __trap();
                row[k] = (int)r;
            }
        }
        // the rank tree of each chunk: at step j, the lane of rank r with
        // r % 2^(j+1) == 0 adds the value of its group's lane of rank
        // r + 2^j (src[k][j]; its own lane where it takes nothing)
        int src[CHUNKS][TREE];
        bool lead[CHUNKS];
#pragma unroll
        for (int k = 0; k < CHUNKS; ++k) {
            const unsigned grp = __match_any_sync(FULL, row[k]);
            const int rank = __popc(grp & ((1u << lane) - 1u));
            unsigned above = grp & ~((2u << lane) - 1u);   // the group's lanes past this one
            lead[k] = rank == 0 && row[k] >= 0;
#pragma unroll
            for (int j = 0; j < TREE; ++j) {
                // `above` has lost its first 2^j - 1 lanes: its lowest is rank + 2^j
                const bool takes = (rank & ((2 << j) - 1)) == 0 && above != 0u;
                src[k][j] = takes ? __ffs(above) - 1 : lane;
                for (int drop = 0; drop < (1 << j) && above != 0u; ++drop) above &= above - 1u;
            }
        }
        for (int ch = 0; ch < c; ++ch) {
            float v[CHUNKS];
#pragma unroll
            for (int k = 0; k < CHUNKS; ++k) {
                const long long i = base + k * 32 + lane;
                v[k] = row[k] >= 0 ? grad[i * c + ch] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < CHUNKS; ++k) {
#pragma unroll
                for (int j = 0; j < TREE; ++j) {
                    const float other = __shfl_sync(FULL, v[k], src[k][j]);
                    if (src[k][j] != lane) v[k] += other;
                }
            }
#pragma unroll
            for (int k = 0; k < CHUNKS; ++k) {
                if (lead[k]) mine[row[k] * c + ch] += v[k];
                __syncwarp();
            }
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rc; e += THREADS) {
        float acc = 0.0f;
        for (int w = 0; w < WARPS; ++w) acc += copies[w * rc + e];
        partial[(long long)blockIdx.x * rc + e] = acc;
    }
}

// One warp an element: lane l sums blocks l, l + 32, ... in order, then a
// butterfly of fixed shape; lane 0 writes.
__global__ void __launch_bounds__(THREADS)
gather_backward_sum(const float* __restrict__ partial, int blocks, int rc,
                    float* __restrict__ out) {
    const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (e >= rc) return;                    // the whole warp leaves together
    float acc = 0.0f;
    for (int b = lane; b < blocks; b += 32) acc += partial[(long long)b * rc + e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) out[e] = acc;
}

}  // namespace

extern "C" {

// Blocks of pass 1 for n lanes: one a block step of lanes, at most
// MAX_BLOCKS, at least 1. The caller allocates partial as (blocks, rows * c).
int gather_backward_blocks(long long n) {
    const long long b = (n + BLOCK_STEP - 1) / BLOCK_STEP;
    return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

// The largest rows * c the kernel takes.
int gather_backward_max_floats() { return MAX_FLOATS; }

// grad (n, c) float32 and idx (n,) of idx_bytes 4 (int32) or 8 (int64),
// both contiguous; out (rows, c) float32, written whole. Launches both
// passes on `stream`; returns a CUDA error code (0 = ok).
int gather_backward(const float* grad, const void* idx, int idx_bytes, long long n, int rows,
                    int c, float* partial, int blocks, float* out, void* stream) {
    const long long rc = (long long)rows * c;
    if (n < 1 || rows < 1 || c < 1 || rc > MAX_FLOATS || blocks != gather_backward_blocks(n)
        || (idx_bytes != 4 && idx_bytes != 8))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    // each block's slice: whole warp steps, so that no step straddles two blocks
    const long long steps = (n + STEP - 1) / STEP;
    const long long per_block = (steps + blocks - 1) / blocks * STEP;
    const size_t smem = sizeof(float) * WARPS * rc;
    if (idx_bytes == 4)
        gather_backward_partial<int32_t><<<blocks, THREADS, smem, s>>>(
            grad, (const int32_t*)idx, n, rows, c, per_block, partial);
    else
        gather_backward_partial<int64_t><<<blocks, THREADS, smem, s>>>(
            grad, (const int64_t*)idx, n, rows, c, per_block, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gather_backward_sum<<<(int)((rc + WARPS - 1) / WARPS), THREADS, 0, s>>>(
        partial, blocks, (int)rc, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
