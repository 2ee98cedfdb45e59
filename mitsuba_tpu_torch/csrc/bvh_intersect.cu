// Ordered 4-wide BVH closest hit and any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/binned_intersect.py:
// _make_kernel(n_groups)._kernel (launched by _dispatch_tiles, reached from
// closest_hit, any_hit and closest_and_any). That kernel ran the search as
// bf16x3 GEMM tiles of 128 rays x 1,024 Morton-clustered triangles, with a
// noise band, top-2 candidates per ray and an exact re-test after it,
// because f32 on the MXU is emulated and per-lane gathers are slow on a
// TPU. Neither holds here: each ray walks the BVH of scene/bvh.py in exact
// f32, so there is nothing to re-test.
//
// What bounds it: not bytes or flops but the latency of dependent loads
// and the divergence of rays within a warp. The design (after Aila and
// Laine, "Understanding the Efficiency of Ray Traversal on GPUs", 2009):
//
// * A 4-wide tree collapsed from the binary heap (scene/bvh.py `wide`):
//   one 128-byte record per node holds its four child boxes as SoA and
//   their references, read as independent 16-byte loads, so a fetch is one
//   memory latency and the four slab tests run side by side. The
//   70,034-triangle mesh has 8 wide levels instead of 15 binary ones.
// * Ordered traversal with a per-thread stack: the hit children are pushed
//   farthest first, the nearest is taken next (in a register, not through
//   the stack), and a popped entry at or beyond the closest hit's quantised
//   t is dropped, so a near hit culls the far boxes. The stack stays in
//   local memory (L1-cached): in shared memory, 24 entries of 8 bytes per
//   thread took the L1 that the node records need, and the closest and
//   fused walks ran slower on the H100 (PERF.md §6).
// * Persistent warps: the grid is the resident block count; a global
//   atomic counter hands out rays, and a warp refills its idle lanes
//   whenever REFILL of them are idle, so a batch larger than the card's
//   resident threads has no wave tail and few idle lanes.
// * One step per loop trip (if-if): each lane takes one node or one leaf,
//   with one round of 16-byte loads for either (a node's seven from its
//   128-byte line, a leaf's nine from its two lines, scene/bvh.py
//   `leaf_tris`), so a warp whose lanes mix nodes and leaves waits for one
//   round of loads, and no lane waits for another to reach a leaf.
// * __launch_bounds__(BLOCK, MIN_BLOCKS): 32 resident warps per SM, at
//   most 64 registers a thread.
//
// The walk repeats ops/bvh_traverse.py (the plain twin) operation for
// operation: the slab test with NaN-propagating min/max (torch.minimum),
// the validity term for pad and empty slots, the push rank (larger t_enter
// first, then the lower slot), the cull at each pop, Moller-Trumbore in the
// order of intersect.tri_test, the closest hit culled by the packed key's
// quantised t taken once per leaf, the any-hit stopping at its first opaque
// hit. Built with --fmad=false and IEEE division, kernel and twin agree bit
// for bit.
//
// Output contract: key = (t_bits & ~127) | slot-in-leaf, base = leaf * 4;
// a miss leaves key = MISS_BITS, base = 0. blocked = 1 where an opaque
// triangle is hit with SHADOW_EPS < t < limit. A ray with tmax (limit)
// <= 0 is a retired lane: it keeps the miss result without walking.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;              // threads per block
constexpr int MIN_BLOCKS = 8;           // resident blocks per SM asked of ptxas
constexpr int STACK = 32;               // stack entries (bvh_traverse.stack_depth)
constexpr int REFILL = 8;               // idle lanes that make a warp fetch rays
constexpr int LEAF = 4;                 // triangles per leaf (scene/bvh.py)
constexpr int MISS_BITS = 0x7F000000;   // float bits of 2^127
constexpr int LANE_MASK = 127;
constexpr float MISS = 1.7014118346046923e38f;  // 2^127
constexpr float BARY_EPS = 1e-6f;
constexpr float BARY_HI = 1.000001f;    // 1 + BARY_EPS, rounded once
constexpr float SHADOW_EPS = 1e-3f;
constexpr float DIR_GUARD = 1e-12f;     // |d| below it becomes +-1e-12
constexpr unsigned FULL = 0xFFFFFFFFu;

// torch.minimum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float guarded_inv(float x) {
    const float g = fabsf(x) < DIR_GUARD ? (x >= 0.0f ? DIR_GUARD : -DIR_GUARD) : x;
    return 1.0f / g;
}

__device__ __forceinline__ float comp(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab test of child c of a wide record (lo/hi SoA rows): returns whether
// the box is hit below `cull`, with its t_enter in *t_enter.
__device__ __forceinline__ bool slab(const float4& lx, const float4& ly, const float4& lz,
                                     const float4& hx, const float4& hy, const float4& hz,
                                     int c, const Ray& r, float cull, float* t_enter) {
    const float lox = comp(lx, c), hix = comp(hx, c);
    const float t0x = (lox - r.ox) * r.ix, t1x = (hix - r.ox) * r.ix;
    const float t0y = (comp(ly, c) - r.oy) * r.iy, t1y = (comp(hy, c) - r.oy) * r.iy;
    const float t0z = (comp(lz, c) - r.oz) * r.iz, t1z = (comp(hz, c) - r.oz) * r.iz;
    const float te = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                             nan_min(t0z, t1z));
    const float tx = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                             nan_max(t0z, t1z));
    *t_enter = te;
    return (te <= tx) && (tx > SHADOW_EPS) && (te < cull) && (lox <= hix);
}

// Moller-Trumbore of the ray against slot k of a leaf whose nine rows are
// in row[]: returns t, with *hit the geometric test (intersect.tri_test).
__device__ __forceinline__ float tri_t(const float4* row, int k, const Ray& r, bool* hit) {
    const float p0x = comp(row[0], k), p0y = comp(row[1], k), p0z = comp(row[2], k);
    const float e1x = comp(row[3], k), e1y = comp(row[4], k), e1z = comp(row[5], k);
    const float e2x = comp(row[6], k), e2y = comp(row[7], k), e2z = comp(row[8], k);

    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool bad = fabsf(det) < 1e-12f;
    const float inv_det = bad ? 0.0f : 1.0f / det;
    const float tvx = r.ox - p0x;
    const float tvy = r.oy - p0y;
    const float tvz = r.oz - p0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    *hit = (u >= -BARY_EPS) && (v >= -BARY_EPS) && (u + v <= BARY_HI)
        && (t > SHADOW_EPS) && !bad;
    return t;
}

// Rays [0, n_c) of (o_c, d_c, tm_c) take the closest hit below tm_c and
// write key/base; rays [0, n_s) of (o_s, d_s, lim_s) the any-hit below
// lim_s and write blocked. Ray number i of the counter is closest ray i
// below n_c, shadow ray i - n_c above.
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_walk_kernel(const float* __restrict__ o_c, const float* __restrict__ d_c,
                const float* __restrict__ tm_c, int n_c,
                const float* __restrict__ o_s, const float* __restrict__ d_s,
                const float* __restrict__ lim_s, int n_s,
                const float4* __restrict__ wide, const float4* __restrict__ leaf_tris,
                const uint32_t* __restrict__ leaf_opaque, int* __restrict__ counter, int* __restrict__ key_out,
                int* __restrict__ base_out, uint8_t* __restrict__ blocked_out) {
    const int lane = threadIdx.x & 31;
    const int n_total = n_c + n_s;
    int2 stack[STACK];     // (reference, t_enter bits)
    int sp = 0;
    int cur = 0;           // the entry to take next, if have
    bool have = false;
    int ray = -1;          // this lane's ray number, -1 when idle
    int j = 0;             // its index in its own set
    bool any = false;
    float tm = 0.0f;
    Ray r{};
    int best_key = MISS_BITS, best_base = 0;
    bool blocked = false;
    bool drained = false;  // the counter has handed out every ray

    while (true) {
        const unsigned idle = __ballot_sync(FULL, ray < 0);
        if (drained && idle == FULL) break;
        if (!drained && __popc(idle) >= REFILL) {
            const int leader = __ffs(idle) - 1;
            int first = 0;
            if (lane == leader) first = atomicAdd(counter, __popc(idle));
            first = __shfl_sync(FULL, first, leader);
            drained = first + __popc(idle) >= n_total;
            const int mine = first + __popc(idle & ((1u << lane) - 1u));
            if (ray < 0 && mine < n_total) {
                ray = mine;
                any = mine >= n_c;
                j = any ? mine - n_c : mine;
                const float* o = any ? o_s : o_c;
                const float* d = any ? d_s : d_c;
                tm = any ? lim_s[j] : tm_c[j];
                r.ox = o[3 * (size_t)j]; r.oy = o[3 * (size_t)j + 1]; r.oz = o[3 * (size_t)j + 2];
                r.dx = d[3 * (size_t)j]; r.dy = d[3 * (size_t)j + 1]; r.dz = d[3 * (size_t)j + 2];
                r.ix = guarded_inv(r.dx); r.iy = guarded_inv(r.dy); r.iz = guarded_inv(r.dz);
                best_key = MISS_BITS;
                best_base = 0;
                blocked = false;
                // the wide root, never culled; a retired lane (tm <= 0) does
                // not walk (a NaN limit walks, as in the twin)
                sp = 0;
                cur = 0;
                have = !(tm <= 0.0f);
            }
        }
        if (ray >= 0) {
            // one step: the entry to take is `cur` (the nearest child of the
            // last node, which the twin pushes and pops at once and whose
            // cull test passes, as it did at the box test with the same
            // cull), else the stack's top, dropped while culled
            const float best_t = __int_as_float(best_key & ~LANE_MASK);
            const float cull = any ? tm : best_t;
            while (!have && sp > 0) {
                const int2 e = stack[--sp];
                if (__int_as_float(e.y) < cull) {
                    cur = e.x;
                    have = true;
                }
            }
            if (have) {
                have = false;
                // one round of 16-byte loads, a node's record (seven) or a
                // leaf's nine rows (two cache lines), so a warp whose lanes
                // mix nodes and leaves waits for one round of loads
                const bool is_leaf = cur < 0;
                const int leaf = -1 - cur;
                const float4* src = is_leaf ? leaf_tris + 9 * (size_t)leaf : wide + 8 * (size_t)cur;
                float4 v[9];
#pragma unroll
                for (int c = 0; c < 9; ++c) {
                    v[c] = (c < 7 || is_leaf) ? __ldg(src + c) : make_float4(0, 0, 0, 0);
                }
                if (!is_leaf) {
                    bool hit[4];
                    float te[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        hit[c] = slab(v[0], v[1], v[2], v[3], v[4], v[5], c, r, cull, &te[c]);
                    }
                    // each hit child goes above the hit children pushed before
                    // it: those with a larger t_enter, or an equal one in a
                    // lower slot; the one of rank n_hit - 1, the nearest, is
                    // taken next
                    const int n_hit = (int)hit[0] + (int)hit[1] + (int)hit[2] + (int)hit[3];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        int rank = 0;
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            rank += (hit[e] && (te[e] > te[c] || (te[e] == te[c] && e < c)))
                                ? 1 : 0;
                        }
                        const int kid = __float_as_int(comp(v[6], c));
                        if (hit[c] && rank == n_hit - 1) {
                            cur = kid;
                            have = true;
                        } else if (hit[c]) {
                            stack[sp + rank] = make_int2(kid, __float_as_int(te[c]));
                        }
                    }
                    sp += n_hit > 0 ? n_hit - 1 : 0;
                } else if (any) {
                    const uint32_t opaque = __ldg(leaf_opaque + leaf);
#pragma unroll
                    for (int k = 0; k < LEAF; ++k) {
                        bool hit;
                        const float t = tri_t(v, k, r, &hit);
                        if (hit && t < tm && ((opaque >> (8 * k)) & 0xFFu)) blocked = true;
                    }
                } else {
                    int ckey = MISS_BITS | LANE_MASK;
#pragma unroll
                    for (int k = 0; k < LEAF; ++k) {
                        bool hit;
                        const float t = tri_t(v, k, r, &hit);
                        const float tk = (hit && t < best_t && t < tm) ? t : MISS;
                        ckey = min(ckey, (__float_as_int(tk) & ~LANE_MASK) | k);
                    }
                    if (ckey < best_key) {
                        best_key = ckey;
                        best_base = leaf * LEAF;
                    }
                }
            }
            if ((!have && sp == 0) || (any && blocked)) {
                if (any) {
                    blocked_out[j] = blocked ? 1 : 0;
                } else {
                    key_out[j] = best_key;
                    base_out[j] = best_base;
                }
                ray = -1;
            }
        }
    }
}

// Resident blocks of the walk per SM on each device, measured once.
int resident_blocks[64];

int launch(const float* o_c, const float* d_c, const float* tm_c, int n_c,
           const float* o_s, const float* d_s, const float* lim_s, int n_s,
           const float* wide, const float* leaf_tris, const uint8_t* leaf_opaque,
           int* counter, int* key, int* base, uint8_t* blocked, int* grid_out,
           void* stream) {
    const int n = n_c + n_s;
    if (n == 0) return 0;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < 64 && resident_blocks[dev] == 0) {
        // no shared memory: give L1 the whole carveout (the stacks live there)
        err = cudaFuncSetAttribute(bvh_walk_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, 0);
        int blocks = 0;
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_walk_kernel,
                                                                BLOCK, 0);
        resident_blocks[dev] = blocks;
    }
    if (err != cudaSuccess) return (int)err;
    const int per_sm = dev < 64 ? resident_blocks[dev] : MIN_BLOCKS;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const long long needed = (n + BLOCK - 1) / BLOCK;
    const int grid = (int)(needed < (long long)sms * per_sm ? needed : (long long)sms * per_sm);
    if (grid_out != nullptr) *grid_out = grid;
    bvh_walk_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        o_c, d_c, tm_c, n_c, o_s, d_s, lim_s, n_s,
        reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(leaf_tris),
        reinterpret_cast<const uint32_t*>(leaf_opaque), counter, key, base, blocked);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// wide: (W, 32) f32; leaf_tris: (L, 9, 4) f32; leaf_opaque: (4L,) bytes;
// all 16-byte aligned; the tree needs at most 32 stack entries. counter:
// one int32, zero at launch. grid, if not null, receives the number of
// blocks launched.
int bvh_closest(const float* o, const float* d, const float* tmax, int n,
                const float* wide, const float* leaf_tris, const uint8_t* leaf_opaque,
                int* counter, int* key, int* base, int* grid, void* stream) {
    return launch(o, d, tmax, n, nullptr, nullptr, nullptr, 0, wide, leaf_tris,
                  leaf_opaque, counter, key, base, nullptr, grid, stream);
}

int bvh_any_hit(const float* o, const float* d, const float* limit, int n,
                const float* wide, const float* leaf_tris, const uint8_t* leaf_opaque,
                int* counter, uint8_t* blocked, int* grid, void* stream) {
    return launch(nullptr, nullptr, nullptr, 0, o, d, limit, n, wide, leaf_tris,
                  leaf_opaque, counter, nullptr, nullptr, blocked, grid, stream);
}

int bvh_closest_and_any(const float* o_c, const float* d_c, const float* tmax_c, int n_c,
                        const float* o_s, const float* d_s, const float* limit_s, int n_s,
                        const float* wide, const float* leaf_tris,
                        const uint8_t* leaf_opaque, int* counter, int* key, int* base,
                        uint8_t* blocked, int* grid, void* stream) {
    return launch(o_c, d_c, tmax_c, n_c, o_s, d_s, limit_s, n_s, wide, leaf_tris,
                  leaf_opaque, counter, key, base, blocked, grid, stream);
}

}  // extern "C"
