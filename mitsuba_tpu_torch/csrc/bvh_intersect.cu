// Stackless threaded-BVH closest hit and any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/binned_intersect.py:
// _make_kernel(n_groups)._kernel (launched by _dispatch_tiles, reached from
// closest_hit, any_hit and closest_and_any). That kernel ran the search as
// bf16x3 GEMM tiles of 128 rays x 1,024 Morton-clustered triangles, with a
// noise band, top-2 candidates per ray and an exact re-test after it,
// because f32 on the MXU is emulated and per-lane gathers are slow on a
// TPU. Neither holds here: one thread walks one ray down the threaded BVH
// of scene/bvh.py in exact f32, so there is nothing to re-test.
//
// What bounds it: not bytes or flops but the latency of dependent loads.
// Each node visit is two 16-byte loads (the packed node record) and a
// ~30-flop slab test whose outcome picks the next node; a leaf adds nine
// 16-byte loads (one per p0/e1/e2 row, four triangles each) and four
// Moller-Trumbore tests. The tables (~6.8 MB at 70k triangles) stay in the
// 50 MB L2. The design's answer so far: packed, aligned records read
// through the read-only cache, one ray per thread and many warps per SM to
// hide the latency. Near-child ordering, ray sorting, a wider tree and
// persistent threads are later work.
//
// The walk repeats ops/bvh_traverse.py (the plain twin) operation for
// operation: the slab test with NaN-propagating min/max (torch.minimum),
// the validity term for pad nodes, Moller-Trumbore in the order of
// intersect.tri_test, the closest hit culled by the packed key's quantised
// t taken once per leaf, the any-hit stopping at its first opaque hit. Built
// with --fmad=false and IEEE division, kernel and twin agree bit for bit.
//
// Output contract: key = (t_bits & ~127) | slot-in-leaf, base = leaf * 4;
// a miss leaves key = MISS_BITS, base = 0. blocked = 1 where an opaque
// triangle is hit with SHADOW_EPS < t < limit. A ray with tmax (limit)
// <= 0 is a retired lane: it keeps the miss result without walking.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;              // threads (rays) per block
constexpr int LEAF = 4;                 // triangles per leaf (scene/bvh.py)
constexpr int MISS_BITS = 0x7F000000;   // float bits of 2^127
constexpr int LANE_MASK = 127;
constexpr float MISS = 1.7014118346046923e38f;  // 2^127
constexpr float BARY_EPS = 1e-6f;
constexpr float BARY_HI = 1.000001f;    // 1 + BARY_EPS, rounded once
constexpr float SHADOW_EPS = 1e-3f;
constexpr float DIR_GUARD = 1e-12f;     // |d| below it becomes +-1e-12

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

// Node record a = (min x, min y, min z, max x), b = (max y, max z, miss, 0).
__device__ __forceinline__ bool slab(const float4& a, const float4& b, const Ray& r,
                                     float cull) {
    const float t0x = (a.x - r.ox) * r.ix, t1x = (a.w - r.ox) * r.ix;
    const float t0y = (a.y - r.oy) * r.iy, t1y = (b.x - r.oy) * r.iy;
    const float t0z = (a.z - r.oz) * r.iz, t1z = (b.y - r.oz) * r.iz;
    const float t_enter = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                                  nan_min(t0z, t1z));
    const float t_exit = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)),
                                 nan_max(t0z, t1z));
    return (t_enter <= t_exit) && (t_exit > SHADOW_EPS) && (t_enter < cull)
        && (a.x <= a.w);
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
// lim_s and write blocked. Thread i < n_c is closest ray i, thread n_c + j
// shadow ray j.
__global__ void __launch_bounds__(BLOCK)
walk_kernel(const float* __restrict__ o_c, const float* __restrict__ d_c,
            const float* __restrict__ tm_c, int n_c,
            const float* __restrict__ o_s, const float* __restrict__ d_s,
            const float* __restrict__ lim_s, int n_s,
            const float4* __restrict__ nodes, const float4* __restrict__ leaf_tris,
            const uint32_t* __restrict__ leaf_opaque, int n_internal, int cap4,
            int* __restrict__ key_out, int* __restrict__ base_out,
            uint8_t* __restrict__ blocked_out) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n_c + n_s) return;
    const bool any = i >= n_c;
    const int j = any ? i - n_c : i;
    const float* o = any ? o_s : o_c;
    const float* d = any ? d_s : d_c;
    const float tm = any ? lim_s[j] : tm_c[j];
    Ray r;
    r.ox = o[3 * j]; r.oy = o[3 * j + 1]; r.oz = o[3 * j + 2];
    r.dx = d[3 * j]; r.dy = d[3 * j + 1]; r.dz = d[3 * j + 2];
    r.ix = guarded_inv(r.dx); r.iy = guarded_inv(r.dy); r.iz = guarded_inv(r.dz);

    int best_key = MISS_BITS;
    int best_base = 0;
    bool blocked = false;
    int node = !(tm <= 0.0f) ? 0 : -1;   // a NaN limit walks, as in the twin
    while (node >= 0) {
        const float4 a = __ldg(nodes + 2 * (size_t)node);
        const float4 b = __ldg(nodes + 2 * (size_t)node + 1);
        const float best_t = __int_as_float(best_key & ~LANE_MASK);
        const bool box = slab(a, b, r, any ? tm : best_t);
        const bool is_leaf = node >= n_internal;
        if (box && is_leaf) {
            const int leaf = node - n_internal;
            float4 row[9];
#pragma unroll
            for (int c = 0; c < 9; ++c) row[c] = __ldg(leaf_tris + (size_t)c * cap4 + leaf);
            if (any) {
                const uint32_t opaque = __ldg(leaf_opaque + leaf);
#pragma unroll
                for (int k = 0; k < LEAF; ++k) {
                    bool hit;
                    const float t = tri_t(row, k, r, &hit);
                    if (hit && t < tm && ((opaque >> (8 * k)) & 0xFFu)) blocked = true;
                }
            } else {
                int ckey = MISS_BITS | LANE_MASK;
#pragma unroll
                for (int k = 0; k < LEAF; ++k) {
                    bool hit;
                    const float t = tri_t(row, k, r, &hit);
                    const float tk = (hit && t < best_t && t < tm) ? t : MISS;
                    ckey = min(ckey, (__float_as_int(tk) & ~LANE_MASK) | k);
                }
                if (ckey < best_key) {
                    best_key = ckey;
                    best_base = leaf * LEAF;
                }
            }
        }
        if (blocked) break;
        node = (box && !is_leaf) ? 2 * node + 1 : __float_as_int(b.z);
    }
    if (any) {
        blocked_out[j] = blocked ? 1 : 0;
    } else {
        key_out[j] = best_key;
        base_out[j] = best_base;
    }
}

int launch(const float* o_c, const float* d_c, const float* tm_c, int n_c,
           const float* o_s, const float* d_s, const float* lim_s, int n_s,
           const float* nodes, const float* leaf_tris, const uint8_t* leaf_opaque,
           int n_internal, int cap, int* key, int* base, uint8_t* blocked,
           void* stream) {
    const int n = n_c + n_s;
    if (n == 0) return 0;
    const int grid = (n + BLOCK - 1) / BLOCK;
    walk_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        o_c, d_c, tm_c, n_c, o_s, d_s, lim_s, n_s,
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(leaf_tris),
        reinterpret_cast<const uint32_t*>(leaf_opaque), n_internal, cap / LEAF,
        key, base, blocked);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
// nodes: (M, 8) f32; leaf_tris: (9, cap) f32; leaf_opaque: (cap,) bytes;
// all 16-byte aligned, cap a multiple of 4.
int bvh_closest(const float* o, const float* d, const float* tmax, int n,
                const float* nodes, const float* leaf_tris, const uint8_t* leaf_opaque,
                int n_internal, int cap, int* key, int* base, void* stream) {
    return launch(o, d, tmax, n, nullptr, nullptr, nullptr, 0, nodes, leaf_tris,
                  leaf_opaque, n_internal, cap, key, base, nullptr, stream);
}

int bvh_any_hit(const float* o, const float* d, const float* limit, int n,
                const float* nodes, const float* leaf_tris, const uint8_t* leaf_opaque,
                int n_internal, int cap, uint8_t* blocked, void* stream) {
    return launch(nullptr, nullptr, nullptr, 0, o, d, limit, n, nodes, leaf_tris,
                  leaf_opaque, n_internal, cap, nullptr, nullptr, blocked, stream);
}

int bvh_closest_and_any(const float* o_c, const float* d_c, const float* tmax_c, int n_c,
                        const float* o_s, const float* d_s, const float* limit_s, int n_s,
                        const float* nodes, const float* leaf_tris,
                        const uint8_t* leaf_opaque, int n_internal, int cap, int* key,
                        int* base, uint8_t* blocked, void* stream) {
    return launch(o_c, d_c, tmax_c, n_c, o_s, d_s, limit_s, n_s, nodes, leaf_tris,
                  leaf_opaque, n_internal, cap, key, base, blocked, stream);
}

}  // extern "C"
