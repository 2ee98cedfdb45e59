// Brute-force ray-triangle closest hit and any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/pallas_intersect.py:_kernel.
// Bound by f32 ALU work on O(N*T) triangle tests (~40 flops per pair):
// one thread owns one ray and keeps its running best key in a register,
// and each block stages the triangles through shared memory in tiles of
// TILE_TRIS, as SoA rows p0x p0y p0z e1x e1y e1z e2x e2y e2z.
//
// Arithmetic repeats the JAX package's VPU form (intersect._chunk_hits)
// operation for operation. Build with --fmad=false and without fast math:
// every multiply and add then rounds on its own and 1.0f/det is IEEE, as
// in the plain PyTorch version, so the two agree bit for bit.
//
// Output contract (pallas_intersect.closest_key): key = (t_bits & ~127) |
// (prim & 127), chunk_base = prim & ~127; a miss leaves key = MISS_BITS and
// chunk_base = 0. Walking the triangles in index order and replacing only
// on a strictly smaller key gives the chunked reduction's tie-break.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;       // threads (rays) per block
constexpr int TILE_TRIS = 256;   // triangles staged per shared-memory tile
constexpr int MISS_BITS = 0x7F000000;   // float bits of 2^127
constexpr int LANE_MASK = 127;
constexpr float MISS = 1.7014118346046923e38f;  // 2^127
constexpr float BARY_EPS = 1e-6f;
constexpr float BARY_HI = 1.000001f;   // 1 + BARY_EPS, rounded once
constexpr float SHADOW_EPS = 1e-3f;

// Stage triangles [start, start + count) of the (9, n_tris) rows into
// shared memory as s[c * TILE_TRIS + j].
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ tris,
                                          int n_tris, int start, int count) {
    for (int k = threadIdx.x; k < 9 * TILE_TRIS; k += BLOCK) {
        int c = k / TILE_TRIS;
        int j = k - c * TILE_TRIS;
        if (j < count) s[k] = tris[(size_t)c * n_tris + start + j];
    }
}

// t of the ray against triangle j of the tile, or MISS: the operation order
// and hit predicate of intersect._chunk_hits, with its best_t and tmax.
__device__ __forceinline__ float hit_t(const float* s, int j,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float best_t, float tmax) {
    const float p0x = s[0 * TILE_TRIS + j], p0y = s[1 * TILE_TRIS + j];
    const float p0z = s[2 * TILE_TRIS + j], e1x = s[3 * TILE_TRIS + j];
    const float e1y = s[4 * TILE_TRIS + j], e1z = s[5 * TILE_TRIS + j];
    const float e2x = s[6 * TILE_TRIS + j], e2y = s[7 * TILE_TRIS + j];
    const float e2z = s[8 * TILE_TRIS + j];

    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const bool bad = fabsf(det) < 1e-12f;
    const float inv_det = bad ? 0.0f : 1.0f / det;
    const float tvx = ox - p0x;
    const float tvy = oy - p0y;
    const float tvz = oz - p0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
    const bool hit = (u >= -BARY_EPS) && (v >= -BARY_EPS) && (u + v <= BARY_HI)
        && (t > SHADOW_EPS) && (t < best_t) && (t < tmax) && !bad;
    return hit ? t : MISS;
}

__global__ void __launch_bounds__(BLOCK)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmax, const float* __restrict__ tris,
               int n_rays, int n_tris, int* __restrict__ key_out,
               int* __restrict__ base_out) {
    __shared__ float s[9 * TILE_TRIS];
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const bool live = i < n_rays;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tm = 0.f;
    if (live) {
        ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
        dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
        tm = tmax[i];
    }
    int best_key = MISS_BITS | LANE_MASK;
    int best_base = 0;
    for (int start = 0; start < n_tris; start += TILE_TRIS) {
        const int count = min(TILE_TRIS, n_tris - start);
        __syncthreads();   // the previous tile is no longer read
        load_tile(s, tris, n_tris, start, count);
        __syncthreads();
        if (live) {
            for (int j = 0; j < count; ++j) {
                const float t = hit_t(s, j, ox, oy, oz, dx, dy, dz, MISS, tm);
                const int prim = start + j;
                const int key = (__float_as_int(t) & ~LANE_MASK) | (prim & LANE_MASK);
                if (key < best_key) {
                    best_key = key;
                    best_base = prim & ~LANE_MASK;
                }
            }
        }
    }
    if (live) {
        key_out[i] = best_key;
        base_out[i] = best_base;
    }
}

__global__ void __launch_bounds__(BLOCK)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ limit, const float* __restrict__ tris,
               const uint8_t* __restrict__ opaque, int n_rays, int n_tris,
               uint8_t* __restrict__ blocked_out) {
    __shared__ float s[9 * TILE_TRIS];
    __shared__ uint8_t s_opaque[TILE_TRIS];
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    const bool live = i < n_rays;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, lim = 0.f;
    if (live) {
        ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
        dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
        lim = limit[i];
    }
    bool blocked = false;
    for (int start = 0; start < n_tris; start += TILE_TRIS) {
        const int count = min(TILE_TRIS, n_tris - start);
        // every thread reaches this barrier; the whole block leaves together
        // once each of its rays is blocked (or out of range)
        if (__syncthreads_and(blocked || !live)) break;
        load_tile(s, tris, n_tris, start, count);
        for (int j = threadIdx.x; j < count; j += BLOCK) s_opaque[j] = opaque[start + j];
        __syncthreads();
        if (live && !blocked) {
            for (int j = 0; j < count; ++j) {
                if (s_opaque[j] && hit_t(s, j, ox, oy, oz, dx, dy, dz, lim, lim) < MISS) {
                    blocked = true;
                    break;
                }
            }
        }
    }
    if (live) blocked_out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 = ok).
int brute_closest(const float* o, const float* d, const float* tmax,
                  const float* tris, int n_rays, int n_tris, int* key,
                  int* base, void* stream) {
    const int grid = (n_rays + BLOCK - 1) / BLOCK;
    closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, tmax, tris, n_rays, n_tris, key, base);
    return (int)cudaGetLastError();
}

int brute_any_hit(const float* o, const float* d, const float* limit,
                  const float* tris, const uint8_t* opaque, int n_rays,
                  int n_tris, uint8_t* blocked, void* stream) {
    const int grid = (n_rays + BLOCK - 1) / BLOCK;
    any_hit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, limit, tris, opaque, n_rays, n_tris, blocked);
    return (int)cudaGetLastError();
}

}  // extern "C"
