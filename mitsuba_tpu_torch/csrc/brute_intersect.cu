// Brute-force ray-triangle closest hit and any-hit for Hopper (sm_90a).
//
// Replaces the TPU kernel mitsuba_tpu/ops/pallas_intersect.py:_kernel.
// Bound by f32 ALU work on O(N*T) triangle tests (Moller-Trumbore: 32
// instructions with multiply-adds contracted, 46 as built, plus an IEEE
// division). What the design does about it:
//
// * The block stages the scene's triangles in dynamic shared memory once,
//   one 48-byte record per triangle (p0x p0y p0z e1x | e1y e1z e2x e2y |
//   e2z, three pad floats), so a test reads its triangle with three 16-byte
//   loads; for any-hit the opacity bytes follow. The copy is cp.async and
//   one barrier. Up to ~4,700 triangles fit in one tile of the card's
//   227 KB (4,096 with 1,024 rays staged beside them); a larger scene takes
//   the same loop over tiles as large as shared memory allows.
// * Each ray is split over L lanes of a warp (L = 1, 2, 4 or 8; the
//   launcher picks it so that the grid fills the card): lane g of the
//   group tests triangles g, g + L, g + 2L, ... in index order, so a scene
//   of 32 triangles at 65,536 rays still gives enough warps to hide the
//   latency of the dependent chains.
// * The rays are staged through shared memory with coalesced loads, read
//   as contiguous floats rather than three strided loads per thread.
//
// Arithmetic repeats the JAX package's VPU form (intersect._chunk_hits)
// operation for operation. Build with --fmad=false and without fast math:
// every multiply and add then rounds on its own and 1.0f/det is IEEE, as
// in the plain PyTorch version, so the two agree bit for bit.
//
// Output contract (pallas_intersect.closest_key): key = (t_bits & ~127) |
// (prim & 127), chunk_base = prim & ~127; a miss leaves key = MISS_BITS and
// chunk_base = 0. Each lane walks its triangles in index order and replaces
// only on a strictly smaller key; the L lanes then combine by the
// lexicographic min of (key, chunk_base). Two equal keys share the
// quantised t and prim & 127, so they differ only in chunk, and the lower
// chunk wins, which is the chunked reduction's tie-break. Any-hit ORs the
// group's lanes with a warp ballot; a warp leaves once all of its rays are
// blocked.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int MISS_BITS = 0x7F000000;   // float bits of 2^127
constexpr int LANE_MASK = 127;
constexpr float MISS = 1.7014118346046923e38f;  // 2^127
constexpr float BARY_EPS = 1e-6f;
constexpr float BARY_HI = 1.000001f;   // 1 + BARY_EPS, rounded once
constexpr float SHADOW_EPS = 1e-3f;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_BLOCK = 1024;
constexpr int RAY_FLOATS = 7;          // o, d, tmax staged per ray
constexpr int TRI_FLOATS = 12;         // floats per staged triangle record
constexpr int VOTE_TRIPS = 4;          // any-hit trips between warp votes

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Dynamic shared memory of one block: tile triangles (48-byte records,
// then the opacity bytes for any-hit) and the block's rays.
__host__ __device__ constexpr int tri_bytes(int tile, bool any) {
    return 4 * TRI_FLOATS * tile + (any ? align16(tile) : 0);
}
__host__ __device__ constexpr int smem_bytes(int tile, int rays, bool any) {
    return tri_bytes(tile, any) + RAY_FLOATS * 4 * rays;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copy of triangles [start, start + count) of the (9, n_tris)
// rows into the records s[j * 12 + c] (and their opacity bytes into
// s_op[j]).
__device__ __forceinline__ void load_tile(float* s, uint8_t* s_op, const float* __restrict__ tris,
                                          const uint8_t* __restrict__ opaque, int n_tris,
                                          int start, int count) {
    for (int c = 0; c < 9; ++c) {
        for (int j = threadIdx.x; j < count; j += blockDim.x) {
            cp_async4(s + TRI_FLOATS * j + c, tris + (size_t)c * n_tris + start + j);
        }
    }
    if (s_op != nullptr) {
        for (int j = threadIdx.x; j < count; j += blockDim.x) s_op[j] = opaque[start + j];
    }
}

// Stage the block's rays [ray0, ray0 + n_block) with coalesced loads:
// r[0:3n) = o, r[3n:6n) = d, r[6n:7n) = tmax.
__device__ __forceinline__ void load_rays(float* r, const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ tm, int ray0, int n_block) {
    const size_t g = 3 * (size_t)ray0;
    for (int k = threadIdx.x; k < 3 * n_block; k += blockDim.x) {
        r[k] = o[g + k];
        r[3 * n_block + k] = d[g + k];
    }
    for (int k = threadIdx.x; k < n_block; k += blockDim.x) r[6 * n_block + k] = tm[ray0 + k];
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, tm;
};

__device__ __forceinline__ Ray read_ray(const float* r, int k, int n_block) {
    Ray ray;
    ray.ox = r[3 * k]; ray.oy = r[3 * k + 1]; ray.oz = r[3 * k + 2];
    ray.dx = r[3 * n_block + 3 * k]; ray.dy = r[3 * n_block + 3 * k + 1];
    ray.dz = r[3 * n_block + 3 * k + 2];
    ray.tm = r[6 * n_block + k];
    return ray;
}

// t of the ray against triangle j of the tile, or MISS: the operation order
// and hit predicate of intersect._chunk_hits, with its best_t and tmax.
__device__ __forceinline__ float hit_t(const float* s, int j, const Ray& r,
                                       float best_t, float tmax) {
    const float4* rec = reinterpret_cast<const float4*>(s + TRI_FLOATS * j);
    const float4 a = rec[0], b = rec[1], c = rec[2];
    const float p0x = a.x, p0y = a.y, p0z = a.z, e1x = a.w;
    const float e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w, e2z = c.x;

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
    const bool hit = (u >= -BARY_EPS) && (v >= -BARY_EPS) && (u + v <= BARY_HI)
        && (t > SHADOW_EPS) && (t < best_t) && (t < tmax) && !bad;
    return hit ? t : MISS;
}

// Block b serves rays [b * R, (b + 1) * R), R = blockDim.x / L; thread k is
// lane k % L of ray k / L. Triangles come in tiles of `tile` (one tile when
// the scene fits).
template <int L>
__global__ void __launch_bounds__(MAX_BLOCK)
brute_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax, const float* __restrict__ tris,
                     int n_rays, int n_tris, int tile, int* __restrict__ key_out,
                     int* __restrict__ base_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s = reinterpret_cast<float*>(smem);
    float* r = reinterpret_cast<float*>(smem + tri_bytes(tile, false));
    const int per_block = blockDim.x / L;
    const int ray0 = blockIdx.x * per_block;
    const int n_block = min(per_block, n_rays - ray0);
    const int k = threadIdx.x / L;
    const int g = threadIdx.x % L;
    const bool live = k < n_block;

    load_tile(s, nullptr, tris, nullptr, n_tris, 0, min(tile, n_tris));
    load_rays(r, o, d, tmax, ray0, n_block);
    cp_async_wait_all();
    __syncthreads();
    const Ray ray = live ? read_ray(r, k, n_block) : Ray{};

    int best_key = MISS_BITS | LANE_MASK;
    int best_base = 0;
    for (int start = 0; start < n_tris; start += tile) {
        const int count = min(tile, n_tris - start);
        if (start > 0) {
            __syncthreads();   // the previous tile is no longer read
            load_tile(s, nullptr, tris, nullptr, n_tris, start, count);
            cp_async_wait_all();
            __syncthreads();
        }
        if (live) {
            for (int j = g; j < count; j += L) {
                const float t = hit_t(s, j, ray, MISS, ray.tm);
                const int prim = start + j;
                const int key = (__float_as_int(t) & ~LANE_MASK) | (prim & LANE_MASK);
                if (key < best_key) {
                    best_key = key;
                    best_base = prim & ~LANE_MASK;
                }
            }
        }
    }
    // the group's lanes are adjacent and L divides 32: xor offsets below L
    // stay inside the group
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
        const int other_key = __shfl_xor_sync(FULL, best_key, off);
        const int other_base = __shfl_xor_sync(FULL, best_base, off);
        if (other_key < best_key || (other_key == best_key && other_base < best_base)) {
            best_key = other_key;
            best_base = other_base;
        }
    }
    if (live && g == 0) {
        key_out[ray0 + k] = best_key;
        base_out[ray0 + k] = best_base;
    }
}

template <int L>
__global__ void __launch_bounds__(MAX_BLOCK)
brute_any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ limit, const float* __restrict__ tris,
                     const uint8_t* __restrict__ opaque, int n_rays, int n_tris, int tile,
                     uint8_t* __restrict__ blocked_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s = reinterpret_cast<float*>(smem);
    uint8_t* s_op = smem + 4 * TRI_FLOATS * tile;
    float* r = reinterpret_cast<float*>(smem + tri_bytes(tile, true));
    const int per_block = blockDim.x / L;
    const int ray0 = blockIdx.x * per_block;
    const int n_block = min(per_block, n_rays - ray0);
    const int k = threadIdx.x / L;
    const int g = threadIdx.x % L;
    const bool live = k < n_block;
    // this lane's group within the warp's ballot
    const unsigned group = ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));

    load_tile(s, s_op, tris, opaque, n_tris, 0, min(tile, n_tris));
    load_rays(r, o, d, limit, ray0, n_block);
    cp_async_wait_all();
    __syncthreads();
    const Ray ray = live ? read_ray(r, k, n_block) : Ray{};

    bool blocked = false;
    bool found = false;   // this lane hit an opaque triangle
    for (int start = 0; start < n_tris; start += tile) {
        const int count = min(tile, n_tris - start);
        if (start > 0) {
            // every thread reaches this barrier; the whole block leaves
            // together once each of its rays is blocked (or out of range)
            if (__syncthreads_and(blocked || !live)) break;
            load_tile(s, s_op, tris, opaque, n_tris, start, count);
            cp_async_wait_all();
            __syncthreads();
        }
        // count is the same for the whole block, so every lane of the warp
        // takes the same trips and reaches each vote: every VOTE_TRIPS-th
        // trip and the tile's last, where the group ORs its lanes' hits
        for (int j0 = 0, trip = 1; j0 < count; j0 += L, ++trip) {
            const int j = j0 + g;
            found = found || (live && !blocked && j < count && s_op[j]
                              && hit_t(s, j, ray, ray.tm, ray.tm) < MISS);
            if (trip % VOTE_TRIPS == 0 || j0 + L >= count) {
                const unsigned votes = __ballot_sync(FULL, found);   // every lane votes
                blocked = blocked || (votes & group) != 0u;
                if (__all_sync(FULL, blocked || !live)) break;
            }
        }
    }
    if (live && g == 0) blocked_out[ray0 + k] = blocked ? 1 : 0;
}

// Launch configuration of one entry: lanes per ray, block size, tile and
// dynamic shared memory.
struct Config {
    int lanes, block, tile, smem;
};

// The block size (128 to 1,024 threads) with the most resident threads per
// SM for this kernel, tile and lane count; ties go to the smaller block.
// The tile is the whole scene when it fits, else as large as shared memory
// allows. *resident gets the card's resident threads at that block size.
// Returns a CUDA error, or 0.
template <typename K>
int configure(K kernel, int n_tris, int lanes, bool any, int max_smem, int sms,
              Config* cfg, long long* resident) {
    // a request the card refuses is an error, never a smaller tile
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    int best = 0;
    for (int block = 128; block <= MAX_BLOCK; block *= 2) {
        const int rays = block / lanes;
        // one tile never holds more than ~4,800 triangles; the cap keeps
        // the byte counts inside an int
        int tile = std::min(n_tris, 1 << 16);
        if (smem_bytes(tile, rays, any) > max_smem) {
            // the largest multiple of 16 triangles that fits
            tile = (max_smem - RAY_FLOATS * 4 * rays - 32) / (4 * TRI_FLOATS + (any ? 1 : 0))
                   & ~15;
        }
        if (tile < 16 && tile < n_tris) continue;
        const int smem = smem_bytes(tile, rays, any);
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem);
        if (err != cudaSuccess) return (int)err;
        if (blocks * block > best) {
            best = blocks * block;
            *cfg = Config{lanes, block, tile, smem};
        }
    }
    *resident = (long long)sms * best;
    return best > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The configuration of each lane count (1, 2, 4, 8) for one device, scene
// size and entry, with the card's resident threads at each; computed at the
// first launch of that shape and kept (a ring of the last 16 shapes).
struct Plan {
    int dev, n_tris;
    bool any;
    Config cfg[4];
    long long resident[4];
};
std::mutex plan_mutex;
Plan plans[16];
int n_plans = 0;

template <typename K1, typename K2, typename K4, typename K8>
int plan_for(K1 k1, K2 k2, K4 k4, K8 k8, int n_tris, bool any, Plan* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    std::lock_guard<std::mutex> lock(plan_mutex);
    for (int i = 0; i < std::min(n_plans, 16); ++i) {
        const Plan& p = plans[i];
        if (p.dev == dev && p.n_tris == n_tris && p.any == any) {
            *out = p;
            return 0;
        }
    }
    int max_smem = 0, sms = 0;
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    Plan p{dev, n_tris, any, {}, {}};
    int rc = configure(k1, n_tris, 1, any, max_smem, sms, &p.cfg[0], &p.resident[0]);
    if (rc == 0) rc = configure(k2, n_tris, 2, any, max_smem, sms, &p.cfg[1], &p.resident[1]);
    if (rc == 0) rc = configure(k4, n_tris, 4, any, max_smem, sms, &p.cfg[2], &p.resident[2]);
    if (rc == 0) rc = configure(k8, n_tris, 8, any, max_smem, sms, &p.cfg[3], &p.resident[3]);
    if (rc != 0) return rc;
    plans[n_plans++ % 16] = p;
    *out = p;
    return 0;
}

// Lanes per ray when the caller leaves the choice (lanes 0): the largest of
// 8, 4, 2 that keeps every ray's lanes within one wave of resident threads
// and has no more lanes than triangles; else 1.
int choose(const Plan& p, int n_rays, int lanes, Config* cfg) {
    for (int i = 3; i >= 0; --i) {
        const int l = 1 << i;
        if (lanes != 0 ? l == lanes
                       : (l == 1 || (l <= p.n_tris && (long long)n_rays * l <= p.resident[i]))) {
            *cfg = p.cfg[i];
            return 0;
        }
    }
    return (int)cudaErrorInvalidValue;   // lanes not one of 0, 1, 2, 4, 8
}

int grid_of(int n_rays, const Config& c) {
    const int per_block = c.block / c.lanes;
    return (n_rays + per_block - 1) / per_block;
}

void report(const Config& c, int* out) {
    if (out != nullptr) {
        out[0] = c.lanes; out[1] = c.block; out[2] = c.tile; out[3] = c.smem;
    }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns a CUDA error code (0 = ok).
// lanes: 0 lets the launcher choose, else 1, 2, 4 or 8. config, if not
// null, receives (lanes, block, tile, shared memory bytes) of the launch.
int brute_closest(const float* o, const float* d, const float* tmax,
                  const float* tris, int n_rays, int n_tris, int* key,
                  int* base, int lanes, int* config, void* stream) {
    Plan p;
    Config c{};
    int rc = plan_for(brute_closest_kernel<1>, brute_closest_kernel<2>, brute_closest_kernel<4>,
                      brute_closest_kernel<8>, n_tris, false, &p);
    if (rc == 0) rc = choose(p, n_rays, lanes, &c);
    if (rc != 0) return rc;
    report(c, config);
    const dim3 grid(grid_of(n_rays, c));
    const cudaStream_t s = (cudaStream_t)stream;
    switch (c.lanes) {
        case 1: brute_closest_kernel<1><<<grid, c.block, c.smem, s>>>(
                    o, d, tmax, tris, n_rays, n_tris, c.tile, key, base); break;
        case 2: brute_closest_kernel<2><<<grid, c.block, c.smem, s>>>(
                    o, d, tmax, tris, n_rays, n_tris, c.tile, key, base); break;
        case 4: brute_closest_kernel<4><<<grid, c.block, c.smem, s>>>(
                    o, d, tmax, tris, n_rays, n_tris, c.tile, key, base); break;
        default: brute_closest_kernel<8><<<grid, c.block, c.smem, s>>>(
                    o, d, tmax, tris, n_rays, n_tris, c.tile, key, base); break;
    }
    return (int)cudaGetLastError();
}

int brute_any_hit(const float* o, const float* d, const float* limit,
                  const float* tris, const uint8_t* opaque, int n_rays,
                  int n_tris, uint8_t* blocked, int lanes, int* config, void* stream) {
    Plan p;
    Config c{};
    int rc = plan_for(brute_any_hit_kernel<1>, brute_any_hit_kernel<2>, brute_any_hit_kernel<4>,
                      brute_any_hit_kernel<8>, n_tris, true, &p);
    if (rc == 0) rc = choose(p, n_rays, lanes, &c);
    if (rc != 0) return rc;
    report(c, config);
    const dim3 grid(grid_of(n_rays, c));
    const cudaStream_t s = (cudaStream_t)stream;
    switch (c.lanes) {
        case 1: brute_any_hit_kernel<1><<<grid, c.block, c.smem, s>>>(
                    o, d, limit, tris, opaque, n_rays, n_tris, c.tile, blocked); break;
        case 2: brute_any_hit_kernel<2><<<grid, c.block, c.smem, s>>>(
                    o, d, limit, tris, opaque, n_rays, n_tris, c.tile, blocked); break;
        case 4: brute_any_hit_kernel<4><<<grid, c.block, c.smem, s>>>(
                    o, d, limit, tris, opaque, n_rays, n_tris, c.tile, blocked); break;
        default: brute_any_hit_kernel<8><<<grid, c.block, c.smem, s>>>(
                    o, d, limit, tris, opaque, n_rays, n_tris, c.tile, blocked); break;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
