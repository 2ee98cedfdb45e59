// The samplers' counter-based draw for Hopper (sm_90a): core/rng.py's
// hash_u32(*parts), and uniform(*parts) = the top 24 bits of it as a
// float32 in [0, 1), in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this chain of uint32
// multiplies, shifts and xors to XLA, which fuses it into one loop. The
// port's eager version holds uint32 values in int64 tensors (torch has no
// wrapping uint32 multiply), splits every multiply into 16-bit halves and
// masks after each step: ~96 elementwise launches a draw over 2^18 to
// 2^19 lanes, every sample of every render drawn through it.
//
// What bounds it: bytes. Each tensor part is read once (4 or 8 B a lane)
// and the output written once (4 B a float, 8 B an int64): 10.5 MB for
// the main path's draw at 2^19 lanes (int64 pixel and sample indices, a
// float out), 3.1 us at 3.35 TB/s. The mix is ~20 integer instructions a
// part and lane, far below the issue rate. What the design does about it:
// one thread takes a pair of neighbouring lanes, so a pair of int64 parts
// is one 16-byte load and neighbouring threads read neighbouring pairs; a
// grid-stride loop over the pairs; no shared memory, nothing allocated.
//
// A part is one of: a scalar passed by value (a Python int, already
// reduced mod 2^32), one int32 or int64 element read by every lane (a
// 0-dim or one-element tensor), or a contiguous int32 or int64 tensor of
// the output's size. An int32 part's bits are its value mod 2^32, as an
// int64 one's low word is: exactly the twin's `x.to(int64) & 0xFFFFFFFF`.
// Capturable in a CUDA graph: no host read, no copy from the host, the
// scalars passed by value, only a launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;     // eight blocks on each of the H100's 132 SMs
constexpr int MAX_PARTS = 4;

// How a part arrives (the `kind` of each part).
enum Kind : int { SCALAR = 0, ONE_I32 = 1, ONE_I64 = 2, FULL_I32 = 3, FULL_I64 = 4 };

struct Parts {
    const void* ptr[MAX_PARTS];
    int kind[MAX_PARTS];
    uint32_t value[MAX_PARTS];
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x = (x ^ (x >> 16)) * 0x7FEB352Du;
    x = (x ^ (x >> 15)) * 0x846CA68Bu;
    return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t part) {
    return mix32(part + acc * 0x85EBCA6Bu + 0xC2B2AE35u);
}

// The low words of a part at lanes i and i + 1 (`pair`: both exist and
// the loads are aligned; the wrapper hands only pair-aligned tensors).
__device__ __forceinline__ void load_part(const Parts& p, int k, long long i, bool pair,
                                          uint32_t& a, uint32_t& b) {
    switch (p.kind[k]) {
    case SCALAR:
        a = b = p.value[k];
        break;
    case ONE_I32:
        a = b = (uint32_t)__ldg((const int32_t*)p.ptr[k]);
        break;
    case ONE_I64:
        a = b = (uint32_t)__ldg((const long long*)p.ptr[k]);
        break;
    case FULL_I32:
        if (pair) {
            const int2 v = __ldg((const int2*)((const int32_t*)p.ptr[k] + i));
            a = (uint32_t)v.x;
            b = (uint32_t)v.y;
        } else {
            a = b = (uint32_t)__ldg((const int32_t*)p.ptr[k] + i);
        }
        break;
    default:  // FULL_I64
        if (pair) {
            const longlong2 v = __ldg((const longlong2*)((const long long*)p.ptr[k] + i));
            a = (uint32_t)v.x;
            b = (uint32_t)v.y;
        } else {
            a = b = (uint32_t)__ldg((const long long*)p.ptr[k] + i);
        }
        break;
    }
}

__device__ __forceinline__ void store(float* out, long long i, bool pair, uint32_t a,
                                      uint32_t b) {
    const float ua = (float)(a >> 8) * (1.0f / 16777216.0f);
    const float ub = (float)(b >> 8) * (1.0f / 16777216.0f);
    if (pair) *(float2*)(out + i) = make_float2(ua, ub);
    else out[i] = ua;
}

__device__ __forceinline__ void store(long long* out, long long i, bool pair, uint32_t a,
                                      uint32_t b) {
    if (pair) *(longlong2*)(out + i) = make_longlong2((long long)a, (long long)b);
    else out[i] = (long long)a;
}

// Out: float (uniform) or long long (the bits, in [0, 2^32)).
template <int NPARTS, typename Out>
__global__ void __launch_bounds__(THREADS)
draw_kernel(Parts parts, long long n, Out* __restrict__ out) {
    const long long pairs = (n + 1) >> 1;
    for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < pairs;
         j += (long long)gridDim.x * THREADS) {
        const long long i = j << 1;
        const bool pair = i + 1 < n;
        uint32_t acc_a = 0x9E3779B9u, acc_b = 0x9E3779B9u;
#pragma unroll
        for (int k = 0; k < NPARTS; ++k) {
            uint32_t a, b;
            load_part(parts, k, i, pair, a, b);
            acc_a = combine(acc_a, a);
            acc_b = combine(acc_b, b);
        }
        store(out, i, pair, acc_a, acc_b);
    }
}

template <typename Out>
cudaError_t launch(int n_parts, const Parts& parts, long long n, Out* out, cudaStream_t s) {
    const long long pairs = (n + 1) >> 1;
    long long blocks = (pairs + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    switch (n_parts) {
    case 1: draw_kernel<1, Out><<<(int)blocks, THREADS, 0, s>>>(parts, n, out); break;
    case 2: draw_kernel<2, Out><<<(int)blocks, THREADS, 0, s>>>(parts, n, out); break;
    case 3: draw_kernel<3, Out><<<(int)blocks, THREADS, 0, s>>>(parts, n, out); break;
    default: draw_kernel<4, Out><<<(int)blocks, THREADS, 0, s>>>(parts, n, out); break;
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_parts (1 to 4) parts, part k given by ptr[k] (a device pointer, unread
// for a SCALAR), kind[k] (enum Kind) and value[k] (the scalar's value mod
// 2^32, unread otherwise); n >= 1 output lanes, written whole: uniform
// floats where `as_float`, else int64 bits. A FULL part holds n elements,
// and it and `out` are aligned to a pair of their elements. Launches on
// `stream`; returns a CUDA error code (0 = ok).
int rng_draw(int n_parts, const void* const* ptr, const int* kind, const uint32_t* value,
             long long n, int as_float, void* out, void* stream) {
    if (n_parts < 1 || n_parts > MAX_PARTS || n < 1) return (int)cudaErrorInvalidValue;
    Parts parts = {};
    for (int k = 0; k < n_parts; ++k) {
        if (kind[k] < SCALAR || kind[k] > FULL_I64) return (int)cudaErrorInvalidValue;
        if (kind[k] != SCALAR && ptr[k] == nullptr) return (int)cudaErrorInvalidValue;
        parts.ptr[k] = ptr[k];
        parts.kind[k] = kind[k];
        parts.value[k] = value[k];
    }
    const cudaStream_t s = (cudaStream_t)stream;
    if (as_float) return (int)launch(n_parts, parts, n, (float*)out, s);
    return (int)launch(n_parts, parts, n, (long long*)out, s);
}

}  // extern "C"
