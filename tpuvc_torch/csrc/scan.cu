// All eight block-level top-2 scans of the event pairs, in one pass.
//
// Replaces tpuvc/ops/pallas_events.py:top2_block_scans (_scan_kernel,
// _kogge_cummax).  Input and output [rows, 16, nb]: for event type t, rows
// 4t/4t+1 hold each block's sorted (largest, second) event times and become
// their PREFIX top-2 over blocks 0..k; rows 4t+2/4t+3 hold (smallest,
// second) and become their SUFFIX bottom-2 over blocks k..nb-1.
//
// The combine of sorted pairs
//     (x1, x2) (+) (y1, y2) = (max(x1, y1), max(min(x1, y1), max(x2, y2)))
// is associative and uses selections only, so any association gives the
// same bits as the cummax ladders of the plain version (with multiplicity:
// a duplicated maximum is its own runner-up).  The suffix scans use the
// mirrored min-combine and walk the row backwards, so there is no
// negate-and-flip relayout as in the TPU wrapper.
//
// One warp per scan (rows * 8 scans).  The warp walks its row in tiles of
// 32 blocks, 4 tiles per step (all loads of a step issued together,
// neighbouring lanes on neighbouring addresses); each tile is an inclusive
// Kogge-Stone scan over the lanes with __shfl_up_sync (5 levels), combined
// with the carry of the tiles before it (lane 31's result, broadcast).
//
// Bound: device-memory bytes — each pair row is read once and written once
// (2 x 4 B per value); a tile costs 10 shuffles and ~20 selections per
// lane, well under the bytes' time at these widths.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTiles = 4;

template <bool kMax>
struct Top2 {
    __device__ static float pick(float a, float b) {
        return kMax ? fmaxf(a, b) : fminf(a, b);
    }
    __device__ static float other(float a, float b) {
        return kMax ? fminf(a, b) : fmaxf(a, b);
    }
    // (a1, a2) <- (x1, x2) (+) (a1, a2); x is the earlier part of the scan
    __device__ static void combine(float x1, float x2, float& a1, float& a2) {
        const float lo = other(x1, a1);
        a1 = pick(x1, a1);
        a2 = pick(lo, pick(x2, a2));
    }
};

template <bool kMax>
__device__ void scan_row(const float* __restrict__ in1,
                         const float* __restrict__ in2,
                         float* __restrict__ out1, float* __restrict__ out2,
                         int nb, int lane) {
    using C = Top2<kMax>;
    const float fill = kMax ? -CUDART_INF_F : CUDART_INF_F;
    float c1 = fill, c2 = fill;           // the scan of every tile before
    for (int base = 0; base < nb; base += 32 * kTiles) {
        float v1[kTiles], v2[kTiles];
        int pos[kTiles];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
            // scan order index q: prefix walks forward, suffix backward
            const int q = base + 32 * j + lane;
            pos[j] = kMax ? q : nb - 1 - q;
            const bool ok = q < nb;
            v1[j] = ok ? in1[pos[j]] : fill;
            v2[j] = ok ? in2[pos[j]] : fill;
        }
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
            float a1 = v1[j], a2 = v2[j];
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float x1 = __shfl_up_sync(0xffffffffu, a1, off);
                const float x2 = __shfl_up_sync(0xffffffffu, a2, off);
                if (lane >= off) C::combine(x1, x2, a1, a2);
            }
            C::combine(c1, c2, a1, a2);
            if (base + 32 * j + lane < nb) {
                out1[pos[j]] = a1;
                out2[pos[j]] = a2;
            }
            c1 = __shfl_sync(0xffffffffu, a1, 31);
            c2 = __shfl_sync(0xffffffffu, a2, 31);
        }
    }
}

__global__ void top2_block_scans_kernel(const float* __restrict__ pairs,
                                        float* __restrict__ out, int rows,
                                        int nb) {
    const int lane = threadIdx.x & 31;
    const long long scan = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (scan >= (long long)rows * 8) return;   // the whole warp leaves
    const long long r = scan >> 3;
    const int t = (int)(scan & 7) >> 1;        // event type
    const bool suffix = scan & 1;
    const long long row0 = (r * 16 + 4 * t + (suffix ? 2 : 0)) * nb;
    if (suffix)
        scan_row<false>(pairs + row0, pairs + row0 + nb, out + row0,
                        out + row0 + nb, nb, lane);
    else
        scan_row<true>(pairs + row0, pairs + row0 + nb, out + row0,
                       out + row0 + nb, nb, lane);
}

}  // namespace

extern "C" int tpuvc_top2_block_scans(const float* pairs, float* out,
                                      int rows, int nb,
                                      cudaStream_t stream) {
    if (rows < 0 || nb < 0) return (int)cudaErrorInvalidValue;
    if (rows > 0 && nb > 0) {
        const long long scans = (long long)rows * 8;
        const int blocks = (int)((scans + kWarps - 1) / kWarps);
        top2_block_scans_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
            pairs, out, rows, nb);
    }
    return (int)cudaGetLastError();
}
