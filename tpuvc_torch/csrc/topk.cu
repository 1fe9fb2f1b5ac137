// Exact sum of the kk largest values of each row — D4C's band statistic.
//
// Replaces tpuvc/ops/pallas_topk.py:topk_sum_pallas (_kernel), which runs kk
// rounds of an iterated max: add the row maximum to the sum, mask its
// lowest column to -inf.  One warp per row, kWarps rows per block, the
// row's c <= 512 floats in registers, 16 per lane.
//
// Bound: device-memory bytes — the [N, c] block is read once (210 MB at
// [102528, 512]: ~63 us at 3.35 TB/s).  The first design followed the
// Pallas body round by round: each of the kk rounds rescanned all 16
// registers of every lane carrying a column index, ran a 5-shuffle warp max
// and a second 5-shuffle warp min over the lowest column holding it, and
// compared all 16 registers again to mask it: about 2,000 warp
// instructions and 210 shuffles per row, bound by instruction issue and the
// serial shuffle chain, at 15% of the bytes bound.  This design:
// - each lane sorts its 16 values once, non-increasing, with a 16-input
//   bitonic network (80 compare-exchanges of fmaxf/fminf on registers,
//   every index static);
// - then kk rounds over the 32 lane heads only: the warp max of the heads
//   (5 shuffles), __ballot_sync(head == max) and __ffs for the lowest lane
//   holding it, which shifts its sorted registers up by one (-inf in the
//   last slot); the max is added to the sum.  No column index is carried:
//   about 30 instructions and 5 shuffles per round;
// - rows of a multiple of 4 floats on a 16-byte aligned base load as
//   float4 (lane l holds columns 4 (l + 32 j) + e); other rows load one
//   coalesced float per column (lane l holds l + 32 j).
//
// Premise for bit-equality with the plain version and the Pallas kernel:
// the heads' maxima come out as the row's values in non-increasing order,
// the same multiset as the iterated max-and-mask produces, whatever the
// column layout.  Equal values are interchangeable, so which occurrence
// leaves does not change the sum.  +0 and -0 compare equal and may come out
// in either order (fmaxf/fminf and the shuffle max may also return either
// sign of zero): the sum starts at +0 and adds each max rounded
// (__fadd_rn), acc + (+-0) = acc for acc != 0 and +0 + (-0) = +0, so the
// sum never becomes -0 and its bits are the same.  This holds for finite
// values and -inf padding (tests/test_torch_ops.py renders the algorithm
// in torch and holds it bit-equal to the plain version).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPerLane = 16;
constexpr int kMaxCols = 32 * kPerLane;
constexpr int kWarps = 8;

// v into non-increasing order: a 16-input bitonic network
__device__ __forceinline__ void sort_desc(float (&v)[kPerLane]) {
#pragma unroll
    for (int k = 2; k <= kPerLane; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
                const int l = i ^ j;
                if (l > i) {
                    const float hi = fmaxf(v[i], v[l]);
                    const float lo = fminf(v[i], v[l]);
                    const bool desc = (i & k) == 0;
                    v[i] = desc ? hi : lo;
                    v[l] = desc ? lo : hi;
                }
            }
        }
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
topk_sum_kernel(const float* __restrict__ ps, float* __restrict__ out,
                int n, int c, int kk) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= n) return;              // the whole warp leaves together
    const float* src = ps + row * c;
    float v[kPerLane];
    if (kVec) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int j = 0; j < kPerLane / 4; ++j) {
            const int q = lane + 32 * j;
            const float4 x = q < c / 4 ? __ldg(src4 + q)
                                       : make_float4(-INFINITY, -INFINITY,
                                                     -INFINITY, -INFINITY);
            v[4 * j] = x.x;
            v[4 * j + 1] = x.y;
            v[4 * j + 2] = x.z;
            v[4 * j + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            const int col = lane + 32 * j;
            v[j] = col < c ? __ldg(src + col) : -INFINITY;
        }
    }
    sort_desc(v);
    float acc = 0.0f;
    for (int r = 0; r < kk; ++r) {
        float m = v[0];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const unsigned hit = __ballot_sync(0xffffffffu, v[0] == m);
        const bool pop = lane == __ffs(hit) - 1;
#pragma unroll
        for (int j = 0; j < kPerLane - 1; ++j) v[j] = pop ? v[j + 1] : v[j];
        v[kPerLane - 1] = pop ? -INFINITY : v[kPerLane - 1];
        acc = __fadd_rn(acc, m);
    }
    if (lane == 0) out[row] = acc;
}

}  // namespace

extern "C" int tpuvc_topk_sum(const float* ps, float* out, int n, int c,
                              int kk, cudaStream_t stream) {
    if (c < 1 || c > kMaxCols || kk < 1 || kk > c)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        const int blocks = (n + kWarps - 1) / kWarps;
        if (c % 4 == 0 && reinterpret_cast<uintptr_t>(ps) % 16 == 0)
            topk_sum_kernel<true><<<blocks, 32 * kWarps, 0, stream>>>(
                ps, out, n, c, kk);
        else
            topk_sum_kernel<false><<<blocks, 32 * kWarps, 0, stream>>>(
                ps, out, n, c, kk);
    }
    return (int)cudaGetLastError();
}
