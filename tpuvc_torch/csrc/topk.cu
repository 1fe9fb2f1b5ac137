// Exact sum of the kk largest values of each row — D4C's band statistic.
//
// Replaces tpuvc/ops/pallas_topk.py:topk_sum_pallas (_kernel).  One warp
// per row; the row's c <= 512 floats sit in registers, 16 per lane (lane l
// holds columns l, l + 32, ...; loads are coalesced across the warp).
// kk rounds, each as the Pallas body: the row maximum m (warp max by
// __shfl_xor_sync), then the lowest column holding m (a second shuffle
// reduction over each lane's lowest such column), which is set to -inf;
// m is added to the sum in pick order, so the sum rounds exactly as the
// Pallas kernel's and the plain version's.  A duplicated value is picked
// once per round, as a sort would.
//
// Bound: device-memory bytes — the [N, c] row block is read once (210 MB
// at [102528, 512]: ~63 us at 3.35 TB/s) against ~2 kk c compares per
// row.  The design reads each row once with coalesced loads and keeps
// every round in registers and shuffles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPerLane = 16;
constexpr int kMaxCols = 32 * kPerLane;
constexpr int kWarps = 8;

__global__ void topk_sum_kernel(const float* __restrict__ ps,
                                float* __restrict__ out, int n, int c,
                                int kk) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= n) return;              // the whole warp leaves together
    const float* src = ps + row * c;
    float v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
        const int col = lane + 32 * j;
        v[j] = col < c ? src[col] : -INFINITY;
    }
    float acc = 0.0f;
    for (int r = 0; r < kk; ++r) {
        // this lane's maximum and the lowest column holding it
        float m = v[0];
        int mi = lane;
#pragma unroll
        for (int j = 1; j < kPerLane; ++j) {
            if (v[j] > m) {
                m = v[j];
                mi = lane + 32 * j;
            }
        }
        float wm = m;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            wm = fmaxf(wm, __shfl_xor_sync(0xffffffffu, wm, off));
        int first = m >= wm ? mi : kMaxCols;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
        acc = __fadd_rn(acc, wm);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
            if (lane + 32 * j == first) v[j] = -INFINITY;
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
        topk_sum_kernel<<<blocks, 32 * kWarps, 0, stream>>>(ps, out, n, c,
                                                            kk);
    }
    return (int)cudaGetLastError();
}
