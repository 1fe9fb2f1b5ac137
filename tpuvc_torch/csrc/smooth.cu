// Per-frame rectangular (box) spectral smoothing — WORLD LinearSmoothing.
//
// Replaces tpuvc/ops/pallas_smooth.py:box_smooth_pallas (_kernel).  Output
// bin f of a frame is sum over o = -K..K of ext[K + o + f] * wgt[o], where
// ext is the half spectrum reflected evenly at DC and Nyquist and
//   wgt[o] = max(min(w/2, (o+.5) df) - max(-w/2, (o-.5) df), 0) / w
// is the overlap of the frame's box with bin o's cell.  The products and
// sums are rounded separately (__fmul_rn/__fadd_rn, no contraction) and
// taken in order o = -K..K, as the plain PyTorch version takes them, so the
// two are bit-equal.  A direct sum on purpose: cumulative-sum or FFT
// shortcuts lift the noise floor ~60 dB in -120 dB valleys.
//
// Bound: bytes.  Each frame reads half floats and writes half (8 bytes per
// bin at 3.35 TB/s); the multiply-adds of the frame's nonzero taps take
// less.  The first design (one block of 256 threads per frame, one thread
// per bin) fell far short of it: every tap cost two shared-memory reads per
// warp per 32 bins, it summed all 2K+1 taps although a frame's box covers
// only about w/df + 2 of them, 513 bins on 256 threads left a third round
// with one live thread, and the wrapper built the mirror-extended row in a
// separate pass.  This design:
// - one warp per frame, kWarps frames per block, no block barrier;
// - the warp stages the extended row in shared memory straight from ps
//   with the index map i < 0 -> -i, i >= half -> 2 (half - 1) - i (what the
//   wrapper's mirror_extend builds), one coalesced scalar load per element
//   (rows of 513 floats are not 16-byte aligned);
// - each lane computes kBins = 17 consecutive bins in registers; 17 is
//   coprime with the 32 banks, so row[lane * 17 + t] is conflict-free, and
//   per step of kStep taps a lane reads kBins + kStep - 1 row values and
//   kStep broadcast weights for kBins * kStep multiply-adds;
// - only the span from the frame's first to its last nonzero weight is
//   summed (rounded up to whole steps; the weights past 2K and the row past
//   its end are zeros).  A skipped term is +-0 times a finite value, and a
//   running sum that starts at +0 never becomes -0, so adding +-0 leaves it
//   unchanged: bit-equal for finite spectra (every spectrum on the path is
//   finite), but a NaN or inf outside the box no longer propagates;
// - the sums go back through the row's shared memory (its first 544 floats
//   are no longer read), so the stores are coalesced too.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // frames per block
constexpr int kBins = 17;              // output bins per lane
constexpr int kChunk = 32 * kBins;     // bins per warp pass (544 >= 513)
constexpr int kStep = 8;               // taps per unrolled step

__host__ __device__ inline int wgt_len(int k) { return 2 * k + kStep; }

__host__ __device__ inline int row_len(int half, int k) {
    // whole chunks of bins, 2K reflected taps and one step of padding
    return (half + kChunk - 1) / kChunk * kChunk + 2 * k + kStep;
}

__global__ void __launch_bounds__(kWarps * 32)
box_smooth_kernel(const float* __restrict__ ps,
                  const float* __restrict__ width, float* __restrict__ out,
                  int n, int half, int k, float df, float max_width) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long frame = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
    if (frame >= n) return;                // whole warps; no block barrier
    const unsigned all = 0xffffffffu;
    const int taps = 2 * k + 1;
    const int ext_len = half + 2 * k;
    const int rlen = row_len(half, k);
    float* wgt = smem + (size_t)warp * (wgt_len(k) + rlen);
    float* row = wgt + wgt_len(k);

    // the frame's weights, as the plain version computes them (cell bounds
    // from double, as its Python floats), and the nonzero span [lo, hi]
    const float w = fminf(width[frame], max_width);
    int lo = -1, hi = -1;
    for (int base = 0; base < wgt_len(k); base += 32) {
        const int i = base + lane;
        float v = 0.0f;
        if (i < taps) {
            const int o = i - k;
            const float cell_lo = (float)((double)o * df - 0.5 * df);
            const float cell_hi = (float)((double)o * df + 0.5 * df);
            const float a = fmaxf(-0.5f * w, cell_lo);
            const float b = fminf(0.5f * w, cell_hi);
            v = fmaxf(b - a, 0.0f) / w;
        }
        if (i < wgt_len(k)) wgt[i] = v;
        const unsigned nz = __ballot_sync(all, v != 0.0f);
        if (nz) {
            if (lo < 0) lo = base + __ffs(nz) - 1;
            hi = base + 31 - __clz(nz);
        }
    }

    // the mirror-extended row, straight from ps
    const float* src = ps + frame * half;
#pragma unroll 4
    for (int i = lane; i < ext_len; i += 32) {
        int e = i - k;
        e = e < 0 ? -e : (e >= half ? 2 * (half - 1) - e : e);
        row[i] = src[e];
    }
    for (int i = ext_len + lane; i < rlen; i += 32) row[i] = 0.0f;
    __syncwarp();

    const int steps = lo < 0 ? 0 : (hi - lo + kStep) / kStep;  // warp-uniform
    float* dst = out + frame * half;
    for (int c0 = 0; c0 < half; c0 += kChunk) {
        float acc[kBins];
#pragma unroll
        for (int j = 0; j < kBins; ++j) acc[j] = 0.0f;
        const float* r = row + c0 + lane * kBins + lo;
        const float* g = wgt + lo;
        for (int s = 0; s < steps; ++s, r += kStep, g += kStep) {
            float rv[kBins + kStep - 1], gv[kStep];
#pragma unroll
            for (int j = 0; j < kBins + kStep - 1; ++j) rv[j] = r[j];
#pragma unroll
            for (int t = 0; t < kStep; ++t) gv[t] = g[t];
#pragma unroll
            for (int t = 0; t < kStep; ++t) {
#pragma unroll
                for (int j = 0; j < kBins; ++j)
                    acc[j] = __fadd_rn(acc[j], __fmul_rn(rv[j + t], gv[t]));
            }
        }
        // row[c0, c0 + kChunk) is not read again: stage the sums there
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kBins; ++j) row[c0 + lane * kBins + j] = acc[j];
        __syncwarp();
        const int m = min(kChunk, half - c0);
        for (int f = lane; f < m; f += 32) dst[c0 + f] = row[c0 + f];
    }
}

}  // namespace

extern "C" int tpuvc_box_smooth(const float* ps, const float* width,
                                float* out, int n, int half, int k, float df,
                                float max_width, cudaStream_t stream) {
    const size_t per_warp =
        sizeof(float) * (size_t)(wgt_len(k) + row_len(half, k));
    if (per_warp > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int warps = (int)(48 * 1024 / per_warp) < kWarps
                          ? (int)(48 * 1024 / per_warp) : kWarps;
    if (n > 0) {
        const int blocks = (n + warps - 1) / warps;
        box_smooth_kernel<<<blocks, warps * 32, warps * per_warp, stream>>>(
            ps, width, out, n, half, k, df, max_width);
    }
    return (int)cudaGetLastError();
}
