// CheapTrick pitch-adaptive windowing.
//
// Replaces tpuvc/ops/pallas_window.py:windowed_frames_pallas (_kernel): a
// Hanning window over 3/f0 seconds with a support mask, the window-weighted
// mean removed from the windowed frame, and the window power.  Per frame of
// w samples, with base = col - w/2, t = base / fs:
//   half_len = rintf(1.5 fs / f0)     (true division, round half to even,
//                                      as the XLA path and the plain version)
//   win      = |base| <= half_len ? 0.5 + 0.5 cosf(pi t f0 / 1.5) : 0
//   out      = x win - win * (sum x win / fmaxf(sum win, 1e-12))
//   power    = fmaxf(sum win^2, 1e-12)
// The Pallas kernel's floor(x + 0.5) differs from rintf only on exact
// halves.
//
// Bound: device-memory bytes.  The whole [N, w] output is written (it feeds
// the power spectrum), but only the window's support has to be read: ±1.5
// periods, 193-481 of 1024 columns at 100-250 Hz and 97 on unvoiced frames
// (500 Hz).  The first design gave each frame one 256-thread block that
// read the whole row and chained three block reductions (two barriers and
// a serial read of 8 partials each), so the barrier chain set its time: it
// ran at 39-42% of the full-row bound.  This design:
// - one warp per frame, kWarps frames per block, no barrier; the frame's
//   support [w/2 - half_len, w/2 + half_len] ∩ [0, w) covers the float4s
//   [qs, qe] of the row (w a multiple of 4, rows 16-byte aligned: the
//   launcher refuses anything else);
// - only those float4s are loaded and windowed (accurate cosf); every other
//   one is written as 0.  That is exact for finite inputs: the plain
//   version gives x * 0 - 0 * mean = ±0 there, and adds x * 0 = ±0 to its
//   sums, which leaves them unchanged.  A NaN or inf outside the window no
//   longer reaches this output (dsp/cheaptrick.py makes those frames' rows
//   NaN from the waveform, as the reference's are);
// - a support of at most 32 * kSlots float4s (512 columns: f0 >= ~94.5 Hz
//   at 16 kHz, and every unvoiced frame) sits in registers, lane l holding
//   float4s qs + 32 j + l, from the load through the sums to the store.
//   Registers for all 8 float4s a lane owns of a 1024-sample row would
//   double the kernel's registers and halve the warps an SM holds, which
//   the window arithmetic (two true divisions and a cosf per column) needs
//   to overlap the stores.  A wider support takes two passes over its
//   float4s instead: the sums, then the samples re-read (L1/L2) and
//   windowed again for the store;
// - the three sums in one interleaved xor-shuffle reduction (5 levels x 3
//   values), after which every lane holds them.
// Only the order of the three sums differs from the plain version's
// (rtol 1e-5 / atol 1e-6 in the tests and chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;         // frames per block
constexpr int kSlots = 4;         // float4s per lane held in registers

struct Sums {
    float w, x, w2;
};

// one column: its window value into wv, the windowed sample into x, both
// added to the sums
__device__ __forceinline__ void window_col(int col, int w, float fs, float f,
                                           float half_len, float& x,
                                           float& wv, Sums& s) {
    const float pi = (float)3.14159265358979323846;
    const float base = (float)(col - w / 2);
    const float t = base / fs;
    wv = fabsf(base) <= half_len ? 0.5f + 0.5f * cosf(pi * t * f / 1.5f)
                                 : 0.0f;
    x *= wv;
    s.w += wv;
    s.x += x;
    s.w2 += wv * wv;
}

__device__ __forceinline__ void window_quad(int q, int w, float fs, float f,
                                            float half_len, float4& x,
                                            float4& wv, Sums& s) {
    window_col(4 * q, w, fs, f, half_len, x.x, wv.x, s);
    window_col(4 * q + 1, w, fs, f, half_len, x.y, wv.y, s);
    window_col(4 * q + 2, w, fs, f, half_len, x.z, wv.z, s);
    window_col(4 * q + 3, w, fs, f, half_len, x.w, wv.w, s);
}

__device__ __forceinline__ void warp_sums(Sums& s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
        s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
        s.w2 += __shfl_xor_sync(0xffffffffu, s.w2, off);
    }
}

__device__ __forceinline__ float4 centred(float4 x, float4 wv, float mean) {
    return make_float4(x.x - wv.x * mean, x.y - wv.y * mean,
                       x.z - wv.z * mean, x.w - wv.w * mean);
}

__device__ __forceinline__ void zero_outside(float4* orow, int nq, int qs,
                                             int qe, int lane) {
    for (int q = lane; q < nq; q += 32)
        if (q < qs || q > qe) orow[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kWarps * 32)
windowed_frames_kernel(const float4* __restrict__ seg_raw,
                       const float* __restrict__ f0, float4* __restrict__ out,
                       float* __restrict__ wp, int n, int w, float fs) {
    const int lane = threadIdx.x & 31;
    const long long frame = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (frame >= n) return;            // the whole warp leaves together
    const int nq = w / 4;
    const float4* row = seg_raw + frame * nq;
    float4* orow = out + frame * nq;
    const float f = f0[frame];
    const float half_len = rintf(1.5f * fs / f);
    // the support's columns [lo, hi] and float4s [qs, qe]; h clamped so the
    // int conversion is exact (a NaN half length gives the whole row, where
    // the mask is false)
    const int h = (int)fmaxf(fminf(half_len, (float)w), -1.0f);
    const int lo = max(w / 2 - h, 0), hi = min(w / 2 + h, w - 1);
    const int qs = lo / 4, qe = lo <= hi ? hi / 4 : qs - 1;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    Sums s = {0.0f, 0.0f, 0.0f};
    if (qe - qs < 32 * kSlots) {
        float4 xw[kSlots], win[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const int q = qs + 32 * j + lane;
            xw[j] = q <= qe ? __ldg(row + q) : zero;
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const int q = qs + 32 * j + lane;
            win[j] = zero;
            if (q <= qe) window_quad(q, w, fs, f, half_len, xw[j], win[j], s);
        }
        warp_sums(s);
        const float mean = s.x / fmaxf(s.w, 1e-12f);
        zero_outside(orow, nq, qs, qe, lane);
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const int q = qs + 32 * j + lane;
            if (q <= qe) orow[q] = centred(xw[j], win[j], mean);
        }
    } else {
        for (int q = qs + lane; q <= qe; q += 32) {
            float4 x = __ldg(row + q), wv;
            window_quad(q, w, fs, f, half_len, x, wv, s);
        }
        warp_sums(s);
        const float mean = s.x / fmaxf(s.w, 1e-12f);
        zero_outside(orow, nq, qs, qe, lane);
        for (int q = qs + lane; q <= qe; q += 32) {
            float4 x = __ldg(row + q), wv;
            Sums unused = {0.0f, 0.0f, 0.0f};
            window_quad(q, w, fs, f, half_len, x, wv, unused);
            orow[q] = centred(x, wv, mean);
        }
    }
    if (lane == 0) wp[frame] = fmaxf(s.w2, 1e-12f);
}

}  // namespace

extern "C" int tpuvc_windowed_frames(const float* seg_raw, const float* f0,
                                     float* out, float* wp, int n, int w,
                                     float fs, cudaStream_t stream) {
    if (w < 4 || w % 4 != 0 ||
        reinterpret_cast<uintptr_t>(seg_raw) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        windowed_frames_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                                 stream>>>(
            reinterpret_cast<const float4*>(seg_raw), f0,
            reinterpret_cast<float4*>(out), wp, n, w, fs);
    }
    return (int)cudaGetLastError();
}
