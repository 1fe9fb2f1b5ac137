// Pitch-adaptive harmonic DFT: StoneMask's instantaneous-frequency pass
// (harmonic_dft) and Harvest's two refinement phases with the glue between
// them (refine_score).
//
// harmonic_dft replaces tpuvc/ops/pallas_harmonics.py:harmonic_dft_pallas
// (_kernel, _slot_folded, _slot, _fold_eo).  One block per (frame, slot).
// Folded: lanes b = 0..W/2-1 read e[b] = seg[c+b] + seg[c-b] (e[0] =
// seg[c]) and o[b] = seg[c+b] - seg[c-b] (o[0] = 0) straight from the row;
// unfolded: lanes 0..W-1 with base = col - W/2.
//
// refine_score replaces tpuvc/ops/pallas_harmonics.py:refine_score_pallas
// (_refine_kernel, _refine_math).  One block per frame: the row is folded
// into shared memory once; then, for each candidate slot with f0 > 0, pass
// 1 (the DFT with the derivative window at the candidate), the glue of
// _refine_math on one thread (IF-weighted refined f0 and the accept gate),
// and, if the refinement is accepted, pass 2 (the DFT and energy at the
// refined f0) and the harmonic-concentration score.  An empty or rejected
// slot writes 0 without a pass, as the Pallas outputs are 0 there.  Nothing
// of the per-harmonic sums leaves the chip.
//
// Both run one slot through slot_partials: each lane evaluates the
// Blackman window over +-1.5 periods from one cosf/sinf pair, the harmonic
// bases by the triple-angle + angle-addition recurrence, and accumulates
// the partial sums in registers; the window sits in shared memory so the
// derivative window -0.5 (win[b+1] - win[b-1]) reads its neighbours.
// block_sums finishes (warp shuffles, then one warp over the partials).
//
// Bound: at 768-1024 samples per row both read each row once (393-420 MB
// at the main path's shapes, ~0.12 ms at 3.35 TB/s); the work per lane is
// two accurate transcendentals and ~100 flops per slot and pass, and each
// slot ends in a block reduction of 25 (pass 1) or 13 (pass 2) sums.  The
// design reads each row once, keeps every intermediate on chip and writes
// 25 floats per (frame, slot) (harmonic_dft) or 2 (refine_score).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHarm = 6;
// accumulator layout: x_re [0, 6), x_im [6, 12), energy 12,
// d_re [13, 19), d_im [19, 25); a pass without the derivative window
// needs the first kNoIf only
constexpr int kEn = 2 * kHarm;
constexpr int kDre = kEn + 1;
constexpr int kDim = kDre + kHarm;
constexpr int kSums = kDim + kHarm;
constexpr int kNoIf = kEn + 1;
constexpr int kMaxLanes = 2048;
constexpr int kDftThreads = 256;
constexpr int kRefineThreads = 128;
constexpr int kRefineMaxHalf = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// Block sums of acc[0, kN) into out_s (shared); ends in a barrier, so
// out_s is visible to every thread and the caller may reuse shared memory.
template <int kN, int kThreads>
__device__ __forceinline__ void block_sums(const float (&acc)[kSums],
                                           float (*part)[kSums],
                                           float* out_s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
        float v = warp_sum(acc[i]);
        if (lane == 0) part[warp][i] = v;
    }
    __syncthreads();
    if (warp == 0) {
        for (int i = 0; i < kN; ++i) {
            float v = lane < kThreads / 32 ? part[lane][i] : 0.0f;
            v = warp_sum(v);
            if (lane == 0) out_s[i] = v;
        }
    }
    __syncthreads();
}

// This thread's partial sums of one slot at frequency f (already clamped).
// fetch(b, a, o) gives lane b's even/odd pair (folded) or its sample twice
// (unfolded).  Every thread of the block calls it; win_s must be free.
template <bool kIf, int kThreads, class Fetch>
__device__ __forceinline__ void slot_partials(Fetch fetch, float f, float fs,
                                              int lanes, int c, bool fold,
                                              float* win_s,
                                              float (&acc)[kSums]) {
    const float half_len = floorf(1.5f * fs / f + 1.0f);
    const float kphase =
        (float)(2.0 * 3.14159265358979323846 / (3.0 * (double)fs));
    for (int b = threadIdx.x; b < lanes; b += kThreads) {
        float pos = fold ? (float)b : (float)(b - c);
        bool m = fabsf(pos) <= half_len;
        float cp = cosf(kphase * f * pos);
        win_s[b] = m ? 0.42f + 0.5f * cp + 0.08f * (2.0f * cp * cp - 1.0f)
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
    for (int b = threadIdx.x; b < lanes; b += kThreads) {
        float pos = fold ? (float)b : (float)(b - c);
        bool m = fabsf(pos) <= half_len;
        float ph = kphase * f * pos;
        float cp = cosf(ph);
        float sp = sinf(ph);
        float win = win_s[b];
        float a, o;
        fetch(b, a, o);
        a = m ? a : 0.0f;
        o = m ? o : 0.0f;
        float we = a * win, wo = o * win;
        if (fold) {
            float h0 = b == 0 ? 1.0f : 0.5f;
            acc[kEn] += h0 * (we * we + wo * wo);
        } else {
            acc[kEn] += we * we;
        }
        float de = 0.0f, dd = 0.0f;
        if (kIf) {
            bool edge = fold ? (b == 0 || b >= lanes - 1)
                             : (b == 0 || b == lanes - 1);
            float dwin = edge ? 0.0f : -0.5f * (win_s[b + 1] - win_s[b - 1]);
            de = a * dwin;
            dd = o * dwin;
        }
        float c1 = cp * (4.0f * cp * cp - 3.0f);
        float s1 = sp * (3.0f - 4.0f * sp * sp);
        float ch = c1, sh = s1;
#pragma unroll
        for (int h = 0; h < kHarm; ++h) {
            if (h) {
                float nc = ch * c1 - sh * s1;
                float ns = sh * c1 + ch * s1;
                ch = nc;
                sh = ns;
            }
            acc[h] += we * ch;                  // x_re
            acc[kHarm + h] -= wo * sh;          // x_im
            if (kIf) {
                acc[kDre + h] += dd * ch;       // d_re
                acc[kDim + h] -= de * sh;       // d_im
            }
        }
    }
}

__global__ void harmonic_dft_kernel(const float* __restrict__ seg,
                                    const float* __restrict__ f0,
                                    float* __restrict__ xre,
                                    float* __restrict__ xim,
                                    float* __restrict__ dre,
                                    float* __restrict__ dim,
                                    float* __restrict__ en, int k_slots,
                                    int w, float fs, int fold, int with_if) {
    __shared__ float win_s[kMaxLanes];
    __shared__ float part[kDftThreads / 32][kSums];
    __shared__ float sums[kSums];
    const int frame = blockIdx.x / k_slots;
    const int slot = blockIdx.x % k_slots;
    const float* row = seg + (long long)frame * w;
    const int c = w / 2;
    const int lanes = fold ? c : w;
    // clamp as the wrapper's plain version does: the fold floor keeps every
    // window inside the folded half-width, 1 Hz keeps 1/f0 finite
    // (constants rounded once from double, as Python computes them)
    const float floor_hz = fold ? (float)(1.5 * (double)fs / (double)(c - 3))
                                : 1.0f;
    const float f = fmaxf(f0[(long long)frame * k_slots + slot], floor_hz);
    auto fetch = [&](int b, float& a, float& o) {
        if (fold) {
            float r = row[c + b];
            float l = row[c - b];
            a = b == 0 ? 0.5f * (r + l) : r + l;
            o = r - l;
        } else {
            a = row[b];
            o = a;
        }
    };
    float acc[kSums];
    if (with_if) {
        slot_partials<true, kDftThreads>(fetch, f, fs, lanes, c, fold,
                                         win_s, acc);
        block_sums<kSums, kDftThreads>(acc, part, sums);
    } else {
        slot_partials<false, kDftThreads>(fetch, f, fs, lanes, c, fold,
                                          win_s, acc);
        block_sums<kNoIf, kDftThreads>(acc, part, sums);
    }
    if (threadIdx.x == 0) {
        const long long fs_ = (long long)frame * k_slots + slot;
        for (int h = 0; h < kHarm; ++h) {
            xre[fs_ * kHarm + h] = sums[h];
            xim[fs_ * kHarm + h] = sums[kHarm + h];
            if (with_if) {
                dre[fs_ * kHarm + h] = sums[kDre + h];
                dim[fs_ * kHarm + h] = sums[kDim + h];
            }
        }
        en[fs_] = sums[kEn];
    }
}

__global__ void refine_score_kernel(const float* __restrict__ seg,
                                    const float* __restrict__ f0,
                                    float* __restrict__ refined_out,
                                    float* __restrict__ score_out,
                                    int k_slots, int w, float fs,
                                    float floor_hz, float limit) {
    __shared__ float e_s[kRefineMaxHalf];
    __shared__ float o_s[kRefineMaxHalf];
    __shared__ float win_s[kRefineMaxHalf];
    __shared__ float part[kRefineThreads / 32][kSums];
    __shared__ float sums[kSums];
    __shared__ float rf_s;
    const long long frame = blockIdx.x;
    const float* row = seg + frame * w;
    const int c = w / 2;
    for (int b = threadIdx.x; b < c; b += kRefineThreads) {
        float r = row[c + b];
        float l = row[c - b];
        e_s[b] = b == 0 ? 0.5f * (r + l) : r + l;
        o_s[b] = r - l;
    }
    // (the first slot_partials barrier orders these writes before reads)
    auto fetch = [&](int b, float& a, float& o) {
        a = e_s[b];
        o = o_s[b];
    };
    const float fold_floor = (float)(1.5 * (double)fs / (double)(c - 3));
    const float nyq = (float)((double)fs / 2.0);
    const float if_scale = (float)((double)fs / (2.0 * 3.14159265358979323846));
    const float hw_num = (float)(1.5 * (double)fs);
    float acc[kSums];
    for (int slot = 0; slot < k_slots; ++slot) {
        const long long out = frame * k_slots + slot;
        const float f0k = f0[out];
        if (!(f0k > 0.0f)) {                     // block-uniform
            if (threadIdx.x == 0) {
                refined_out[out] = 0.0f;
                score_out[out] = 0.0f;
            }
            continue;
        }
        // pass 1: DFT with the derivative window at the candidate
        slot_partials<true, kRefineThreads>(fetch, fmaxf(f0k, fold_floor),
                                            fs, c, c, true, win_s, acc);
        block_sums<kSums, kRefineThreads>(acc, part, sums);
        if (threadIdx.x == 0) {
            const float f0c = fmaxf(f0k, floor_hz);
            float num = 0.0f, den = 0.0f;
            for (int h = 0; h < kHarm; ++h) {
                const float hh = (float)(h + 1);
                const float xr = sums[h], xi = sums[kHarm + h];
                const float dr = sums[kDre + h], di = sums[kDim + h];
                const float power = xr * xr + xi * xi + 1e-20f;
                const float amp = hh * f0c < nyq ? sqrtf(power) : 0.0f;
                const float ifs =
                    hh * f0c + (xr * di - xi * dr) / power * if_scale;
                num += amp * ifs / hh;
                den += amp;
            }
            const float refined = den > 0.0f ? num / fmaxf(den, 1e-12f)
                                             : 0.0f;
            const bool ok = refined > 0.0f
                && fabsf(refined - f0k) <= limit * fmaxf(f0k, 1e-12f);
            rf_s = ok ? fmaxf(refined, floor_hz) : 0.0f;
            refined_out[out] = ok ? refined : 0.0f;
            if (!ok) score_out[out] = 0.0f;
        }
        __syncthreads();
        const float rf = rf_s;
        if (rf == 0.0f) continue;                // rejected: block-uniform
        // pass 2: DFT and energy at the refined f0
        slot_partials<false, kRefineThreads>(fetch, fmaxf(rf, fold_floor),
                                             fs, c, c, true, win_s, acc);
        block_sums<kNoIf, kRefineThreads>(acc, part, sums);
        if (threadIdx.x == 0) {
            float amps = 0.0f, a1 = 0.0f, a2 = 0.0f;
            for (int h = 0; h < kHarm; ++h) {
                const float hh = (float)(h + 1);
                const float xr = sums[h], xi = sums[kHarm + h];
                const float power = xr * xr + xi * xi + 1e-20f;
                const float amp = hh * rf < nyq ? sqrtf(power) : 0.0f;
                amps += amp;
                if (h == 0) a1 = amp;
                if (h == 1) a2 = amp;
            }
            const float hw = floorf(hw_num / rf + 1.0f);
            const float winlen = 2.0f * hw + 1.0f;
            const float fft_size = exp2f(2.0f + ceilf(log2f(winlen)));
            const float total = sqrtf(fft_size * sums[kEn] / 2.0f + 1e-30f);
            score_out[out] = (amps / total) * (a1 / (a1 + a2 + 1e-30f));
        }
        // the next slot's first barrier orders sums/rf_s reuse after this
    }
}

}  // namespace

extern "C" int tpuvc_harmonic_dft(const float* seg, const float* f0,
                                  float* xre, float* xim, float* dre,
                                  float* dim, float* en, int n, int k_slots,
                                  int w, float fs, int fold, int with_if,
                                  cudaStream_t stream) {
    if (w > kMaxLanes || w < 8) return (int)cudaErrorInvalidValue;
    long long blocks = (long long)n * k_slots;
    if (blocks > 0) {
        harmonic_dft_kernel<<<(unsigned)blocks, kDftThreads, 0, stream>>>(
            seg, f0, xre, xim, dre, dim, en, k_slots, w, fs, fold, with_if);
    }
    return (int)cudaGetLastError();
}

extern "C" int tpuvc_refine_score(const float* seg, const float* f0,
                                  float* refined, float* score, int n,
                                  int k_slots, int w, float fs, float floor_hz,
                                  float limit, cudaStream_t stream) {
    if (w > 2 * kRefineMaxHalf || w < 8 || w % 2)
        return (int)cudaErrorInvalidValue;
    if (n > 0 && k_slots > 0) {
        refine_score_kernel<<<n, kRefineThreads, 0, stream>>>(
            seg, f0, refined, score, k_slots, w, fs, floor_hz, limit);
    }
    return (int)cudaGetLastError();
}
