// Pitch-adaptive harmonic DFT: StoneMask's instantaneous-frequency pass
// (harmonic_dft) and Harvest's two refinement phases with the glue between
// them (refine_score).
//
// harmonic_dft replaces tpuvc/ops/pallas_harmonics.py:harmonic_dft_pallas
// (_kernel, _slot_folded, _slot, _fold_eo).  Folded: lanes b = 0..W/2-1
// read e[b] = seg[c+b] + seg[c-b] (e[0] = seg[c]) and o[b] = seg[c+b] -
// seg[c-b] (o[0] = 0) straight from the row; unfolded: lanes 0..W-1 with
// base = col - W/2.  Each lane evaluates the Blackman window over +-1.5
// periods and the harmonic bases (triple-angle + angle-addition recurrence)
// from one cos/sin pair and accumulates 25 sums (13 without the derivative
// window) in registers.
//
// Bound: bytes; each row is read once (420 MB at the main path's [102528,
// 1024], ~0.13 ms at 3.35 TB/s), and the lanes' own arithmetic (one
// accurate sincosf and ~110 flops per lane) is about twice that at the
// card's issue rate.  The first design ran one block of 256 threads per
// (frame, slot), 2 lanes of work a thread, at 11% of the bound: its 25-sum
// block reduction (shuffles in 8 warps, a barrier, warp 0 over the
// partials, a second barrier) outweighed the lanes' work, the window went
// through shared memory behind a barrier only for the derivative's
// neighbours, and each lane took three accurate transcendentals.  This
// design runs one warp per (frame, slot), kDftWarps of them per block and
// no block barrier: lanes b = j * 32 + lane (coalesced reads of both row
// halves), one sincosf per lane (the window's cosine is the phase cosine),
// the window's neighbours by shuffle (the ends of a block of 32 from the
// previous block's lane 31 and the next block's lane 0, computed one block
// ahead together with its samples), and one recursive-halving warp
// reduction of the sums, after which lane i holds sum i and stores it.
//
// refine_score replaces tpuvc/ops/pallas_harmonics.py:refine_score_pallas
// (_refine_kernel, _refine_math).  For each frame and candidate slot with
// f0 > 0: pass 1 (the DFT with the derivative window at the candidate), the
// glue of _refine_math (IF-weighted refined f0 and the accept gate), and,
// if the refinement is accepted, pass 2 (the DFT and energy at the refined
// f0) and the harmonic-concentration score.  An empty or rejected slot
// writes 0 without a pass, as the Pallas outputs are 0 there.  Nothing of
// the per-harmonic sums leaves the chip.  Bound: operations (the per-lane
// work of both passes over each slot's window support; 393 MB read once at
// Harvest's [128032, 768]).  The first design ran one 128-thread block per
// frame through its slots in series, at 12% of the bound: each pass wrote
// the window to shared memory behind a barrier, took three accurate
// transcendentals a lane, walked all 384 folded lanes, and ended in a block
// reduction of 25 sums (shuffles, a barrier, one warp over the partials, a
// second barrier) with the glue on one thread while the others waited.
// This design is harmonic_dft's, applied to the merged kernel: the folded
// row goes to shared memory once per frame, behind the block's only
// barrier; then one warp per slot runs warp_slot (one sincosf a lane, the
// derivative window's neighbours by shuffle) over only the blocks of 32
// lanes that meet the window (+-1.5 periods: 31-377 of 384 lanes at 63.9-
// 800 Hz), warp_sums, the glue on every lane from the sums gathered by
// shuffle (the same operations in the same order on each, so the accept
// gate is warp-uniform), then pass 2 the same way.  Empty and rejected
// slots are warp-uniform early exits.  The glue keeps _refine_math's order
// and clamps: harmonics added h = 0..5 in series, IEEE divisions.

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
constexpr int kDftWarps = 8;
constexpr int kRefineMaxWarps = 16;
constexpr int kRefineMaxHalf = 512;

// The warp's sums of acc[0, kN): lane i < kN returns the total of acc[i].
// Recursive halving: at each of 5 steps a lane keeps half of its live
// values and adds its partner's copy of them, 31 shuffles in all for up to
// 32 sums (the butterfly per sum would take 5 each).
template <int kN>
__device__ __forceinline__ float warp_sums(const float (&acc)[kSums]) {
    const int lane = threadIdx.x & 31;
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = i < kN ? acc[i] : 0.0f;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
        const bool upper = lane & step;
#pragma unroll
        for (int i = 0; i < step; ++i) {
            const float send = upper ? v[i] : v[i + step];
            const float keep = upper ? v[i + step] : v[i];
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, step);
        }
    }
    return v[0];
}

// One warp's sums of one slot at frequency f (already clamped), over lanes
// b = j * 32 + lane.  Each lane takes one sincosf per b (the window's
// cosine is the phase cosine); the derivative window's neighbours b +- 1
// come from the adjacent lanes by shuffle, and at the ends of a block of 32
// from the previous block's lane 31 (kept) and the next block's lane 0
// (computed one block ahead, with its samples).  fetch(b, a, o) gives
// lane b's even/odd pair (folded) or its sample twice (unfolded).  The warp
// walks the blocks of 32 that start below ``walk`` (<= lanes; the lanes
// past it must add only +-0 to every sum).
template <bool kIf, class Fetch>
__device__ __forceinline__ void warp_slot(Fetch fetch, float f, float fs,
                                          int lanes, int walk, int c,
                                          bool fold, float (&acc)[kSums]) {
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const float half_len = floorf(1.5f * fs / f + 1.0f);
    const float kf =
        (float)(2.0 * 3.14159265358979323846 / (3.0 * (double)fs)) * f;
    // lane b's window, phase cosine and sine, and masked samples
    auto at = [&](int b, float& win, float& cp, float& sp, float& a,
                  float& o) {
        const float pos = fold ? (float)b : (float)(b - c);
        const bool m = b < lanes && fabsf(pos) <= half_len;
        sincosf(kf * pos, &sp, &cp);
        win = m ? 0.42f + 0.5f * cp + 0.08f * (2.0f * cp * cp - 1.0f) : 0.0f;
        a = 0.0f;
        o = 0.0f;
        if (b < lanes) fetch(b, a, o);
        a = m ? a : 0.0f;
        o = m ? o : 0.0f;
    };
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
    float win, cp, sp, a, o;
    at(lane, win, cp, sp, a, o);
    float prev = 0.0f;                     // win[b0 - 1]
    for (int b0 = 0; b0 < walk; b0 += 32) {
        const int b = b0 + lane;
        float win_n = 0.0f, cp_n = 0.0f, sp_n = 0.0f, a_n = 0.0f, o_n = 0.0f;
        if (b0 + 32 < walk)                // warp-uniform
            at(b + 32, win_n, cp_n, sp_n, a_n, o_n);
        const float we = a * win, wo = o * win;
        if (fold) {
            const float h0 = b == 0 ? 1.0f : 0.5f;
            acc[kEn] += h0 * (we * we + wo * wo);
        } else {
            acc[kEn] += we * we;
        }
        float de = 0.0f, dd = 0.0f;
        if (kIf) {
            const float up = __shfl_up_sync(all, win, 1);
            const float down = __shfl_down_sync(all, win, 1);
            const float first_n = __shfl_sync(all, win_n, 0);
            const float wl = lane == 0 ? prev : up;          // win[b - 1]
            const float wr = lane == 31 ? first_n : down;    // win[b + 1]
            const bool edge = b == 0 || b >= lanes - 1;
            const float dwin = edge ? 0.0f : -0.5f * (wr - wl);
            de = a * dwin;
            dd = o * dwin;
            prev = __shfl_sync(all, win, 31);
        }
        const float c1 = cp * (4.0f * cp * cp - 3.0f);
        const float s1 = sp * (3.0f - 4.0f * sp * sp);
        float ch = c1, sh = s1;
#pragma unroll
        for (int h = 0; h < kHarm; ++h) {
            if (h) {
                const float nc = ch * c1 - sh * s1;
                const float ns = sh * c1 + ch * s1;
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
        win = win_n;
        cp = cp_n;
        sp = sp_n;
        a = a_n;
        o = o_n;
    }
}

// One warp per (frame, slot), kDftWarps of them per block, no block
// barrier; lane i < 25 (13 without the derivative window) writes sum i.
__global__ void __launch_bounds__(kDftWarps * 32)
harmonic_dft_kernel(const float* __restrict__ seg,
                    const float* __restrict__ f0, float* __restrict__ xre,
                    float* __restrict__ xim, float* __restrict__ dre,
                    float* __restrict__ dim, float* __restrict__ en,
                    long long pairs, int k_slots, int w, float fs, int fold,
                    int with_if) {
    const int lane = threadIdx.x & 31;
    const long long p = (long long)blockIdx.x * kDftWarps + (threadIdx.x >> 5);
    if (p >= pairs) return;                // whole warps
    const long long frame = p / k_slots;
    const float* row = seg + frame * w;
    const int c = w / 2;
    const int lanes = fold ? c : w;
    // clamp as the wrapper's plain version does: the fold floor keeps every
    // window inside the folded half-width, 1 Hz keeps 1/f0 finite
    // (constants rounded once from double, as Python computes them)
    const float floor_hz = fold ? (float)(1.5 * (double)fs / (double)(c - 3))
                                : 1.0f;
    const float f = fmaxf(f0[p], floor_hz);
    auto fetch = [&](int b, float& a, float& o) {
        if (fold) {
            const float r = row[c + b];
            const float l = row[c - b];
            a = b == 0 ? 0.5f * (r + l) : r + l;
            o = r - l;
        } else {
            a = row[b];
            o = a;
        }
    };
    float acc[kSums];
    float s;
    if (with_if) {
        warp_slot<true>(fetch, f, fs, lanes, lanes, c, fold, acc);
        s = warp_sums<kSums>(acc);
    } else {
        warp_slot<false>(fetch, f, fs, lanes, lanes, c, fold, acc);
        s = warp_sums<kNoIf>(acc);
    }
    if (lane < kHarm) {
        xre[p * kHarm + lane] = s;
    } else if (lane < 2 * kHarm) {
        xim[p * kHarm + lane - kHarm] = s;
    } else if (lane == kEn) {
        en[p] = s;
    } else if (with_if && lane < kDim) {
        dre[p * kHarm + lane - kDre] = s;
    } else if (with_if && lane < kSums) {
        dim[p * kHarm + lane - kDim] = s;
    }
}

// Blocks of 32 folded lanes a pass at frequency f (clamped) walks: up to the
// one that holds lane floor(half_len) + 1.  Past floor(half_len) the masked
// samples are 0, so every one of the 25 per-lane terms is exactly +-0
// (tests/test_torch_ops.py holds _slot_folded to that).
__device__ __forceinline__ int support_walk(float f, float fs, int lanes) {
    const float half_len = floorf(1.5f * fs / f + 1.0f);
    const float last = fminf(half_len + 1.0f, (float)(lanes - 1));
    return min(lanes, ((int)last / 32 + 1) * 32);
}

// One block per frame, one warp per candidate slot (slots w, w + warps, ...).
// The folded row goes to shared memory once, behind the block's only
// barrier; each warp then runs pass 1, the glue and pass 2 of its slot on
// its own: every lane gathers the sums by shuffle and runs the glue, so the
// accept decision and the refined f0 are warp-uniform without a broadcast.
__global__ void __launch_bounds__(kRefineMaxWarps * 32)
refine_score_kernel(const float* __restrict__ seg,
                    const float* __restrict__ f0,
                    float* __restrict__ refined_out,
                    float* __restrict__ score_out, int k_slots, int w,
                    float fs, float floor_hz, float limit) {
    __shared__ float e_s[kRefineMaxHalf];
    __shared__ float o_s[kRefineMaxHalf];
    const unsigned all = 0xffffffffu;
    const long long frame = blockIdx.x;
    const float* row = seg + frame * w;
    const int c = w / 2;
    for (int b = threadIdx.x; b < c; b += blockDim.x) {
        const float r = row[c + b];
        const float l = row[c - b];
        e_s[b] = b == 0 ? 0.5f * (r + l) : r + l;
        o_s[b] = r - l;
    }
    __syncthreads();
    auto fetch = [&](int b, float& a, float& o) {
        a = e_s[b];
        o = o_s[b];
    };
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    // constants rounded once from double, as Python computes them
    const float fold_floor = (float)(1.5 * (double)fs / (double)(c - 3));
    const float nyq = (float)((double)fs / 2.0);
    const float if_scale = (float)((double)fs / (2.0 * 3.14159265358979323846));
    const float hw_num = (float)(1.5 * (double)fs);
    for (int slot = threadIdx.x >> 5; slot < k_slots; slot += warps) {
        const long long out = frame * k_slots + slot;
        const float f0k = f0[out];
        float refined = 0.0f, score = 0.0f;
        if (f0k > 0.0f) {                        // warp-uniform; else empty
            // pass 1: DFT with the derivative window at the candidate
            float acc[kSums];
            const float f1 = fmaxf(f0k, fold_floor);
            warp_slot<true>(fetch, f1, fs, c, support_walk(f1, fs, c), c,
                            true, acc);
            const float s1 = warp_sums<kSums>(acc);
            const float f0c = fmaxf(f0k, floor_hz);
            float num = 0.0f, den = 0.0f;
#pragma unroll
            for (int h = 0; h < kHarm; ++h) {
                const float hh = (float)(h + 1);
                const float xr = __shfl_sync(all, s1, h);
                const float xi = __shfl_sync(all, s1, kHarm + h);
                const float dr = __shfl_sync(all, s1, kDre + h);
                const float di = __shfl_sync(all, s1, kDim + h);
                const float power = xr * xr + xi * xi + 1e-20f;
                const float amp = hh * f0c < nyq ? sqrtf(power) : 0.0f;
                const float ifs =
                    hh * f0c + (xr * di - xi * dr) / power * if_scale;
                num += amp * ifs / hh;
                den += amp;
            }
            const float r1 = den > 0.0f ? num / fmaxf(den, 1e-12f) : 0.0f;
            if (r1 > 0.0f
                    && fabsf(r1 - f0k) <= limit * fmaxf(f0k, 1e-12f)) {
                // accepted: pass 2, the DFT and energy at the refined f0
                refined = r1;
                const float rf = fmaxf(r1, floor_hz);
                const float f2 = fmaxf(rf, fold_floor);
                warp_slot<false>(fetch, f2, fs, c, support_walk(f2, fs, c),
                                 c, true, acc);
                const float s2 = warp_sums<kNoIf>(acc);
                float amps = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
                for (int h = 0; h < kHarm; ++h) {
                    const float hh = (float)(h + 1);
                    const float xr = __shfl_sync(all, s2, h);
                    const float xi = __shfl_sync(all, s2, kHarm + h);
                    const float power = xr * xr + xi * xi + 1e-20f;
                    const float amp = hh * rf < nyq ? sqrtf(power) : 0.0f;
                    amps += amp;
                    if (h == 0) a1 = amp;
                    if (h == 1) a2 = amp;
                }
                const float energy = __shfl_sync(all, s2, kEn);
                const float hw = floorf(hw_num / rf + 1.0f);
                const float winlen = 2.0f * hw + 1.0f;
                const float fft_size = exp2f(2.0f + ceilf(log2f(winlen)));
                const float total = sqrtf(fft_size * energy / 2.0f + 1e-30f);
                score = (amps / total) * (a1 / (a1 + a2 + 1e-30f));
            }
        }
        if (lane == 0) {
            refined_out[out] = refined;
            score_out[out] = score;
        }
    }
}

}  // namespace

extern "C" int tpuvc_harmonic_dft(const float* seg, const float* f0,
                                  float* xre, float* xim, float* dre,
                                  float* dim, float* en, int n, int k_slots,
                                  int w, float fs, int fold, int with_if,
                                  cudaStream_t stream) {
    if (w > kMaxLanes || w < 8) return (int)cudaErrorInvalidValue;
    const long long pairs = (long long)n * k_slots;
    if (pairs > 0) {
        const long long blocks = (pairs + kDftWarps - 1) / kDftWarps;
        harmonic_dft_kernel<<<(unsigned)blocks, kDftWarps * 32, 0, stream>>>(
            seg, f0, xre, xim, dre, dim, en, pairs, k_slots, w, fs, fold,
            with_if);
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
        const int warps = k_slots < kRefineMaxWarps ? k_slots
                                                    : kRefineMaxWarps;
        refine_score_kernel<<<n, warps * 32, 0, stream>>>(
            seg, f0, refined, score, k_slots, w, fs, floor_hz, limit);
    }
    return (int)cudaGetLastError();
}
