// Harvest's channel candidates and their merge into at most K = 10
// candidates per frame, one launch (K12).
//
// Replaces no Pallas kernel: the JAX package computes the per-channel
// candidates with whole-array operations and merges them with a
// jax.lax.scan over the band bank's channels (tpuvc/dsp/harvest.py:72
// _channel_candidates, :86 _merge_channels).  The port ran the same merge
// as a Python loop over the channels, ~32 PyTorch launches a channel:
// ~4,900 host launches for one corpus request of 64 rows x 152 channels x
// 6001 one-ms frames, which held the host while the card idled, and every
// channel rewrote the whole [B, N, K] outputs.  Here each (row, frame)
// walks its channels alone; no frame depends on another.
//
// Per channel ch of a frame, with t0..t3 its four event-interval tracks
// and bf its centre frequency (the plain version's operations, in its
// order, tpuvc_torch/ops/merge.py):
//   mean  = (((t0 + t1) + t2) + t3) * 0.25     (= / 4: exact scaling)
//   dev   = max_j |t_j - mean| / max(mean, 1e-12)
//   ok    = all t_j > 0 && dev <= consistency && floor <= mean <= ceil
//           && mean >= bf * 0.5 && mean <= bf * gate_high
//   c     = ok ? mean : 0
//   cont  = c > 0 && prev > 0 && |c - prev| < tolerance * max(prev, 1e-12)
//   a run that does not continue closes: its mean run_sum / max(run_cnt, 1)
//   goes to the next free slot while fewer than K are filled;
//   run_sum, run_cnt restart at (c, 1) where c > 0, else (0, 0); prev = c.
// After the last channel the open run closes.  Every operation is written
// with a rounding intrinsic, so nvcc contracts none into an FMA: K12 is
// bit-equal to the plain version.  NaN and inf tracks gate as there: a
// NaN or -inf track fails `t_j > 0`, and a mean of +inf fails `mean <=
// ceil`, so dev's value (and fmaxf's NaN rule against torch.amax's) never
// decides a gate the track tests have not decided already.  The
// deviations are not written: no caller reads them.
//
// Bound: bytes.  The call reads every track once (B C 4 N floats: 934 MB
// at 64 x 152 x 6001, ~0.28 ms at 3.35 TB/s) and writes B N K floats; per
// channel and frame it does ~44 float32 operations, an eighth of the
// card's float32 rate at that byte rate.  Design: one thread per (row,
// frame), 256 a block; consecutive threads take consecutive frames, so
// each of a channel's four loads is one coalesced 128-byte line per warp;
// the next channel's four loads are issued before the current channel is
// merged, so the walk waits on bytes and not on load latency.  The K emitted
// values live in registers (a fully unrolled predicated select per slot,
// no dynamically indexed local array) and are stored once at the end;
// slots never filled hold 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kK = 10;                   // HARVEST_MAX_CANDIDATES
constexpr int kThreads = 256;

struct Gates {
    float floor, ceil, consistency, gate_high, tolerance;
};

// The channel's candidate: its tracks' mean where the gates pass, else 0.
__device__ __forceinline__ float candidate(float t0, float t1, float t2,
                                           float t3, float bf,
                                           const Gates& g) {
    const float mean =
        __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3), 0.25f);
    const float d = fmaxf(fmaxf(fabsf(__fsub_rn(t0, mean)),
                                fabsf(__fsub_rn(t1, mean))),
                          fmaxf(fabsf(__fsub_rn(t2, mean)),
                                fabsf(__fsub_rn(t3, mean))));
    const float dev = __fdiv_rn(d, fmaxf(mean, 1e-12f));
    const bool ok = t0 > 0.0f && t1 > 0.0f && t2 > 0.0f && t3 > 0.0f
        && dev <= g.consistency && mean >= g.floor && mean <= g.ceil
        && mean >= __fmul_rn(bf, 0.5f) && mean <= __fmul_rn(bf, g.gate_high);
    return ok ? mean : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
merge_channels_kernel(const float* __restrict__ tracks,
                      const float* __restrict__ bfs, float* __restrict__ out,
                      long long rows_frames, int c, int n, Gates g) {
    const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (idx >= rows_frames) return;
    const long long row = idx / n;
    const long long frame = idx - row * n;
    // track j of channel ch at p + (4 ch + j) n
    const float* p = tracks + row * c * 4LL * n + frame;
    const long long step = 4LL * n;

    float v[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) v[k] = 0.0f;
    int filled = 0;
    float run_sum = 0.0f, run_cnt = 0.0f, prev = 0.0f;

    // emit `value` into the next free slot, if `on` and one is free
    auto emit = [&](float value, bool on) {
        const bool can = on && filled < kK;
#pragma unroll
        for (int k = 0; k < kK; ++k)
            v[k] = (can && filled == k) ? value : v[k];
        filled += can ? 1 : 0;
    };

    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (c > 0) {
        a0 = __ldg(p);
        a1 = __ldg(p + n);
        a2 = __ldg(p + 2LL * n);
        a3 = __ldg(p + 3LL * n);
    }
    for (int ch = 0; ch < c; ++ch) {
        const float t0 = a0, t1 = a1, t2 = a2, t3 = a3;
        if (ch + 1 < c) {                 // the next channel's loads in flight
            const float* q = p + (ch + 1) * step;
            a0 = __ldg(q);
            a1 = __ldg(q + n);
            a2 = __ldg(q + 2LL * n);
            a3 = __ldg(q + 3LL * n);
        }
        const float ci = candidate(t0, t1, t2, t3, __ldg(bfs + ch), g);
        const bool valid = ci > 0.0f;
        const bool cont = valid && prev > 0.0f
            && fabsf(__fsub_rn(ci, prev))
                   < __fmul_rn(g.tolerance, fmaxf(prev, 1e-12f));
        emit(__fdiv_rn(run_sum, fmaxf(run_cnt, 1.0f)),
             run_cnt > 0.0f && !cont);
        run_sum = cont ? __fadd_rn(run_sum, ci) : (valid ? ci : 0.0f);
        run_cnt = cont ? __fadd_rn(run_cnt, 1.0f) : (valid ? 1.0f : 0.0f);
        prev = ci;
    }
    emit(__fdiv_rn(run_sum, fmaxf(run_cnt, 1.0f)), run_cnt > 0.0f);

    float* o = out + idx * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) o[k] = v[k];
}

}  // namespace

// tracks [b, c, 4, n] and out [b, n, K] contiguous, bfs [c]; the gates'
// constants as the plain version rounds them to float32.
extern "C" int tpuvc_merge_channels(const float* tracks, const float* bfs,
                                    float* out, int b, int c, int n,
                                    float floor, float ceil,
                                    float consistency, float gate_high,
                                    float tolerance, cudaStream_t stream) {
    if (b < 0 || c < 0 || n < 0) return (int)cudaErrorInvalidValue;
    const long long rows_frames = (long long)b * n;
    if (rows_frames > 0) {
        const long long blocks = (rows_frames + kThreads - 1) / kThreads;
        if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
        const Gates g{floor, ceil, consistency, gate_high, tolerance};
        merge_channels_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
            tracks, bfs, out, rows_frames, c, n, g);
    }
    return (int)cudaGetLastError();
}
