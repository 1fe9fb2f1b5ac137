// Both candidate-extension passes of WORLD's f0 contour, one launch.
//
// Replaces no Pallas kernel: the JAX package runs the recurrence as a
// jax.lax.scan (tpuvc/dsp/dio.py:363 _extend_scan), forward and then
// backward over the forward pass's output, in DIO's contour fixing and in
// Harvest's.  The port ran the same scan as a Python loop over frames,
// about 16 PyTorch launches per frame and pass: ~38 k host launches for
// one corpus request of 64 x 1201 frames, which held the host while the
// card idled.  This kernel walks both passes of every row in one launch.
//
// Per frame i of a row, with `last` the previous frame's result (0 before
// the first frame of each pass):
//   err_j = |c_j - last| / max(last, 1e-6f)        (one IEEE division)
//   e_min = min_j err_j, NaN if any err_j is NaN;  pick = c_j of the
//           lowest j reaching it
//   ok    = f0_i == 0 && last > 0 && e_min < allowed
//   last  = f0_i > 0 ? f0_i : (ok ? pick : 0)
// as the plain version (tpuvc_torch/ops/contour.py) computes it with
// torch.min, which takes the lowest index on ties and propagates NaN.
// Division, not a multiply by the reciprocal: a reciprocal can round two
// different numerators' errors into a tie, or split a tie.
//
// Bound: latency, not bytes or operations.  A row is a chain of 2N
// dependent steps (`last` carries from frame to frame) and a request has
// only 64 rows (a live tick 45), so the card's width is idle whatever the
// design; the bytes (N (C + 2) floats a row) take under a microsecond.
// The design keeps global memory off that chain:
// - one block per row: warp 0 walks the frames, warp 1 stages the next
//   tile of kTile frames' f0 and C candidates in shared memory with
//   coalesced loads while warp 0 walks the current one (two buffers, one
//   barrier a tile);
// - candidates come as a contiguous [B, N, C], so a tile's candidates are
//   one contiguous run of kTile * C floats;
// - the forward pass writes its output to `out`, and warp 1 stages it back
//   tile by tile as the backward pass's f0, off the chain; the backward
//   pass then overwrites each tile of `out` after it has been staged;
// - per step, lane j of warp 0 divides for candidate j, so the C
//   divisions run side by side, and the minimum is one redux over the
//   warp (step).  On an H100 this step took 185-200 ns at DIO's 7
//   candidates; a shuffle minimum carrying the index took ~210 ns, and one
//   lane walking all candidates with a tree minimum ~560 ns.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;               // frames per staged tile
constexpr int kThreads = 64;             // warp 0 walks, warp 1 stages
constexpr int kMaxCands = 32;

// One step of the walk for the warp, lane j holding candidate j of the
// frame (c <= 32).  The errors are +0 or more, +inf in the lanes past c, or
// NaN, which the vote catches: so their bits order them as unsigned
// integers, and one redux minimum gives e_min, the ballot of the lanes
// reaching it the lowest index.  Every lane ends with the new `last`.
__device__ __forceinline__ float step(float last, float f, const float* cv,
                                      int c, float allowed, int lane) {
    const float d = last < 1e-6f ? 1e-6f : last;   // clamp(min=1e-6)
    float p = 0.0f, e = INFINITY;
    if (lane < c) {
        p = cv[lane];
        e = __fdiv_rn(fabsf(p - last), d);
    }
    const bool nan = __any_sync(0xffffffffu, isnan(e));
    const unsigned u = __float_as_uint(e);
    const unsigned m = __reduce_min_sync(0xffffffffu, u);
    const int j = __ffs(__ballot_sync(0xffffffffu, u == m)) - 1;
    const float pick = __shfl_sync(0xffffffffu, p, j);
    const bool ok = f == 0.0f && last > 0.0f && !nan
        && __uint_as_float(m) < allowed;
    return f > 0.0f ? f : (ok ? pick : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
extend_scans_kernel(const float* __restrict__ f0,
                    const float* __restrict__ cands, float* out, int n,
                    int c, float allowed) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long row = blockIdx.x;
    const int buf = kTile * (c + 1);     // a tile: f0[kTile], cands[kTile][c]
    const float* f0r = f0 + row * n;
    const float* cr = cands + row * n * (long long)c;
    float* outr = out + row * n;
    const int nt = (n + kTile - 1) / kTile;
    const int jobs = 2 * nt;
    // job k walks tile k forward (k < nt), then tile 2 nt - 1 - k backward
    auto first = [&](int k) { return (k < nt ? k : jobs - 1 - k) * kTile; };

    // warp 1: job k's candidates and, if with_f0, its f0 (the forward
    // pass's input, or the backward pass's: the forward pass's output)
    auto stage = [&](int k, bool with_f0) {
        float* tf = smem + (k & 1) * buf;
        float* tc = tf + kTile;
        const int t0 = first(k);
        const int len = min(kTile, n - t0);
        if (with_f0) {
            for (int i = lane; i < len; i += 32)
                tf[i] = k < nt ? __ldg(f0r + t0 + i) : outr[t0 + i];
        }
        const float* src = cr + (long long)t0 * c;
        for (int q = lane; q < len * c; q += 32) tc[q] = __ldg(src + q);
    };

    if (warp == 1) stage(0, true);
    __syncthreads();
    float last = 0.0f;
    for (int k = 0; k < jobs; ++k) {
        if (warp == 0) {
            const float* tf = smem + (k & 1) * buf;
            const float* tc = tf + kTile;
            const int t0 = first(k);
            const int len = min(kTile, n - t0);
            if (k == nt) last = 0.0f;    // the backward pass starts afresh
            if (k < nt) {
#pragma unroll 4
                for (int i = 0; i < len; ++i) {
                    last = step(last, tf[i], tc + i * c, c, allowed, lane);
                    if (lane == 0) outr[t0 + i] = last;
                }
            } else {
#pragma unroll 4
                for (int i = len - 1; i >= 0; --i) {
                    last = step(last, tf[i], tc + i * c, c, allowed, lane);
                    if (lane == 0) outr[t0 + i] = last;
                }
            }
        } else if (warp == 1 && k + 1 < jobs) {
            // the backward pass's first tile is the forward pass's last,
            // being walked now: its f0 is staged after the barrier
            stage(k + 1, k + 1 != nt);
        }
        __syncthreads();
        if (k + 1 == nt) {
            if (warp == 1) {
                float* tf = smem + (nt & 1) * buf;
                const int t0 = first(nt);
                for (int i = lane; i < min(kTile, n - t0); i += 32)
                    tf[i] = outr[t0 + i];
            }
            __syncthreads();
        }
    }
}

}  // namespace

// f0 [b, n], cands [b, n, c] and out [b, n], all contiguous.
extern "C" int tpuvc_extend_scans(const float* f0, const float* cands,
                                  float* out, int b, int n, int c,
                                  float allowed, cudaStream_t stream) {
    if (c < 1 || c > kMaxCands) return (int)cudaErrorInvalidValue;
    if (b > 0 && n > 0) {
        const size_t tiles = sizeof(float) * 2 * kTile * (c + 1);
        extend_scans_kernel<<<b, kThreads, tiles, stream>>>(
            f0, cands, out, n, c, allowed);
    }
    return (int)cudaGetLastError();
}
