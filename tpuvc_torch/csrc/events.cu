// DIO event stage: per-cell events + per-block sorted top-2 pairs.
//
// Replaces tpuvc/ops/pallas_events.py:event_block_pairs (_kernel,
// _insert_top2).  For cell i with samples a = sig[i], b = sig[i+1],
// c = sig[i+2], event type e in (zc-neg, zc-pos, peaks, dips) takes
// (v0, v1) = (a, b), (-a, -b), (b - a, c - b), (-(b - a), -(c - b)); an
// event is v0 > 0 && v1 <= 0 inside the type's cell count (T-1, T-1, T-2,
// T-2), at time (i + v0 / (v0 - v1)) + off, off = 0, 0, 0.5, 0.5.
//
// Bound: device-memory bytes (one read of the bank, a 16/stride-sized
// write).  The first design (one thread per block, walking its cells in
// device memory, neighbouring lanes 4 * stride bytes apart) was bound by
// its instruction count instead: every cell ran four IEEE divisions and
// sixteen sorted-pair updates whether or not it held an event (staging its
// reads alone made it slower; dropping the per-cell work gave all of the
// gain at stride 20).  Now:
//
// - One CTA per (row, tile of kThreads blocks), a thread per block.  The
//   CTA stages its span of the row, kThreads * stride cells and the
//   2-sample halo (zeros past T), in shared memory with coalesced 16-byte
//   loads (scalar loads where the row is not 16-byte aligned).  At stride
//   20 a quarter-warp's 16-byte shared reads are 80 bytes apart and hit
//   disjoint banks; at stride 8 they are 32 bytes apart, a 2-way conflict
//   on reads that are a small share of the work, left as it is.
// - The mask pass: per cell one subtraction and two compares per type,
//   each event set as a bit of a 32-bit mask per type (stride <= 32).
// - Divide only on an event.  A type's event times are non-decreasing in
//   the cell index: frac lies in [0, 1] (v0 - v1 >= v0 > 0 rounds to at
//   least v0), i + frac rounds into [i, i + 1] while cell indices are
//   exact in float32 (T <= 2^24), and adding off is monotone.  So a
//   block's sorted top-2 of the largest times are its last two events
//   and of the smallest its first two, with multiplicity: at most four
//   times per type, each from the same IEEE divide and adds as the plain
//   version (no contraction: __fdiv_rn, __fadd_rn).
// - The premise needs finite v0 (then v0 / (v0 - v1) is never NaN): a
//   sample at or above 2^126 in magnitude (an inf, or one whose
//   difference with a neighbour could overflow) sends the whole
//   CTA to the generic path, as does a stride over 32 or T over 2^24.
//   The generic path is the first design's per-cell insert over device
//   memory plus the XLA twin's NaN rule (tpuvc/dsp/dio.py:_block_top2,
//   max/argmax and one-hot removal): an event at an infinite v0 has time
//   inf/inf = NaN; with one NaN in a block the first slot is NaN and the
//   second the extreme of the others, with two or more both are NaN.  A
//   NaN sample makes no event (it fails both compares) on either path.
// - Stores coalesced along the block index.
//
// Output layout [rows, 16, nb]: row 4e + {0: max, 1: second max,
// 2: min, 3: second min}.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;         // blocks of `stride` cells per CTA
constexpr int kMaxFastStride = 32;    // a block's events fit a 32-bit mask
constexpr int kMaxFastT = 1 << 24;    // cell indices exact in float32
constexpr float kBig = 0x1p126f;      // below it every v0 is finite
constexpr int kBatch = 4;             // float4 loads in flight per thread

enum Mode { kVec = 0, kScalar = 1, kGeneric = 2 };

__device__ __forceinline__ float event_time(float v0, float v1, int i,
                                            float off) {
    const float frac = __fdiv_rn(v0, __fsub_rn(v0, v1));
    return __fadd_rn(__fadd_rn((float)i, frac), off);
}

// (v0, v1) of type e at the cell whose samples are a, b, c
__device__ __forceinline__ void type_values(int e, float a, float b, float c,
                                            float& v0, float& v1) {
    if (e < 2) {
        v0 = a;
        v1 = b;
    } else {
        v0 = __fsub_rn(b, a);
        v1 = __fsub_rn(c, b);
    }
    if (e & 1) {
        v0 = -v0;
        v1 = -v1;
    }
}

__device__ __forceinline__ void store_pairs(float* o, int nb, int e, float mx1,
                                            float mx2, float mn1, float mn2) {
    o[(long long)(4 * e + 0) * nb] = mx1;
    o[(long long)(4 * e + 1) * nb] = mx2;
    o[(long long)(4 * e + 2) * nb] = mn1;
    o[(long long)(4 * e + 3) * nb] = mn2;
}

// One type's pairs from its event mask: x is the block's first sample in
// shared memory, i0 its first cell.  Times for the first, second, last
// and next-to-last events only, each divided once.
__device__ __forceinline__ void pairs_from_mask(unsigned bits, int e,
                                                const float* x, int i0,
                                                float* o, int nb) {
    const float off = e < 2 ? 0.0f : 0.5f;
    auto time = [&](int j) {
        float v0, v1;
        type_values(e, x[j], x[j + 1], x[j + 2], v0, v1);
        return event_time(v0, v1, i0 + j, off);
    };
    const int n = __popc(bits);
    float t1 = 0.0f, t2 = 0.0f, t3 = 0.0f, t4 = 0.0f;
    if (n >= 1) t1 = time(__ffs(bits) - 1);
    if (n >= 2) t2 = time(__ffs(bits & (bits - 1)) - 1);
    if (n >= 3) {
        const int last = 31 - __clz(bits);
        t3 = time(last);
        if (n >= 4) t4 = time(31 - __clz(bits ^ (1u << last)));
    }
    const float mx1 = n == 0 ? -CUDART_INF_F : n == 1 ? t1 : n == 2 ? t2 : t3;
    const float mx2 = n <= 1 ? -CUDART_INF_F : n == 2 ? t1 : n == 3 ? t2 : t4;
    store_pairs(o, nb, e, mx1, mx2, n == 0 ? CUDART_INF_F : t1,
                n <= 1 ? CUDART_INF_F : t2);
}

__device__ __forceinline__ void set_events(float a, float b, float c,
                                           unsigned bit, unsigned* m) {
    const float d0 = __fsub_rn(b, a), d1 = __fsub_rn(c, b);
    m[0] |= (a > 0.0f && b <= 0.0f) ? bit : 0u;
    m[1] |= (-a > 0.0f && -b <= 0.0f) ? bit : 0u;
    m[2] |= (d0 > 0.0f && d1 <= 0.0f) ? bit : 0u;
    m[3] |= (-d0 > 0.0f && -d1 <= 0.0f) ? bit : 0u;
}

// The fast path for one block: S = its stride at compile time (the
// strides of DIO and Harvest, unrolled, 16-byte shared reads when
// S % 4 == 0: a little faster than the loop at stride 20), or 0 for a
// runtime stride.
template <int S>
__device__ __forceinline__ void fast_block(const float* x, int stride,
                                           int i0, int t, float* o, int nb) {
    unsigned m[4] = {0u, 0u, 0u, 0u};
    if constexpr (S > 0) {
        float v[S + 2];
        if constexpr (S % 4 == 0) {
#pragma unroll
            for (int q = 0; q < S / 4; ++q) {
                const float4 f = reinterpret_cast<const float4*>(x)[q];
                v[4 * q] = f.x;
                v[4 * q + 1] = f.y;
                v[4 * q + 2] = f.z;
                v[4 * q + 3] = f.w;
            }
            const float2 h = *reinterpret_cast<const float2*>(x + S);
            v[S] = h.x;
            v[S + 1] = h.y;
        } else {
#pragma unroll
            for (int j = 0; j < S + 2; ++j) v[j] = x[j];
        }
#pragma unroll
        for (int j = 0; j < S; ++j) set_events(v[j], v[j + 1], v[j + 2],
                                               1u << j, m);
    } else {
        float a = x[0], b = x[1];
        for (int j = 0; j < stride; ++j) {
            const float c = x[j + 2];
            set_events(a, b, c, 1u << j, m);
            a = b;
            b = c;
        }
    }
    // cells past each type's count are no events
    const int st = S > 0 ? S : stride;
    const int nzc = min(max(t - 1 - i0, 0), st);
    const int npd = min(max(t - 2 - i0, 0), st);
    const unsigned vzc = nzc >= 32 ? ~0u : (1u << nzc) - 1u;
    const unsigned vpd = npd >= 32 ? ~0u : (1u << npd) - 1u;
    pairs_from_mask(m[0] & vzc, 0, x, i0, o, nb);
    pairs_from_mask(m[1] & vzc, 1, x, i0, o, nb);
    pairs_from_mask(m[2] & vpd, 2, x, i0, o, nb);
    pairs_from_mask(m[3] & vpd, 3, x, i0, o, nb);
}

__device__ __forceinline__ float sample(const float* row, long long i, int t) {
    return i < t ? row[i] : 0.0f;
}

// The generic path for one block: every cell's sorted-pair insert over
// device memory, NaN times counted apart and resolved as the XLA twin.
__device__ void generic_block(const float* row, int t, int stride, int k,
                              float* o, int nb) {
    float mx1[4], mx2[4], mn1[4], mn2[4];
    int nan[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        mx1[e] = -CUDART_INF_F;
        mx2[e] = -CUDART_INF_F;
        mn1[e] = CUDART_INF_F;
        mn2[e] = CUDART_INF_F;
        nan[e] = 0;
    }
    const long long i0 = (long long)k * stride;
    float a = sample(row, i0, t), b = sample(row, i0 + 1, t);
    for (int j = 0; j < stride; ++j) {
        const long long i = i0 + j;
        const float c = sample(row, i + 2, t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float v0, v1;
            type_values(e, a, b, c, v0, v1);
            const long long nc = e < 2 ? t - 1 : t - 2;
            if (v0 > 0.0f && v1 <= 0.0f && i < nc) {
                const float tp = event_time(v0, v1, (int)i,
                                            e < 2 ? 0.0f : 0.5f);
                if (tp != tp) {
                    ++nan[e];
                } else {
                    mx2[e] = fmaxf(mx2[e], fminf(mx1[e], tp));
                    mx1[e] = fmaxf(mx1[e], tp);
                    mn2[e] = fminf(mn2[e], fmaxf(mn1[e], tp));
                    mn1[e] = fminf(mn1[e], tp);
                }
            }
        }
        a = b;
        b = c;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (nan[e] >= 2) {
            mx1[e] = mx2[e] = mn1[e] = mn2[e] = CUDART_NAN_F;
        } else if (nan[e] == 1) {
            mx2[e] = mx1[e];
            mx1[e] = CUDART_NAN_F;
            mn2[e] = mn1[e];
            mn1[e] = CUDART_NAN_F;
        }
        store_pairs(o, nb, e, mx1[e], mx2[e], mn1[e], mn2[e]);
    }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
event_block_pairs_kernel(const float* __restrict__ bank,
                         float* __restrict__ out, int t, int stride, int nb,
                         int tiles, int mode) {
    extern __shared__ float4 span4[];
    float* span = reinterpret_cast<float*>(span4);
    const int r = blockIdx.x / tiles;
    const int k0 = (blockIdx.x - r * tiles) * kThreads;
    const int k = k0 + threadIdx.x;
    const float* row = bank + (long long)r * t;
    float* o = out + (long long)r * 16 * nb + k;
    bool generic = mode == kGeneric;
    if (!generic) {
        // stage cells [g0, g0 + kThreads * stride) and the halo, zeros
        // past t; note any sample that breaks the fast path's premise
        const int g0 = k0 * stride;
        const int n = kThreads * stride + 4;
        bool big = false;
        if (mode == kVec) {
            // t % 4 == 0 and g0 % 4 == 0: a float4 is wholly in or out
            const float4* src = reinterpret_cast<const float4*>(row + g0);
            const int nq = n / 4;
            for (int q0 = 0; q0 < nq; q0 += kBatch * kThreads) {
                float4 f[kBatch];
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int q = q0 + u * kThreads + threadIdx.x;
                    f[u] = q < nq && g0 + 4 * q < t
                               ? __ldg(src + q)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const int q = q0 + u * kThreads + threadIdx.x;
                    if (q < nq) {
                        span4[q] = f[u];
                        big |= fabsf(f[u].x) >= kBig || fabsf(f[u].y) >= kBig
                               || fabsf(f[u].z) >= kBig
                               || fabsf(f[u].w) >= kBig;
                    }
                }
            }
        } else {
            for (int q = threadIdx.x; q < n; q += kThreads) {
                const float f = g0 + q < t ? __ldg(row + g0 + q) : 0.0f;
                span[q] = f;
                big |= fabsf(f) >= kBig;
            }
        }
        generic = __syncthreads_or(big);
        if (!generic && k < nb)
            fast_block<S>(span + threadIdx.x * stride, stride, k * stride, t,
                          o, nb);
    }
    if (generic && k < nb) generic_block(row, t, stride, k, o, nb);
}

template <int S>
cudaError_t launch(const float* bank, float* out, int rows, int t, int stride,
                   int nb, int tiles, int mode, cudaStream_t stream) {
    const size_t smem = mode == kGeneric
                            ? 0
                            : (size_t)(kThreads * stride + 4) * sizeof(float);
    event_block_pairs_kernel<S><<<rows * tiles, kThreads, smem, stream>>>(
        bank, out, t, stride, nb, tiles, mode);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tpuvc_event_block_pairs(const float* bank, float* out,
                                       int rows, int t, int stride, int nb,
                                       cudaStream_t stream) {
    if (rows <= 0 || nb <= 0) return (int)cudaGetLastError();
    const int tiles = (nb + kThreads - 1) / kThreads;
    if ((long long)rows * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool aligned =
        reinterpret_cast<uintptr_t>(bank) % 16 == 0 && t % 4 == 0;
    const int mode = stride > kMaxFastStride || t > kMaxFastT ? kGeneric
                     : aligned                                ? kVec
                                                              : kScalar;
    if (stride == 20)
        return (int)launch<20>(bank, out, rows, t, stride, nb, tiles, mode,
                               stream);
    if (stride == 8)
        return (int)launch<8>(bank, out, rows, t, stride, nb, tiles, mode,
                              stream);
    return (int)launch<0>(bank, out, rows, t, stride, nb, tiles, mode, stream);
}
