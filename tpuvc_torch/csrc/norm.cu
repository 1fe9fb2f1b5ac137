// K11: LayerNorm + LeakyReLU over the last axis of short rows.
//
// Replaces no TPU kernel: the JAX package leaves the model's LayerNorms
// outside K8 and K9 to XLA (flax.linen.LayerNorm, then leaky_relu), which
// fuses them.  PyTorch ran each as ATen's LayerNorm, one thread block per
// row, then a LeakyReLU pass; 1197 of a frame's 1512 LayerNorm rows are 16
// values long, so the block scheduler, not memory, set that kernel's pace.
// Here many rows share a CTA.
//
// A row of C values is held by LPR lanes, NV vectors of VPL values a lane
// (16-byte vectors for C = 16..256; 8-byte ones in bfloat16 for the
// decoder's dense_norm, C = 2432, a warp a row).  Float32 math: the row
// mean, then the two-pass variance (eps), reduced over the row's lanes by
// __shfl_xor_sync; gamma and beta arrive in float32 (the parameters) and
// are rounded to x's dtype here, as the model's .to(h.dtype) casts did;
// LeakyReLU h > 0 ? h : h*slope; the output is rounded once to x's dtype
// (float32 or bfloat16, round to nearest even).
//
// x and out are [rows, C] contiguous: the model's activations lie
// channels-last (its convolutions write them so, and its depth-to-space
// is a view).
// - the published widths: a grid of resident CTAs strides over the rows;
//   each lane loads its vectors straight from device memory.
// - any other width (an architecture other than the published one): a
//   warp a row with C read at run time; the row is read three times (sum,
//   squared deviations, output), the last two from cache.
//
// Bound: device-memory bytes, one read and one write of the activations
// (2 x 2 B per value in bfloat16); about ten operations per value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
    T v[V];
};

// Where a row's values lie: lane j of the row's LPR lanes holds columns
// (q * LPR + j) * VPL + e, q < NV, e < VPL.
template <int C_, int VPL_>
struct Row {
    static constexpr int C = C_;
    static constexpr int VPL = VPL_;
    static constexpr int LPR = C / VPL < 32 ? C / VPL : 32;
    static constexpr int NV = C / (VPL * LPR);
    static constexpr int RPW = 32 / LPR;        // rows a warp step
    static constexpr int N = NV * VPL;          // values a lane
    static_assert(NV * VPL * LPR == C && 32 % LPR == 0, "row width");
    static_assert(VPL % 4 == 0, "gamma and beta load as float4");
    __device__ static constexpr int col(int q, int j) {
        return (q * LPR + j) * VPL;
    }
};

// the sum of s over a row's LPR lanes (every lane of the warp takes part)
template <int LPR>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    return s;
}

// gamma and beta of a lane's columns, rounded to T.  Narrow rows keep them
// in registers for every row; a wide row (C = 2432, 76 values a lane)
// reads them per row from L1 to keep its registers for the values.
template <typename T, typename R>
struct Affine {
    static constexpr bool kHoist = R::N <= 16;
    const float* __restrict__ gamma;
    const float* __restrict__ beta;
    int j;
    float g[kHoist ? R::N : 1], b[kHoist ? R::N : 1];

    __device__ static void load(const float* __restrict__ p, int c,
                                float* dst) {
#pragma unroll
        for (int e = 0; e < R::VPL; e += 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + c + e);
            dst[e] = widen(narrow<T>(t.x));
            dst[e + 1] = widen(narrow<T>(t.y));
            dst[e + 2] = widen(narrow<T>(t.z));
            dst[e + 3] = widen(narrow<T>(t.w));
        }
    }

    __device__ Affine(const float* gm, const float* bt, int lane_j)
        : gamma(gm), beta(bt), j(lane_j) {
        if constexpr (kHoist) {
#pragma unroll
            for (int q = 0; q < R::NV; ++q) {
                load(gamma, R::col(q, j), g + q * R::VPL);
                load(beta, R::col(q, j), b + q * R::VPL);
            }
        }
    }

    __device__ void at(int q, float* gq, float* bq) const {
        if constexpr (kHoist) {
#pragma unroll
            for (int e = 0; e < R::VPL; ++e) {
                gq[e] = g[q * R::VPL + e];
                bq[e] = b[q * R::VPL + e];
            }
        } else {
            load(gamma, R::col(q, j), gq);
            load(beta, R::col(q, j), bq);
        }
    }
};

// Normalise the row whose lane values are v (zeros on a lane past the
// last row: every lane of the warp takes part in the shuffles), apply
// LeakyReLU and store the lane's vectors at dst, the row's output.
template <typename T, typename R>
__device__ __forceinline__ void norm_store(float (&v)[R::N],
                                           const Affine<T, R>& af, T* dst,
                                           bool ok, float slope, float eps) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < R::N; ++i) s += v[i];
    const float mu = row_sum<R::LPR>(s) / (float)R::C;
    float var = 0.0f;
#pragma unroll
    for (int i = 0; i < R::N; ++i) {
        v[i] -= mu;
        var = fmaf(v[i], v[i], var);
    }
    const float rstd = rsqrtf(row_sum<R::LPR>(var) / (float)R::C + eps);
    if (!ok) return;
#pragma unroll
    for (int q = 0; q < R::NV; ++q) {
        float g[R::VPL], b[R::VPL];
        af.at(q, g, b);
        Vec<T, R::VPL> o;
#pragma unroll
        for (int e = 0; e < R::VPL; ++e) {
            const float h = fmaf(v[q * R::VPL + e] * rstd, g[e], b[e]);
            o.v[e] = narrow<T>(h > 0.0f ? h : h * slope);
        }
        *reinterpret_cast<Vec<T, R::VPL>*>(dst + R::col(q, af.j)) = o;
    }
}

template <typename T, int C, int VPL>
__global__ void __launch_bounds__(kThreads)
norm_lrelu_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ out,
                       long long rows, float slope, float eps) {
    using R = Row<C, VPL>;
    using VT = Vec<T, VPL>;
    const int lane = threadIdx.x & 31;
    const int j = lane % R::LPR;
    const Affine<T, R> af(gamma, beta, j);
    const long long warps = (long long)gridDim.x * kWarps;
    // w is the same on every lane of a warp: the loop is uniform
    for (long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
         w * R::RPW < rows; w += warps) {
        const long long row = w * R::RPW + lane / R::LPR;
        const bool ok = row < rows;
        float v[R::N];
#pragma unroll
        for (int q = 0; q < R::NV; ++q) {
            if (ok) {
                const VT in = *reinterpret_cast<const VT*>(
                    x + row * C + R::col(q, j));
#pragma unroll
                for (int e = 0; e < VPL; ++e) v[q * VPL + e] = widen(in.v[e]);
            } else {
#pragma unroll
                for (int e = 0; e < VPL; ++e) v[q * VPL + e] = 0.0f;
            }
        }
        norm_store<T, R>(v, af, out + row * C, ok, slope, eps);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_lrelu_any_kernel(const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ out,
                      long long rows, int c, float slope, float eps) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * kWarps;
    for (long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
         row < rows; row += warps) {
        const T* xr = x + row * c;
        float s = 0.0f;
        for (int i = lane; i < c; i += 32) s += widen(xr[i]);
        const float mu = row_sum<32>(s) / (float)c;
        float var = 0.0f;
        for (int i = lane; i < c; i += 32) {
            const float d = widen(xr[i]) - mu;
            var = fmaf(d, d, var);
        }
        const float rstd = rsqrtf(row_sum<32>(var) / (float)c + eps);
        T* o = out + row * c;
        for (int i = lane; i < c; i += 32) {
            const float g = widen(narrow<T>(gamma[i]));
            const float b = widen(narrow<T>(beta[i]));
            const float h = fmaf((widen(xr[i]) - mu) * rstd, g, b);
            o[i] = narrow<T>(h > 0.0f ? h : h * slope);
        }
    }
}

// CTAs of a kernel that fit on the card at once
template <typename K>
int resident_ctas(K kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, int C, int VPL>
cudaError_t launch_rows(const void* x, const float* g, const float* b,
                        void* out, long long rows, float slope, float eps,
                        cudaStream_t stream) {
    using R = Row<C, VPL>;
    static const int cap = resident_ctas(norm_lrelu_rows_kernel<T, C, VPL>);
    constexpr long long kRowsPerCta = (long long)kWarps * R::RPW;
    long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
    if (ctas > cap) ctas = cap;
    if (ctas > 0)
        norm_lrelu_rows_kernel<T, C, VPL><<<(unsigned)ctas, kThreads, 0,
                                            stream>>>(
            static_cast<const T*>(x), g, b, static_cast<T*>(out), rows, slope,
            eps);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* x, const float* g, const float* b,
                       void* out, long long rows, int c, float slope,
                       float eps, cudaStream_t stream) {
    static const int cap = resident_ctas(norm_lrelu_any_kernel<T>);
    long long ctas = (rows + kWarps - 1) / kWarps;
    if (ctas > cap) ctas = cap;
    if (ctas > 0)
        norm_lrelu_any_kernel<T><<<(unsigned)ctas, kThreads, 0, stream>>>(
            static_cast<const T*>(x), g, b, static_cast<T*>(out), rows, c,
            slope, eps);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* g, const float* b,
                     void* out, long long rows, int c, float slope,
                     float eps, cudaStream_t stream) {
    constexpr int V = 16 / sizeof(T);       // 16-byte vectors
    switch (c) {
        case 16:
            return launch_rows<T, 16, V>(x, g, b, out, rows, slope, eps,
                                         stream);
        case 32:
            return launch_rows<T, 32, V>(x, g, b, out, rows, slope, eps,
                                         stream);
        case 64:
            return launch_rows<T, 64, V>(x, g, b, out, rows, slope, eps,
                                         stream);
        case 128:
            return launch_rows<T, 128, V>(x, g, b, out, rows, slope, eps,
                                          stream);
        case 256:
            return launch_rows<T, 256, V>(x, g, b, out, rows, slope, eps,
                                          stream);
        case 2432:   // the decoder's dense_norm: 19 x 128
            return launch_rows<T, 2432, 4>(x, g, b, out, rows, slope, eps,
                                           stream);
        default:     // another architecture's width
            return launch_any<T>(x, g, b, out, rows, c, slope, eps, stream);
    }
}

}  // namespace

// x and out hold rows contiguous rows of c values (any c >= 1).
// dtype: 0 = float32, 1 = bfloat16 (x and out); gamma and beta are float32
// [c], 16-byte aligned; x and out 16-byte aligned.
extern "C" int tpuvc_norm_lrelu(const void* x, const void* g, const void* b,
                                void* out, long long rows, int c, int dtype,
                                float slope, float eps, cudaStream_t stream) {
    if (rows < 0 || c < 1) return (int)cudaErrorInvalidValue;
    const float* gf = static_cast<const float*>(g);
    const float* bf = static_cast<const float*>(b);
    if (dtype == 0)
        return (int)dispatch<float>(x, gf, bf, out, rows, c, slope, eps,
                                    stream);
    if (dtype == 1)
        return (int)dispatch<__nv_bfloat16>(x, gf, bf, out, rows, c, slope,
                                            eps, stream);
    return (int)cudaErrorInvalidValue;
}
