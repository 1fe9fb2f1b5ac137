// Fused depth-to-space + LayerNorm + LeakyReLU for the decoder.
//
// Replaces tpuvc/ops/pallas_d2s.py:d2s_ln_lrelu (_kernel): the decoder's
// stride-s subpixel layers under Architecture(d2s_impl="pallas").  In a
// row-major channels-last layout the depth-to-space [N, L, c*s] ->
// [N, L*s, c] is a free view: output element (n, l*s + si, j) sits at the
// flat offset of input element (n, l, si*c + j).  What the TPU had to
// relayout in VMEM is here a LayerNorm over contiguous rows of c values.
//
// Each row of c values is held by c/4 lanes, 4 values a lane, loaded and
// stored as one vector per lane; a warp holds 128/c rows.  It is built for
// the decoder's three widths, c = 32, 64, 128.  Float32 math as the Pallas kernel: the row mean, then the
// two-pass variance (eps), reduced over the row's lanes by
// __shfl_xor_sync; gamma and beta arrive in x's dtype (the wrapper casts
// them first, as the Pallas wrapper does) and are widened to float32;
// LeakyReLU h >= 0 ? h : slope*h; the output is rounded to x's dtype
// (float32 or bfloat16, round to nearest even).
//
// Bound: device-memory bytes — one read and one write of the activations
// (2 x 2 B per value in bfloat16); a few operations per value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kValsPerLane = 4;

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

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
d2s_ln_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ out,
                    long long rows, float slope, float eps) {
    constexpr int V = kValsPerLane;
    constexpr int LPR = C / V;                 // lanes a row
    constexpr int RPW = 32 / LPR;              // rows a warp
    static_assert(LPR <= 32 && 32 % LPR == 0, "row width");
    using VT = Vec<T, V>;
    const int lane = threadIdx.x & 31;
    const long long warp =
        ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const long long row = warp * RPW + lane / LPR;
    const int col = (lane % LPR) * V;
    const bool ok = row < rows;

    float v[V];
    if (ok) {
        const VT in = *reinterpret_cast<const VT*>(x + row * C + col);
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = widen(in.v[q]);
    } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < V; ++q) s += v[q];
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s * (1.0f / (float)C);
    float var = 0.0f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
        v[q] -= mu;
        var = fmaf(v[q], v[q], var);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
        var += __shfl_xor_sync(0xffffffffu, var, off);
    const float inv = rsqrtf(var * (1.0f / (float)C) + eps);
    if (!ok) return;
    const VT g = *reinterpret_cast<const VT*>(gamma + col);
    const VT b = *reinterpret_cast<const VT*>(beta + col);
    VT o;
#pragma unroll
    for (int q = 0; q < V; ++q) {
        const float h = v[q] * inv * widen(g.v[q]) + widen(b.v[q]);
        o.v[q] = narrow<T>(h >= 0.0f ? h : slope * h);
    }
    *reinterpret_cast<VT*>(out + row * C + col) = o;
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* g, const void* b, void* out,
                   long long rows, float slope, float eps,
                   cudaStream_t stream) {
    constexpr long long kRowsPerBlock =
        (kThreads / 32) * (32 / (C / kValsPerLane));
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (blocks > 0)
        d2s_ln_lrelu_kernel<T, C><<<(unsigned)blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(g),
            static_cast<const T*>(b), static_cast<T*>(out), rows, slope, eps);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* b, void* out,
                     long long rows, int c, float slope, float eps,
                     cudaStream_t stream) {
    switch (c) {
        case 32: return launch<T, 32>(x, g, b, out, rows, slope, eps, stream);
        case 64: return launch<T, 64>(x, g, b, out, rows, slope, eps, stream);
        case 128: return launch<T, 128>(x, g, b, out, rows, slope, eps,
                                        stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gamma, beta and out alike)
extern "C" int tpuvc_d2s_ln_lrelu(const void* x, const void* g,
                                  const void* b, void* out, int rows, int c,
                                  int dtype, float slope, float eps,
                                  cudaStream_t stream) {
    if (rows < 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)dispatch<float>(x, g, b, out, rows, c, slope, eps, stream);
    if (dtype == 1)
        return (int)dispatch<__nv_bfloat16>(x, g, b, out, rows, c, slope, eps,
                                            stream);
    return (int)cudaErrorInvalidValue;
}
