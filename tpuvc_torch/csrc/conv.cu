// Fused strided Conv1D + bias + channel LayerNorm + LeakyReLU, float32.
//
// Replaces tpuvc/ops/pallas_conv.py:conv_ln_lrelu (_kernel): the VAW-GAN
// encoder's layers under Architecture(conv_impl="pallas").  x [N, L, Cin]
// channels-last, w [K, Cin, Cout] (the Flax kernel layout), Flax SAME
// padding (pad_lo = max((L_out-1)*s + K - L, 0) / 2), out [N, L_out, Cout].
//
// An implicit-im2col GEMM [N*L_out, K*Cin] x [K*Cin, Cout] on float32 CUDA
// cores (FMA).  Row m = (frame n, output position lo) of the im2col matrix
// is the contiguous span x[n, lo*s - pad_lo + tap, ci] for kidx = tap*Cin +
// ci, so a staged element needs only a range test against the frame (the
// SAME padding reads zeros), no division.  One CTA of 256 threads owns BM
// output rows and ALL Cout <= 256 columns: per step of 16 in the reduction
// dimension it stages an A tile [16, BM] and a weight slice [16, Cout] in
// shared memory, and each thread accumulates a TM x 8 tile in registers
// (rows ty + i*TY, columns tx + j*TX, so neither tile read conflicts on a
// bank).  The epilogue runs on those accumulators: bias, the row mean and
// the two-pass variance (eps 1e-6) reduced over the TX lanes that share a
// row by __shfl_xor_sync, the norm's scale and shift, LeakyReLU
// (h > 0 ? h : slope*h); the output leaves once, in float32.  No library
// GEMM is called.
//
// Bound: float32 operations at the encoder's widths (2*K*Cin*Cout per
// output row: 325 GFLOP for the five layers at 102528 frames, ~4.9 ms at
// 67 TFLOP/s) except the first layer (Cin = 1), which is bound by writing
// its output.  Weights are re-read from L2 by every CTA: BM rows amortise
// each weight slice over BM x 2 operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr int kTN = 8;

template <int COUT, int TM>
__global__ void __launch_bounds__(kThreads)
conv_ln_lrelu_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     int n, int l, int cin, int k, int stride, int pad_lo,
                     int l_out, float slope, float eps) {
    constexpr int TX = COUT / kTN;            // lanes sharing a row
    constexpr int TY = kThreads / TX;
    constexpr int BM = TY * TM;
    constexpr int kRowsPerThread = BM * kBK / kThreads;
    static_assert(BM * kBK % kThreads == 0 && kThreads % kBK == 0, "tile");
    __shared__ float As[kBK][BM + 1];
    __shared__ float Ws[kBK][COUT];

    const int tid = threadIdx.x;
    const int tx = tid % TX, ty = tid / TX;
    const int m_total = n * l_out;
    const int m0 = blockIdx.x * BM;
    const int kdim = k * cin;
    const int frame_len = l * cin;

    // the A rows this thread stages: row tid/16 + 16*r, column tid%16
    const int kk_a = tid % kBK;
    int base[kRowsPerThread], start[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
        const int m = m0 + tid / kBK + (kThreads / kBK) * r;
        if (m < m_total) {
            const int fr = m / l_out;
            const int lo = m - fr * l_out;
            base[r] = fr * frame_len;
            start[r] = (lo * stride - pad_lo) * cin;
        } else {
            base[r] = 0;
            start[r] = -(1 << 30);            // always out of range
        }
    }

    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < kdim; k0 += kBK) {
        const int kidx = k0 + kk_a;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const int pos = start[r] + kidx;
            As[kk_a][tid / kBK + (kThreads / kBK) * r] =
                (kidx < kdim && pos >= 0 && pos < frame_len)
                    ? x[(long long)base[r] + pos] : 0.0f;
        }
#pragma unroll
        for (int e = tid; e < kBK * COUT; e += kThreads) {
            const int kk = e / COUT, co = e % COUT;
            Ws[kk][co] = k0 + kk < kdim ? w[(long long)(k0 + kk) * COUT + co]
                                        : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
            float a[TM], b[kTN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * TY];
#pragma unroll
            for (int j = 0; j < kTN; ++j) b[j] = Ws[kk][tx + j * TX];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < kTN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float bb[kTN], gg[kTN], be[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
        bb[j] = bias[tx + j * TX];
        gg[j] = gamma[tx + j * TX];
        be[j] = beta[tx + j * TX];
    }
    const float inv_c = 1.0f / (float)COUT;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            acc[i][j] += bb[j];
            s += acc[i][j];
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
        const float mu = s * inv_c;
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const float d = acc[i][j] - mu;
            v = fmaf(d, d, v);
        }
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        const float inv = rsqrtf(v * inv_c + eps);
        const int m = m0 + ty + i * TY;
        if (m < m_total) {
            float* o = out + (long long)m * COUT;
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
                const float h = (acc[i][j] - mu) * inv * gg[j] + be[j];
                o[tx + j * TX] = h > 0.0f ? h : slope * h;
            }
        }
    }
}

template <int COUT, int TM>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* g, const float* bt, float* out, int n, int l,
                   int cin, int k, int stride, float slope, float eps,
                   cudaStream_t stream) {
    constexpr int BM = kThreads / (COUT / kTN) * TM;
    const int l_out = (l + stride - 1) / stride;
    int pad_total = (l_out - 1) * stride + k - l;
    if (pad_total < 0) pad_total = 0;
    const long long m_total = (long long)n * l_out;
    const int blocks = (int)((m_total + BM - 1) / BM);
    conv_ln_lrelu_kernel<COUT, TM><<<blocks, kThreads, 0, stream>>>(
        x, w, b, g, bt, out, n, l, cin, k, stride, pad_total / 2, l_out,
        slope, eps);
    return cudaGetLastError();
}

}  // namespace

extern "C" int tpuvc_conv_ln_lrelu(const float* x, const float* w,
                                   const float* b, const float* g,
                                   const float* bt, float* out, int n, int l,
                                   int cin, int cout, int k, int stride,
                                   float slope, float eps,
                                   cudaStream_t stream) {
    if (n < 0 || l < 1 || cin < 1 || k < 1 || stride < 1)
        return (int)cudaErrorInvalidValue;
    // element indices are 32-bit inside the kernel
    const long long l_out = (l + stride - 1) / stride;
    if ((long long)n * l * cin >= (1LL << 31) ||
        (long long)n * l_out * cout >= (1LL << 31) ||
        (long long)(l_out * stride + k) * cin >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    switch (cout) {  // the encoder's output widths
        case 16: return (int)launch<16, 1>(x, w, b, g, bt, out, n, l, cin, k,
                                           stride, slope, eps, stream);
        case 32: return (int)launch<32, 2>(x, w, b, g, bt, out, n, l, cin, k,
                                           stride, slope, eps, stream);
        case 64: return (int)launch<64, 4>(x, w, b, g, bt, out, n, l, cin, k,
                                           stride, slope, eps, stream);
        case 128: return (int)launch<128, 8>(x, w, b, g, bt, out, n, l, cin,
                                             k, stride, slope, eps, stream);
        case 256: return (int)launch<256, 8>(x, w, b, g, bt, out, n, l, cin,
                                             k, stride, slope, eps, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
