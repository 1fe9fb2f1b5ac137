// Fused strided Conv1D + bias + channel LayerNorm + LeakyReLU, float32.
//
// Replaces tpuvc/ops/pallas_conv.py:conv_ln_lrelu (_kernel): the VAW-GAN
// encoder's layers under Architecture(conv_impl="pallas").  x [N, L, Cin]
// channels-last, w [K, Cin, Cout] (the Flax kernel layout), Flax SAME
// padding (pad_lo = max((L_out-1)*s + K - L, 0) / 2), out [N, L_out, Cout].
//
// An implicit-im2col GEMM [N*L_out, K*Cin] x [K*Cin, Cout].  Row m = (frame
// n, output position lo) of the im2col matrix is the contiguous span
// x[n, lo*s - pad_lo + tap, ci] for kidx = tap*Cin + ci, so a value needs
// only a range test against the frame (the SAME padding reads zeros), no
// division.  A CTA owns a tile of output rows and ALL Cout <= 256 columns,
// so the epilogue runs on its own accumulators: bias, the row mean and the
// two-pass variance (eps 1e-6), the norm's scale and shift, LeakyReLU
// (h > 0 ? h : slope*h); the output leaves once, in float32.  No library
// GEMM is called.  Three routes:
//
// Tensor cores (Cin a multiple of 16, Cout 32-256, 16-byte aligned x and w:
// the encoder's layers 2-5).  The first design ran the products on float32
// FMA (below), at most 44% of the 67 TFLOP/s float32 peak, and layers 2-5
// were bound by those operations.  Here they run on the tensor cores in
// split TF32 ("3xTF32"): each float32 operand v is split as hi = tf32(v)
// (round to nearest), lo = tf32(v - hi), and the accumulator takes
// lo*hi + hi*lo + hi*hi in float32, which keeps float32's accuracy (plain
// TF32 keeps ~3 digits; over up to 896-term sums scaled by the row's 1/std
// it breaks the rtol 1e-4 / atol 1e-4 bound against the float32 layer).
//   - The instruction is wgmma (m64nNk8, tf32, N = Cout: one warpgroup
//     covers 64 rows and every column), A from registers, B from shared
//     memory by descriptor.  A first version issued mma.sync.m16n8k8 with
//     both fragments read from shared memory: every layer ran at the same
//     TF32 rate whatever its shape, far under the peak, and interleaving
//     the products or deepening the copy ring did not move it; wgmma did.
//   - A (the im2col rows) is gathered per reduction chunk of 16 (one tap's
//     16 channels: Cin is a multiple of 16): a row's chunk is 64
//     contiguous bytes of x, or zeros past the frame's edge (the SAME
//     padding), four 16-byte cp.async copies with zero-fill.  Each warp
//     reads its 16 rows' fragments from shared memory (row stride 16 + 4
//     floats: conflict-free) and splits them in registers.  The im2col
//     duplication (each input feeds K/s ~ 2.3 rows) is served by L2.
//   - B (the weights) is split into hi and lo once per launch by a small
//     kernel, into scratch the wrapper allocates, already in the K-major
//     core-matrix order the descriptors name, so a chunk's hi and lo blocks
//     are one contiguous copy.
//   - A ring of three stages keeps two chunks in flight while the
//     warpgroups run the six products (two k8 steps x three passes, the
//     small ones first) of the third; cp.async writes reach the tensor
//     cores' reads through fence.proxy.async and the CTA barrier.
//   - Two warpgroups per CTA: 128 rows.  A row's columns lie in the four
//     lanes of one quad, so the norm's sums are two shuffles.
// Bound: layers 4-5 by the 3x tensor-core operations (3 * 2 K Cin per output
// value at 495 TFLOP/s), layers 2-3 by their bytes (chip_smoke.py:bound_of).
//
// Row by row (layer 1: Cin = 1, Cout = 16, K <= 16), bound by its bytes
// (1.12 GB written at the encoder's shapes).  The first design ran it on the
// FMA tiles below at ~20% of that bound: Kdim = 7 filled 7 of each 16-step,
// and the tile's stores left each warp instruction 8 bytes of every 32-byte
// sector.  One thread per output row instead: its K samples read straight
// from the frame (neighbouring rows share them in L1), the weights from
// shared memory by broadcast, the 16 products, the norm and the activation
// in registers, the row written as four float4 stores.
//
// Float32 FMA (any shape the two routes above do not take).  One CTA of 256
// threads owns BM rows: per step of 16 in the reduction dimension it stages
// an A tile [16, BM] and a weight slice [16, Cout] in shared memory, and
// each thread accumulates a TM x 8 tile in registers (rows ty + i*TY,
// columns tx + j*TX), the row statistics reduced over the TX lanes that
// share a row by __shfl_xor_sync.

#include <cuda_runtime.h>
#include <stdint.h>

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

// --- Cin = 1: one output row per thread -----------------------------------

constexpr int kRowMaxTaps = 16;

template <int COUT>
__global__ void __launch_bounds__(kThreads)
conv_ln_lrelu_row_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int n, int l, int k,
                         int stride, int pad_lo, int l_out, float slope,
                         float eps) {
    __shared__ float ws[kRowMaxTaps * COUT];
    __shared__ float bs[COUT], gs[COUT], bts[COUT];
    for (int i = threadIdx.x; i < k * COUT; i += kThreads) ws[i] = w[i];
    for (int i = threadIdx.x; i < COUT; i += kThreads) {
        bs[i] = bias[i];
        gs[i] = gamma[i];
        bts[i] = beta[i];
    }
    __syncthreads();
    const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (m >= (long long)n * l_out) return;
    const int fr = (int)(m / l_out);
    const int p0 = (int)(m - (long long)fr * l_out) * stride - pad_lo;
    const float* xr = x + (long long)fr * l;
    float acc[COUT];
#pragma unroll
    for (int c = 0; c < COUT; ++c) acc[c] = 0.0f;
    for (int tap = 0; tap < k; ++tap) {
        const int p = p0 + tap;
        const float v = p >= 0 && p < l ? __ldg(xr + p) : 0.0f;
#pragma unroll
        for (int c = 0; c < COUT; ++c)
            acc[c] = fmaf(v, ws[tap * COUT + c], acc[c]);
    }
    const float inv_c = 1.0f / (float)COUT;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
        acc[c] += bs[c];
        s += acc[c];
    }
    const float mu = s * inv_c;
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
        const float d = acc[c] - mu;
        v = fmaf(d, d, v);
    }
    const float inv = rsqrtf(v * inv_c + eps);
    float4* o = reinterpret_cast<float4*>(out + m * COUT);
#pragma unroll
    for (int q = 0; q < COUT / 4; ++q) {
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int c = 4 * q + e;
            const float y = (acc[c] - mu) * inv * gs[c] + bts[c];
            r[e] = y > 0.0f ? y : slope * y;
        }
        o[q] = make_float4(r[0], r[1], r[2], r[3]);
    }
}

// --- tensor-core route ----------------------------------------------------

constexpr int kTcBK = 16;     // reduction chunk: 16 channels of one tap
constexpr int kStages = 3;    // cp.async ring
constexpr int kApad = 4;      // A row stride kTcBK + 4: conflict-free reads
constexpr int kWarpgroups = 2;  // 64 rows each: a CTA tile of 128 rows

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

// v = hi + lo to float32 accuracy, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

// The weights w [Kdim, Cout] split into TF32 hi and lo once per launch, in
// the order the tensor cores read them from shared memory: per chunk of 16
// reduction indices, the hi block then the lo block, each [k8 step s]
// [column group j of 8][k half h][column r of 8][k q of 4] ("core matrices"
// of 8 columns x 4 k, K-major, 128 contiguous bytes each).  Every CTA
// would split the same values again.
__global__ void __launch_bounds__(kThreads)
split_tf32_kernel(const float* __restrict__ w, float* __restrict__ pairs,
                  int kdim, int cout) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= kdim * cout) return;
    const int kk = i / cout, col = i - kk * cout;
    const int off = (kk >> 4) * 32 * cout +
                    ((((kk >> 3) & 1) * (cout >> 3) + (col >> 3)) * 2 +
                     ((kk >> 2) & 1)) * 32 + (col & 7) * 4 + (kk & 3);
    uint32_t hi, lo;
    split_tf32(w[i], hi, lo);
    pairs[off] = __uint_as_float(hi);
    pairs[off + 16 * cout] = __uint_as_float(lo);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared-memory descriptor of a K-major TF32 operand without swizzle: core
// matrices of 8 rows x 16 bytes, the two along k 128 bytes apart (leading
// byte offset), consecutive 8-column groups 256 bytes apart (stride byte
// offset)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t smem_addr) {
    return (uint64_t)((smem_addr & 0x3FFFF) >> 4) |
           ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d[64 x N] += a[64 x 8] b[8 x N] for the warpgroup: a from registers in
// the m16n8k8 fragment order (each warp its 16 rows), b by descriptor; d
// as N/8 m16n8 fragments per warp
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<256>(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the accumulators are written by the tensor cores until wgmma.wait_group:
// tie every later read to the wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int COUT>
struct TcTile {
    static constexpr int kThreads = kWarpgroups * 128;
    static constexpr int BM = kWarpgroups * 64;    // 16 rows per warp
    static constexpr int AS = kTcBK + kApad;
    static constexpr int A_STAGE = BM * AS;
    static constexpr int B_STAGE = 2 * kTcBK * COUT;  // hi, lo blocks
    static constexpr int A_COPIES = BM * (kTcBK / 4) / kThreads;
    static constexpr int B_COPIES = B_STAGE / 4 / kThreads;
    static constexpr int SMEM_BYTES = kStages * (A_STAGE + B_STAGE) * 4;
    static_assert(A_COPIES >= 1 && B_COPIES >= 1 &&
                  BM * (kTcBK / 4) % kThreads == 0 &&
                  B_STAGE / 4 % kThreads == 0 && A_STAGE * 4 % 128 == 0,
                  "tile");
};

template <int COUT>
__global__ void __launch_bounds__(kWarpgroups * 128)
conv_ln_lrelu_tc_kernel(const float* __restrict__ x,
                        const float* __restrict__ wp,
                        const float* __restrict__ bias,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        float* __restrict__ out, int n, int l, int cin,
                        int k, int stride, int pad_lo, int l_out, float slope,
                        float eps) {
    using T = TcTile<COUT>;
    constexpr int AS = T::AS;
    extern __shared__ __align__(128) float4 smem4[];
    float* const As = reinterpret_cast<float*>(smem4);  // [kStages][BM][AS]
    float* const Bs = As + kStages * T::A_STAGE;  // [kStages][2][16 Cout]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m_total = n * l_out;
    const int m0 = blockIdx.x * T::BM;
    const int chunks = k * cin / kTcBK;

    // this thread's A copies: rows tid/4 + (kThreads/4) i, channels
    // 4 (tid%4) .. +3 of the chunk
    const int q = tid & 3;
    int fbase[T::A_COPIES], p0[T::A_COPIES];
#pragma unroll
    for (int i = 0; i < T::A_COPIES; ++i) {
        const int m = m0 + (tid >> 2) + (T::kThreads / 4) * i;
        if (m < m_total) {
            const int fr = m / l_out;
            fbase[i] = fr * l;
            p0[i] = (m - fr * l_out) * stride - pad_lo;
        } else {
            fbase[i] = 0;
            p0[i] = -(1 << 29);                // always out of range
        }
    }

    auto load = [&](int stage, int c) {
        const int k0 = c * kTcBK;
        const int tap = k0 / cin;
        const int ch = k0 - tap * cin + 4 * q;
        float* as = As + stage * T::A_STAGE;
#pragma unroll
        for (int i = 0; i < T::A_COPIES; ++i) {
            const int pos = p0[i] + tap;
            const bool ok = pos >= 0 && pos < l;
            const float* src =
                ok ? x + ((long long)(fbase[i] + pos) * cin + ch) : x;
            cp_async16(as + ((tid >> 2) + (T::kThreads / 4) * i) * AS + 4 * q,
                       src, ok);
        }
        float* bs = Bs + stage * T::B_STAGE;
        const float* src = wp + (long long)c * T::B_STAGE;
#pragma unroll
        for (int i = 0; i < T::B_COPIES; ++i) {
            const int p = tid + T::kThreads * i;
            cp_async16(bs + 4 * p, src + 4 * p, true);
        }
    };

    float acc[COUT / 2];
#pragma unroll
    for (int i = 0; i < COUT / 2; ++i) acc[i] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < chunks) load(s, s);
        cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - 2>();          // chunk c has landed
        // make this thread's copies visible to the tensor cores' reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();                       // and chunk c-1 is consumed
        if (c + kStages - 1 < chunks)
            load((c + kStages - 1) % kStages, c + kStages - 1);
        cp_async_commit();
        // this warp's A fragments (rows 16 warp + g, + 8) split in registers
        const float* ar = As + (c % kStages) * T::A_STAGE +
                          (warp * 16 + g) * AS + t;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            split_tf32(ar[8 * ks], ah[ks][0], al[ks][0]);
            split_tf32(ar[8 * AS + 8 * ks], ah[ks][1], al[ks][1]);
            split_tf32(ar[8 * ks + 4], ah[ks][2], al[ks][2]);
            split_tf32(ar[8 * AS + 8 * ks + 4], ah[ks][3], al[ks][3]);
        }
        const uint32_t bs = (uint32_t)__cvta_generic_to_shared(
            Bs + (c % kStages) * T::B_STAGE);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            // k8 step ks of the hi and lo blocks; the small products first
            const uint64_t bh = kmajor_desc(bs + ks * 32 * COUT);
            const uint64_t bl = kmajor_desc(bs + 64 * COUT + ks * 32 * COUT);
            wgmma_tf32<COUT>(acc, al[ks], bh);
            wgmma_tf32<COUT>(acc, ah[ks], bl);
            wgmma_tf32<COUT>(acc, ah[ks], bh);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
    }
    cp_async_wait<0>();

    // epilogue: thread (g, t) holds rows 16 warp + g (h = 0) and + 8 (h = 1),
    // columns 8 j + 2 t + e in acc[4 j + 2 h + e]; a row's columns lie in
    // the four lanes of its quad
    const float inv_c = 1.0f / (float)COUT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                acc[4 * j + 2 * h + e] += bias[8 * j + 2 * t + e];
                s += acc[4 * j + 2 * h + e];
            }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        const float mu = s * inv_c;
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float d = acc[4 * j + 2 * h + e] - mu;
                v = fmaf(d, d, v);
            }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const float rs = rsqrtf(v * inv_c + eps);
        const int m = m0 + warp * 16 + 8 * h + g;
        if (m >= m_total) continue;
        float* o = out + (long long)m * COUT + 2 * t;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j) {
            float r[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * t + e;
                const float y = (acc[4 * j + 2 * h + e] - mu) * rs *
                                    gamma[col] + beta[col];
                r[e] = y > 0.0f ? y : slope * y;
            }
            *reinterpret_cast<float2*>(o + 8 * j) = make_float2(r[0], r[1]);
        }
    }
}

template <int COUT, int TM>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* g, const float* bt, float* out, int n, int l,
                   int cin, int k, int stride, int pad_lo, int l_out,
                   float slope, float eps, cudaStream_t stream) {
    constexpr int BM = kThreads / (COUT / kTN) * TM;
    const long long m_total = (long long)n * l_out;
    const int blocks = (int)((m_total + BM - 1) / BM);
    conv_ln_lrelu_kernel<COUT, TM><<<blocks, kThreads, 0, stream>>>(
        x, w, b, g, bt, out, n, l, cin, k, stride, pad_lo, l_out, slope, eps);
    return cudaGetLastError();
}

template <int COUT>
cudaError_t launch_row(const float* x, const float* w, const float* b,
                       const float* g, const float* bt, float* out, int n,
                       int l, int k, int stride, int pad_lo, int l_out,
                       float slope, float eps, cudaStream_t stream) {
    const long long m_total = (long long)n * l_out;
    const int blocks = (int)((m_total + kThreads - 1) / kThreads);
    conv_ln_lrelu_row_kernel<COUT><<<blocks, kThreads, 0, stream>>>(
        x, w, b, g, bt, out, n, l, k, stride, pad_lo, l_out, slope, eps);
    return cudaGetLastError();
}

template <int COUT>
cudaError_t launch_tc(const float* x, const float* w, float* w_pairs,
                      const float* b, const float* g, const float* bt,
                      float* out, int n, int l, int cin, int k, int stride,
                      int pad_lo, int l_out, float slope, float eps,
                      cudaStream_t stream) {
    using T = TcTile<COUT>;
    const int count = k * cin * COUT;
    split_tf32_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(w, w_pairs, k * cin, COUT);
    auto kern = conv_ln_lrelu_tc_kernel<COUT>;
    // the opt-in above 48 KB belongs to the current device's context, and
    // a process may drive several cards from several threads: set it on
    // every launch (a host call of a few microseconds) rather than once
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    const long long m_total = (long long)n * l_out;
    const int blocks = (int)((m_total + T::BM - 1) / T::BM);
    kern<<<blocks, T::kThreads, T::SMEM_BYTES, stream>>>(
        x, w_pairs, b, g, bt, out, n, l, cin, k, stride, pad_lo, l_out, slope,
        eps);
    return cudaGetLastError();
}

}  // namespace

// w_pairs: scratch of K*Cin*Cout float2 for the tensor-core route's split
// weights (the wrapper allocates it)
extern "C" int tpuvc_conv_ln_lrelu(const float* x, const float* w,
                                   float* w_pairs, const float* b,
                                   const float* g, const float* bt,
                                   float* out, int n, int l, int cin,
                                   int cout, int k, int stride, float slope,
                                   float eps, cudaStream_t stream) {
    if (n < 0 || l < 1 || cin < 1 || k < 1 || stride < 1)
        return (int)cudaErrorInvalidValue;
    // element indices are 32-bit inside the kernels
    const long long l_out = (l + stride - 1) / stride;
    if ((long long)n * l * cin >= (1LL << 31) ||
        (long long)n * l_out * cout >= (1LL << 31) ||
        (long long)(l_out * stride + k) * cin >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    int pad_total = (int)((l_out - 1) * stride + k - l);
    if (pad_total < 0) pad_total = 0;
    const int pad_lo = pad_total / 2, lo = (int)l_out;
    const auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    // routes: the first layer's shape row by row; whole 16-channel chunks
    // of 16-byte aligned rows on the tensor cores; anything else on FMA
    if (cin == 1 && cout == 16 && k <= kRowMaxTaps && aligned(out))
        return (int)launch_row<16>(x, w, b, g, bt, out, n, l, k, stride,
                                   pad_lo, lo, slope, eps, stream);
    const bool tc = cin % kTcBK == 0 && aligned(x) && aligned(w_pairs);
    switch (cout) {  // the encoder's output widths
        case 16:
            return (int)launch<16, 1>(x, w, b, g, bt, out, n, l, cin, k,
                                      stride, pad_lo, lo, slope, eps, stream);
        case 32:
            return (int)(tc ? launch_tc<32>(x, w, w_pairs, b, g, bt, out,
                                                  n, l, cin, k, stride, pad_lo,
                                                  lo, slope, eps, stream)
                            : launch<32, 2>(x, w, b, g, bt, out, n, l, cin, k,
                                            stride, pad_lo, lo, slope, eps,
                                            stream));
        case 64:
            return (int)(tc ? launch_tc<64>(x, w, w_pairs, b, g, bt, out,
                                                  n, l, cin, k, stride, pad_lo,
                                                  lo, slope, eps, stream)
                            : launch<64, 4>(x, w, b, g, bt, out, n, l, cin, k,
                                            stride, pad_lo, lo, slope, eps,
                                            stream));
        case 128:
            return (int)(tc ? launch_tc<128>(x, w, w_pairs, b, g, bt,
                                                   out, n, l, cin, k, stride,
                                                   pad_lo, lo, slope, eps,
                                                   stream)
                            : launch<128, 8>(x, w, b, g, bt, out, n, l, cin,
                                             k, stride, pad_lo, lo, slope,
                                             eps, stream));
        case 256:
            return (int)(tc ? launch_tc<256>(x, w, w_pairs, b, g, bt,
                                                   out, n, l, cin, k, stride,
                                                   pad_lo, lo, slope, eps,
                                                   stream)
                            : launch<256, 8>(x, w, b, g, bt, out, n, l, cin,
                                             k, stride, pad_lo, lo, slope,
                                             eps, stream));
        default: return (int)cudaErrorInvalidValue;
    }
}
