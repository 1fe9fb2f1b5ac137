// One residual layer of Parallel WaveGAN's generator in one launch (K13).
//
// Replaces no Pallas kernel: the JAX package has no vocoder.  The port ran
// each layer as about ten PyTorch launches (cuDNN's dilated convolution,
// cuBLAS's products, ATen's bias adds, tanh, sigmoid and their product),
// and each of them wrote its [P, 128] or [P, 64] result to device memory
// for the next one to read back.  Here one launch reads what a layer must
// read and writes what it must write.
//
// For each position t of a row (the module's arithmetic, the operands in
// bfloat16, every sum in float32):
//   h     = [x(t-d) | x(t) | x(t+d) | c(t)] . W1 + b_conv      [128]
//           (W1 [272, 128]: the dilated convolution's three taps over the
//           64 residual channels, stacked on conv1x1_aux's 80 rows; taps
//           outside [0, T) read zero: SAME padding (k - 1) / 2 * d)
//   g     = bf16(tanh(h[0:64]) * sigmoid(h[64:128]))            [64]
//   [s|o] = g . [W_skip | W_out]                               [64 | 64]
//   skip  = bf16(skip + s)                  (in place; its bias is summed
//                                            once after the stack)
//   out   = bf16(r * ((x(t) + o) + b_out)),  r = sqrt(1/2)
// tanh is the hardware's tanh.approx.f32 (relative error under 2^-11, a
// quarter of g's bf16 rounding step), sigmoid 1 / (1 + exp(-h)) with the
// hardware's exp2 and reciprocal.  out must not alias x: neighbouring
// tiles read x(t +- d).
//
// Bound: device-memory bytes.  A position reads x (128 B), c (160 B) and
// skip (128 B) and writes skip and out (256 B): 672 B, against 86,016
// operations (128 a byte, under the card's ~295 bf16 operations a byte).
// x(t - d) and x(t + d) are rows that neighbouring tiles read as their
// x(t): they come from L2, not from device memory.
//
// Design: a persistent CTA per SM (8 warps, ~221 KB of shared memory)
// loads W1 and [W_skip | W_out] into shared memory once.  Its four warp
// pairs then walk tiles of 32 positions of one row, each pair on its own
// and with its own two stages, so one pair's gate and stores overlap
// another's products.  A tile's A operand, [32, 272] bf16, is gathered by
// 16-byte cp.async copies (zero-fill at the row's ends and past T), and
// the pair's next tile is in flight while this one computes.  The
// products are mma.sync m16n8k16 (bf16 in, float32 accumulators) with
// both operands read by ldmatrix.  Warp q of a pair computes the h columns
// 32q..32q + 31 and 64 + 32q..64 + 32q + 31 of the tile's 32 positions,
// so the thread that holds h[j] also holds h[64 + j] and gates it in
// registers; g is rounded to bf16 once, into the stage's x(t - d) columns
// (which only the first product read), and the pair's two warps read it
// back as the A operand of [s | o], warp q computing half q.  h never
// leaves the registers and g never leaves shared memory.  The new skip
// sums and x go into the stage's x(t + d) and x(t) columns, and leave in
// 16-byte stores, a row's 256 bytes to 16 consecutive threads.  Rows of
// 272 bf16 (34 chunks of 16 B) are stored with chunk c of row r at
// c ^ ((r >> 2) & 1), and W_skip|W_out's rows of 8 chunks at c ^ (r & 7):
// ldmatrix's eight rows then fall in eight distinct bank groups.  skip is
// read into registers once the first product is issued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRes = 64;                       // residual channels
constexpr int kGate = 128;                     // gate channels
constexpr int kHalf = kGate / 2;               // g's width
constexpr int kSkip = 64;                      // skip channels
constexpr int kAux = 80;                       // conditioning channels
constexpr int kTaps = 3;                       // kernel size
constexpr int kK1 = kTaps * kRes + kAux;       // 272: the first product's K
constexpr int kN2 = kSkip + kRes;              // 128: the second's N
constexpr int kTM = 32;                        // positions a tile: two m16
constexpr int kPairs = 4;                      // warp pairs a CTA
constexpr int kThreads = 64 * kPairs;
constexpr int kChunks1 = kK1 * 2 / 16;         // 34 16-byte chunks a row
constexpr int kChunks2 = kHalf * 2 / 16;       // 8
constexpr int kXChunks = kRes * 2 / 16;        // 8 a tap
constexpr int kCChunks = kAux * 2 / 16;        // 10

// shared memory, in bytes: W1 rows (n) of K1, W2 rows (n) of 64, each
// pair's two A stages of kTM rows of K1, then the biases in float32
constexpr int kW1Off = 0;
constexpr int kW2Off = kW1Off + kGate * kK1 * 2;          // 69,632
constexpr int kStageOff = kW2Off + kN2 * kHalf * 2;       // +16,384
constexpr int kStageBytes = kTM * kK1 * 2;                // 17,408
constexpr int kBiasOff = kStageOff + kPairs * 2 * kStageBytes;
constexpr int kSmemBytes = kBiasOff + (kGate + kRes) * 4; // 226,048

static_assert(kTaps * kXChunks + kCChunks == kChunks1 && kChunks1 % 2 == 0,
              "a row of A: the taps' chunks, then c's");
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(kTM % 8 == 0 && kTM * kCChunks % 64 == 0 && kXChunks == 8,
              "a tile's chunks over a pair's 64 threads");
static_assert(kSkip == kRes, "skip and x rows leave as 8 chunks each");

// byte offset of 16-byte chunk c of row r, rows of 34 or of 8 chunks
__device__ __forceinline__ uint32_t at34(int r, int c) {
    return (uint32_t)(r * kChunks1 + (c ^ ((r >> 2) & 1))) * 16u;
}
__device__ __forceinline__ uint32_t at8(int r, int c) {
    return (uint32_t)(r * kChunks2 + (c ^ (r & 7))) * 16u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// d += a . b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two warps of pair p (named barrier 1 + p; 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int p) {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + p) : "memory");
}

__device__ __forceinline__ float tanh_approx(float v) {
    float y;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(v));
    return y;
}

__device__ __forceinline__ float gate(float a, float b) {
    return tanh_approx(a) * __fdividef(1.0f, 1.0f + __expf(-b));
}

// two floats as one bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// a tile's A operand into the stage at `stage` (a shared address), by
// the 64 threads of a warp pair (pt: this thread's index among them): row
// r = position t0 + r, chunks 0-7 x(t - d), 8-15 x(t), 16-23 x(t + d),
// 24-33 c(t); zeros outside [0, T).  Eight consecutive threads copy one
// 128-byte row of x, ten consecutive chunks make a row of c.
__device__ __forceinline__ void load_tile(uint32_t stage,
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* c, int pt,
                                          int b, int t0, int t_len, int d) {
    const size_t row0 = (size_t)b * t_len;
    const int cc = pt & 7, rsub = pt >> 3;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
        for (int rb = 0; rb < kTM / 8; ++rb) {
            const int r = rsub + 8 * rb, t = t0 + r;
            const int ts = t + (tap - 1) * d;
            const bool ok = t < t_len && ts >= 0 && ts < t_len;
            cp_async16(stage + at34(r, tap * kXChunks + cc),
                       x + (row0 + (ok ? ts : 0)) * kRes + cc * 8, ok);
        }
#pragma unroll
    for (int k = 0; k < kTM * kCChunks / 64; ++k) {
        const int i = pt + 64 * k;
        const int r = i / kCChunks, ch = i - r * kCChunks, t = t0 + r;
        const bool ok = t < t_len;
        cp_async16(stage + at34(r, kTaps * kXChunks + ch),
                   c + (row0 + (ok ? t : 0)) * kAux + ch * 8, ok);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
pwg_residual_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ c,
                    __nv_bfloat16* __restrict__ skip,
                    __nv_bfloat16* __restrict__ out,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ w2,
                    const float* __restrict__ b_conv,
                    const float* __restrict__ b_out, int bsz, int t_len,
                    int d, float r) {
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
    const float* bc_s = reinterpret_cast<const float*>(smem + kBiasOff);
    const float* bo_s = bc_s + kGate;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;
    // warp pair `pair` walks its own tiles with its own two stages; warp q
    // of the pair takes the h columns 32q..32q + 31 (gate a) and 64 + 32q..
    // (gate b), then [s | o]'s half q
    const int pair = warp >> 1, q = warp & 1, pt = tid & 63;
    const int tiles_per_row = (t_len + kTM - 1) / kTM;
    const long long n_tiles = (long long)bsz * tiles_per_row;
    const long long stride = (long long)gridDim.x * kPairs;
    long long tile = (long long)blockIdx.x * kPairs + pair;

    // the weights once: W1 [128][272], W2 [128][64] (rows are output
    // channels, K contiguous: ldmatrix without .trans gives B fragments)
    for (int i = tid; i < kGate * kChunks1; i += kThreads) {
        const int n = i / kChunks1, ch = i - n * kChunks1;
        cp_async16(base + kW1Off + at34(n, ch), w1 + n * kK1 + ch * 8, true);
    }
    for (int i = tid; i < kN2 * kChunks2; i += kThreads) {
        const int n = i / kChunks2, ch = i - n * kChunks2;
        cp_async16(base + kW2Off + at8(n, ch), w2 + n * kHalf + ch * 8, true);
    }
    {
        float* bias = reinterpret_cast<float*>(smem + kBiasOff);
        for (int i = tid; i < kGate + kRes; i += kThreads)
            bias[i] = i < kGate ? b_conv[i] : b_out[i - kGate];
    }
    const uint32_t stages = base + kStageOff + pair * 2 * kStageBytes;
    unsigned char* const stages_p = smem + kStageOff + pair * 2 * kStageBytes;
    if (tile < n_tiles)
        load_tile(stages, x, c, pt, (int)(tile / tiles_per_row),
                  (int)(tile % tiles_per_row) * kTM, t_len, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();        // the weights, the biases and every first tile

    // lane offsets of the ldmatrix addresses: A (rows m, chunks k), B
    // (rows n, chunks k)
    const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_ch = lane >> 4;
    const int b_row = (lane & 7) + 8 * (lane >> 4), b_ch = (lane >> 3) & 1;

    for (int s = 0; tile < n_tiles; tile += stride, s ^= 1) {
        const long long next = tile + stride;
        if (next < n_tiles)
            load_tile(stages + (s ^ 1) * kStageBytes, x, c, pt,
                      (int)(next / tiles_per_row),
                      (int)(next % tiles_per_row) * kTM, t_len, d);
        cp_async_commit();
        cp_async_wait<1>();
        pair_sync(pair);

        const int b = (int)(tile / tiles_per_row);
        const int t0 = (int)(tile % tiles_per_row) * kTM;
        const uint32_t stage = stages + s * kStageBytes;
        unsigned char* const stage_p = stages_p + s * kStageBytes;

        // h = A . W1 + b_conv over this warp's columns: [m-tile][k][4],
        // k < 4 the n-tile 4q + k (gate a), k >= 4 the n-tile 4 + 4q + k
        float acc[2][8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const int col = 8 * (k < 4 ? 4 * q + k : 4 + 4 * q + k) + 2 * tig;
            const float v0 = bc_s[col], v1 = bc_s[col + 1];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                acc[mt][k][0] = v0;
                acc[mt][k][1] = v1;
                acc[mt][k][2] = v0;
                acc[mt][k][3] = v1;
            }
        }
#pragma unroll
        for (int kc = 0; kc < kK1 / 16; ++kc) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldsm_x4(a[mt], stage + at34(16 * mt + a_row, 2 * kc + a_ch));
#pragma unroll
            for (int u = 0; u < 4; ++u) {   // 16 rows of W1 at a time
                const int n0 = (u < 2 ? 0 : kHalf) + 32 * q + 16 * (u & 1);
                uint32_t bb[4];
                ldsm_x4(bb, base + kW1Off + at34(n0 + b_row, 2 * kc + b_ch));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma(acc[mt][2 * u], a[mt], bb[0], bb[1]);
                    mma(acc[mt][2 * u + 1], a[mt], bb[2], bb[3]);
                }
            }
        }

        // the skip values the epilogue of warp 0 of the pair adds to:
        // [m-tile][column tile][row g, g + 8]
        uint32_t sk[2][8][2];
        if (q == 0) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int t = t0 + 16 * mt + g + 8 * h;
                    const uint32_t* p = reinterpret_cast<const uint32_t*>(
                        skip + ((size_t)b * t_len + (t < t_len ? t : 0))
                                   * kSkip + 2 * tig);
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        sk[mt][j][h] = t < t_len ? p[4 * j] : 0u;
                }
        }

        // g = tanh(h_a) sigmoid(h_b), rounded once, into the stage's
        // chunks 0-7 (x(t - d), which both warps of the pair have read)
        pair_sync(pair);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float* ha = acc[mt][i];
                const float* hb = acc[mt][i + 4];
                const int row = 16 * mt + g;
                *reinterpret_cast<uint32_t*>(
                    stage_p + at34(row, 4 * q + i) + 4 * tig) =
                    pack(gate(ha[0], hb[0]), gate(ha[1], hb[1]));
                *reinterpret_cast<uint32_t*>(
                    stage_p + at34(row + 8, 4 * q + i) + 4 * tig) =
                    pack(gate(ha[2], hb[2]), gate(ha[3], hb[3]));
            }
        pair_sync(pair);

        // this warp's half of [s | o] = g . [W_skip | W_out]: [m-tile][n-tile]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][k][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldsm_x4(a[mt], stage + at34(16 * mt + a_row, 2 * kk + a_ch));
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                uint32_t bb[4];
                ldsm_x4(bb, base + kW2Off + at8(64 * q + 16 * u + b_row,
                                                2 * kk + b_ch));
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma(acc[mt][2 * u], a[mt], bb[0], bb[1]);
                    mma(acc[mt][2 * u + 1], a[mt], bb[2], bb[3]);
                }
            }
        }

        // warp 0: skip + s into chunks 16-23 (x(t + d), which only the
        // first product read); warp 1: r ((x(t) + o) + b_out) over x(t) in
        // chunks 8-15, in place
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * mt + g + 8 * h;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float o0 = acc[mt][j][2 * h];
                    const float o1 = acc[mt][j][2 * h + 1];
                    uint32_t* v = reinterpret_cast<uint32_t*>(
                        stage_p + at34(row, (q == 0 ? 2 : 1) * kXChunks + j)
                        + 4 * tig);
                    if (q == 0) {
                        const float2 old = unpack(sk[mt][j][h]);
                        *v = pack(old.x + o0, old.y + o1);
                    } else {
                        const int col = 8 * j + 2 * tig;
                        const float2 xt = unpack(*v);
                        *v = pack(r * ((xt.x + o0) + bo_s[col]),
                                  r * ((xt.y + o1) + bo_s[col + 1]));
                    }
                }
            }
        pair_sync(pair);
        // the rows' skip sums and next x out in 16-byte stores: a row's 16
        // chunks to consecutive threads
#pragma unroll
        for (int k = 0; k < kTM * 2 * kXChunks / 64; ++k) {
            const int i = pt + 64 * k;
            const int row = i >> 4, ch = i & 15, t = t0 + row;
            if (t >= t_len) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(
                stage_p + at34(row, ch < kXChunks ? 2 * kXChunks + ch : ch));
            __nv_bfloat16* dst = ch < kXChunks ? skip : out;
            *reinterpret_cast<uint4*>(dst + ((size_t)b * t_len + t) * kRes
                                      + (ch & (kXChunks - 1)) * 8) = v;
        }
        pair_sync(pair);    // the stage is refilled two tiles on
    }
}

}  // namespace

// x and out [B, T, 64], c [B, T, 80], skip [B, T, 64] bfloat16, contiguous
// and 16-byte aligned; w1 [128, 272] and w2 [128, 64] bfloat16 (rows:
// output channels), b_conv [128] and b_out [64] float32.  skip is updated
// in place; out must not overlap x.
extern "C" int tpuvc_pwg_residual(const void* x, const void* c, void* skip,
                                  void* out, const void* w1, const void* w2,
                                  const float* b_conv, const float* b_out,
                                  int bsz, int t_len, int dilation, float r,
                                  cudaStream_t stream) {
    if (bsz < 0 || t_len < 0 || dilation < 1)
        return (int)cudaErrorInvalidValue;
    if (bsz == 0 || t_len == 0) return (int)cudaGetLastError();
    // the opt-in above 48 KB belongs to the current device's context: set
    // it on every launch (a mesh drives several cards from several threads)
    cudaError_t e = cudaFuncSetAttribute(
        pwg_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long tiles = (long long)bsz * ((t_len + kTM - 1) / kTM);
    const long long ctas = (tiles + kPairs - 1) / kPairs;
    const int grid = (int)(ctas < sms ? ctas : sms);
    pwg_residual_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(c),
        static_cast<__nv_bfloat16*>(skip), static_cast<__nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(w1),
        static_cast<const __nv_bfloat16*>(w2), b_conv, b_out, bsz, t_len,
        dilation, r);
    return (int)cudaGetLastError();
}
