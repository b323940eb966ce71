// 3x3 stride-1 SAME convolution of int8 NHWC activations with int8 weights,
// int32 sums, then the w8a8 dequantize + bias (+ ReLU) in f32, for Hopper.
//
// K7 of the port.  It has no Pallas counterpart: the JAX package computes
// each w8a8 conv with lax.conv_general_dilated(..., preferred_element_type=
// int32) outside any kernel (unetseg_tpu/quantize.py::_conv_w8a8, :223-232),
// and PyTorch has no int8 convolution on CUDA (F.conv2d refuses int8).
//
//   out[p, d] = relu(float(sum_{tap, c} x[p + tap, c] * wk[tap, d, c])
//                    * scale[d] + bias[d])
//
// with scale[d] = act_scale * w_scale[d] computed once by the caller (one
// f32 rounding, as JAX's act_scale * w_scale).  The epilogue rounds exactly
// as JAX's order does: float(acc) (round to nearest), then the product, then
// the bias add, each by __fmul_rn / __fadd_rn so nvcc cannot contract them
// into an FMA.  The int32 sums are exact (|acc| <= 9 * C * 127^2 < 2^31 for
// C <= 14,000), so the output is bit-equal to the plain version.
//
// GEMM view: M = output pixels (B*H*W, flattened), N = D output channels,
// K = 9*C in the order (tap, channel), tap = dy*3 + dx.  The weights come
// K-major, (3, 3, D, C), so that four consecutive k of one output channel
// are one 32-bit register of an mma.sync B fragment.
//
// Design (a simple kernel that is right; making it fast is later work):
//   * one block of 128 threads (4 warps) computes 128 pixels x 64 channels;
//     each warp 32 pixels x 64 channels as 2 x 8 mma.sync.m16n8k32 s8 tiles
//     with int32 accumulators in registers;
//   * a K step is one tap and 32 channels: each thread loads its pixel's two
//     16-byte halves (zero outside the image: the SAME padding, and zero past
//     C, so C = 16 runs as half-empty steps) and one 16-byte half of a weight
//     row, into registers, while the tensor cores work on the previous step;
//     then stores them to the other of two shared-memory buffers;
//   * shared rows are 48 bytes (32 of K + 16 of pad), so the fragment reads
//     of a warp (8 rows x 4 words) hit 32 distinct banks.
// What bounds it on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s): for
// slim4's convs the int8 operations, 0.1-0.4 ms a conv at batch 128; this
// kernel reaches a fraction of that (mma.sync, no TMA, no pipelining beyond
// one step of register prefetch).
//
// Entry point: utconv3x3_s8(x, wk, scale, bias, out, B, H, W, C, D, relu,
// stream) -> 0, or -1 if C or D is not a multiple of 16, or the CUDA error
// of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // channels per K step
constexpr int THREADS = 128;  // 4 warps, 32 pixel rows each
constexpr int ROW = 48;       // bytes per shared row: BK + 16 pad
constexpr int ERR_PLAN = -1;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float scale, float bias,
                                         int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(y, 0.0f) : y;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int H, int W, int C, int D, int relu) {
  __shared__ __align__(16) int8_t a_s[2][BM * ROW];
  __shared__ __align__(16) int8_t b_s[2][BN * ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma groupID, thread in group
  const long long P = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // This thread's A row: one output pixel, both 16-byte halves of a K step.
  const long long p = m0 + tid;
  const bool p_ok = p < P;
  const int pw = p_ok ? static_cast<int>(p % W) : 0;
  const int ph = p_ok ? static_cast<int>((p / W) % H) : 0;
  const long long pb = p_ok ? p / (static_cast<long long>(W) * H) : 0;
  // This thread's B row: output channel n0 + tid / 2, half tid % 2.
  const int bd = n0 + (tid >> 1), bhalf = tid & 1;

  const int chunks = (C + BK - 1) / BK;
  const int steps = 9 * chunks;
  int4 ra[2], rb;

  auto load = [&](int step) {
    const int tap = step / chunks, c0 = (step % chunks) * BK;
    const int hh = ph + tap / 3 - 1, ww = pw + tap % 3 - 1;
    const bool in = p_ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const int8_t* src = x + ((pb * H + hh) * W + ww) * C;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * h;
      ra[h] = (in && c < C) ? *reinterpret_cast<const int4*>(src + c)
                            : make_int4(0, 0, 0, 0);
    }
    const int c = c0 + 16 * bhalf;
    rb = (bd < D && c < C)
             ? *reinterpret_cast<const int4*>(
                   wk + (static_cast<long long>(tap) * D + bd) * C + c)
             : make_int4(0, 0, 0, 0);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&a_s[buf][tid * ROW]) = ra[0];
    *reinterpret_cast<int4*>(&a_s[buf][tid * ROW + 16]) = ra[1];
    *reinterpret_cast<int4*>(&b_s[buf][(tid >> 1) * ROW + 16 * bhalf]) = rb;
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);  // in flight during the products
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* r0 = &a_s[buf][(warp * 32 + mt * 16 + g) * ROW + tig * 4];
      const int8_t* r8 = r0 + 8 * ROW;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int8_t* r = &b_s[buf][(nt * 8 + g) * ROW + tig * 4];
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(r);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(r + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulator (row g or g + 8, columns 2 tig and 2 tig + 1).
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = n0 + nt * 8 + tig * 2;
    if (d >= D) continue;  // D is a multiple of 16: d + 1 < D too
    const float s0 = scale[d], s1 = scale[d + 1];
    const float b0 = bias[d], b1 = bias[d + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long q = m0 + warp * 32 + mt * 16 + g + 8 * half;
        if (q >= P) continue;
        const float2 v = make_float2(
            dequant(acc[mt][nt][2 * half], s0, b0, relu),
            dequant(acc[mt][nt][2 * half + 1], s1, b1, relu));
        *reinterpret_cast<float2*>(out + q * D + d) = v;
      }
    }
  }
}

}  // namespace

extern "C" int utconv3x3_s8(const void* x, const void* wk, const void* scale,
                            const void* bias, void* out, int B, int H, int W,
                            int C, int D, int relu, void* stream) {
  if (C % 16 || D % 16 || B < 1 || H < 1 || W < 1 || C < 1 || D < 1)
    return ERR_PLAN;
  const long long P = static_cast<long long>(B) * H * W;
  const long long blocks = (P + BM - 1) / BM;
  if (blocks >= (1LL << 31)) return ERR_PLAN;
  const dim3 grid(static_cast<unsigned>(blocks), (D + BN - 1) / BN);
  conv3x3_s8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wk),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), B, H, W, C, D, relu);
  return static_cast<int>(cudaGetLastError());
}
