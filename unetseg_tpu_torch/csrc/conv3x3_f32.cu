// 3x3 stride-1 SAME convolution + bias (+ ReLU) in float32, NHWC x HWIO ->
// NHWC, for Hopper.
//
// K8 of the port: the float32 instance of the Pallas kernels
// unetseg_tpu/ops/pallas_conv.py::conv3x3_bias_act (:150-224, C >= 128) and
// _conv3x3_small_c (:123, C < 128), which take any float dtype and sum in
// float32.  The bf16 instance is csrc/conv3x3.cu (K1/K2); this one serves
// every float32 model and the float32 data gradient of training.
//
//   out[p, d] = relu(sum_{tap, c} x[p + tap, c] * w[tap, c, d] + b[d])
//
// The rule is float32 accuracy: TF32 (10 mantissa bits) is ruled out, so
// the products are IEEE float32 FMAs on the CUDA cores (SIMT), not tensor
// core products.  Each output sums its K = 9*C products in two levels: the
// C products of one tap into a partial, then the nine partials into the
// total, so its rounding error grows with C + 9, not 9*C.
//
// GEMM view: M = output pixels (B*H*W, flattened), N = D output channels,
// K = 9*C in the order (tap, channel), tap = dy*3 + dx; the HWIO weights
// are that (9*C, D) matrix, row-major.
//
// Design (a simple kernel that is right; making it fast is later work):
//   * a block of 256 threads computes 128 pixels x 64 channels; each thread
//     8 pixels (two runs of 4, 64 apart) x 4 channels;
//   * a K step is one tap and 16 channels: each thread loads 8 channels of
//     one pixel (zero outside the image: the SAME padding) and 4 of one
//     weight row into registers while the block computes the previous step,
//     then stores them into the other of two shared buffers (A transposed:
//     k-major rows of 128 pixels, so a thread reads its 4 + 4 pixels as two
//     float4);
//   * C and D are multiples of 16 (the wrapper zero-pads them), so a step
//     is never partial; ragged M and D are masked.
// What bounds it on the H100: float32 operations outside the tensor cores
// (67 TFLOP/s); this kernel reaches a fraction of that.  A split-TF32
// (3xTF32) tensor-core kernel is the phase-2 path.
//
// Entry point: utconv3x3_f32(x, w, b, out, B, H, W, C, D, relu, stream)
// -> 0, or -1 if C or D is not a multiple of 16 or the grid is too large,
// or the CUDA error of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // channels per K step (one tap)
constexpr int THREADS = 256;
constexpr int APAD = 4;       // floats of pad per A row (keeps float4 reads aligned)
constexpr int ERR_PLAN = -1;

__global__ void __launch_bounds__(THREADS, 2)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int B, int H, int W, int C, int D, int relu) {
  __shared__ __align__(16) float a_s[2][BK][BM + APAD];
  __shared__ __align__(16) float b_s[2][BK][BN];

  const int tid = threadIdx.x;
  const long long HW = static_cast<long long>(H) * W;
  const long long M = HW * B;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: pixel a_m of the tile, channels a_c .. a_c + 7 of the step.
  const int a_m = tid & (BM - 1), a_c = (tid >> 7) * 8;
  const long long pm = m0 + a_m;
  const bool a_in = pm < M;
  long long pb = 0;
  int py = 0, px = 0;
  if (a_in) {
    pb = pm / HW;
    const long long r = pm - pb * HW;
    py = static_cast<int>(r / W);
    px = static_cast<int>(r - static_cast<long long>(py) * W);
  }
  // B loader: row b_k of the step, columns b_n .. b_n + 3.
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;
  const bool b_in = n0 + b_n < D;  // D is a multiple of 16: all 4 in or out

  const int chunks = C / BK;
  const int steps = 9 * chunks;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_reg[2], b_reg;

  auto load = [&](int step) {
    const int tap = step / chunks;
    const int c0 = (step - tap * chunks) * BK;
    const int yy = py + tap / 3 - 1, xx = px + tap % 3 - 1;
    if (a_in && yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float4* src = reinterpret_cast<const float4*>(
          x + ((pb * H + yy) * W + xx) * C + c0 + a_c);
      a_reg[0] = __ldg(src);
      a_reg[1] = __ldg(src + 1);
    } else {
      a_reg[0] = a_reg[1] = zero;
    }
    b_reg = b_in ? __ldg(reinterpret_cast<const float4*>(
                       w + static_cast<long long>(step * BK + b_k) * D + n0 +
                       b_n))
                 : zero;
  };
  auto store = [&](int buf) {
    const float* a = reinterpret_cast<const float*>(a_reg);
#pragma unroll
    for (int i = 0; i < 8; ++i) a_s[buf][a_c + i][a_m] = a[i];
    *reinterpret_cast<float4*>(&b_s[buf][b_k][b_n]) = b_reg;
  };

  // Compute: pixels tm*4 .. +3 and 64 + tm*4 .. +3, channels tn*4 .. +3.
  const int tm = tid & 15, tn = tid >> 4;
  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][64 + tm * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[buf][k][tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bw[j], part[i][j]);
    }
    if ((step + 1) % chunks == 0) {  // the tap is complete
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
    if (step + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  const int n = n0 + tn * 4;
  if (n >= D) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + n);
  const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
    if (m >= M) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] + bw[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
    }
    *reinterpret_cast<float4*>(out + m * D + n) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

extern "C" int utconv3x3_f32(const void* x, const void* w, const void* b,
                             void* out, int B, int H, int W, int C, int D,
                             int relu, void* stream) {
  if (C % BK || D % 16 || B < 1 || H < 1 || W < 1 || C < 1 || D < 1)
    return ERR_PLAN;
  const long long M = static_cast<long long>(B) * H * W;
  const long long blocks = (M + BM - 1) / BM;
  if (blocks >= (1LL << 31)) return ERR_PLAN;
  const dim3 grid(static_cast<unsigned>(blocks), (D + BN - 1) / BN);
  conv3x3_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), B, H, W, C, D,
      relu);
  return static_cast<int>(cudaGetLastError());
}
