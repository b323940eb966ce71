// GroupNorm over NHWC bf16 activations, with an optional residual add and
// ReLU fused into the output pass, for Hopper (K9 of the port's kernels).
//
// Replaces no TPU kernel: GroupNorm serves TransUNet's ResNet-50 backbone
// (models/transunet.py), a family the JAX package does not have.  It takes
// the place of PyTorch's own ops on that path: two float32 reductions (the
// sum and the 2-norm), an `addcmul`, an in-place ReLU and, after each
// unit's last norm, a residual add and another ReLU: six to nine passes
// over the tensor.
//
// What bounds it: bytes.  y = x * scale + shift per (image, channel), with
// scale and shift from each (image, group)'s mean and variance; a few
// float operations an element against 2 bytes read and 2 written.  The
// statistics must be complete before the first output, so the tensor is
// read twice: the floor is two reads and one write (plus the residual's
// read), 3.4 + 0.6 ms a TransUNet forward at batch 32 on 3.35 TB/s.
//
// Design, three launches on one stream, no atomics, every sum in a fixed
// order (a graph replay is bit-equal to the eager call):
//   1. statistics: a block takes a chunk of P contiguous pixels of one
//      image, all C channels, with 16-byte loads (a thread keeps one
//      8-channel column, so loads are coalesced at any channels a group).
//      Each thread runs Welford's update over its pixels for its 8
//      channels; the block merges rows into channels and channels into
//      groups by Chan's formula (count, mean, M2) and writes one (mean, M2)
//      a (chunk, group).
//   2. finalize: a warp a (image, group) merges the chunks' partials (lanes
//      over chunks, then a shuffle tree read at lane 0) and writes the
//      float32 scale w / sqrt(var + eps) and shift b - mean * scale of each
//      of the group's channels.  A kernel of its own, so that the output
//      pass reads 2 C floats an image, not every chunk's partials (with one
//      channel a group, as in the projection's norm, those are K x C).
//   3. apply: y = x * scale + shift, relu(y) or relu(y + residual) where
//      asked (a residual only with the ReLU), in float32, rounded to bf16
//      once, 16-byte stores.  Its blocks walk the images in the
//      reverse of the statistics' order, so the chunks read last, still in
//      the 50 MB L2, are read again first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// Loads in flight a thread (each 16 bytes).
constexpr int UNROLL = 4;
// Channels a block can hold: one 8-channel column a thread.
constexpr int MAX_C = THREADS * 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// (n, mean, m2) <- the union of itself and (nb, mean_b, m2_b), Chan et al.
__device__ __forceinline__ void merge(float& n, float& mean, float& m2,
                                      float nb, float mean_b, float m2_b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mean_b;
    m2 = m2_b;
    return;
  }
  const float total = n + nb;
  const float d = mean_b - mean;
  const float f = nb / total;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2_b + d * d * n * f;
  n = total;
}

// Grid: N * K blocks, image-major.  Block (n, k) reads pixels [k P,
// min((k + 1) P, HW)) of image n and writes partial[(n K + k) G + g] =
// (mean, M2) of each group g over them.
__global__ void __launch_bounds__(THREADS)
groupnorm_nhwc_stats_kernel(const uint4* __restrict__ x,
                            float2* __restrict__ partial, int HW, int C,
                            int G, int P, int K) {
  __shared__ __align__(16) float s_mean[MAX_C];
  __shared__ __align__(16) float s_m2[MAX_C];
  // per channel, one pad word every 32: the group pass reads without
  // bank conflicts at any channels a group
  __shared__ float c_mean[MAX_C + MAX_C / 32];
  __shared__ float c_m2[MAX_C + MAX_C / 32];
  __shared__ float s_n[THREADS];
  const int cols = C >> 3, rows = THREADS / cols;
  const int n = blockIdx.x / K, k = blockIdx.x - n * K;
  const int t = threadIdx.x, row = t / cols, col = t - row * cols;
  const int p_begin = k * P, p_end = min(p_begin + P, HW);
  if (row < rows) {
    float mean[8], m2[8], cnt = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) mean[c] = m2[c] = 0.f;
    const uint4* src = x + static_cast<size_t>(n) * HW * cols + col;
    for (int p = p_begin + row; p < p_end; p += rows * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = p + u * rows;
        v[u] = q < p_end ? src[static_cast<size_t>(q) * cols]
                         : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p + u * rows < p_end) {
          cnt += 1.f;
          const float inv = 1.f / cnt;
          float f[8];
          unpack(v[u], f);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float d = f[c] - mean[c];
            mean[c] = fmaf(d, inv, mean[c]);
            m2[c] = fmaf(d, f[c] - mean[c], m2[c]);
          }
        }
      }
    }
    float4* sm = reinterpret_cast<float4*>(s_mean + row * C + col * 8);
    float4* sq = reinterpret_cast<float4*>(s_m2 + row * C + col * 8);
    sm[0] = make_float4(mean[0], mean[1], mean[2], mean[3]);
    sm[1] = make_float4(mean[4], mean[5], mean[6], mean[7]);
    sq[0] = make_float4(m2[0], m2[1], m2[2], m2[3]);
    sq[1] = make_float4(m2[4], m2[5], m2[6], m2[7]);
    if (col == 0) s_n[row] = cnt;
  }
  __syncthreads();
  // each channel over the block's rows, in row order
  for (int ch = t; ch < C; ch += THREADS) {
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int r = 0; r < rows; ++r)
      merge(cn, cm, cq, s_n[r], s_mean[r * C + ch], s_m2[r * C + ch]);
    c_mean[ch + (ch >> 5)] = cm;
    c_m2[ch + (ch >> 5)] = cq;
  }
  __syncthreads();
  // each group over its channels, in channel order; every channel counts
  // the chunk's pixels
  const float n_chunk = static_cast<float>(p_end - p_begin);
  const int cpg = C / G;
  for (int g = t; g < G; g += THREADS) {
    float gn = 0.f, gm = 0.f, gq = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c)
      merge(gn, gm, gq, n_chunk, c_mean[c + (c >> 5)], c_m2[c + (c >> 5)]);
    partial[(static_cast<size_t>(n) * K + k) * G + g] = make_float2(gm, gq);
  }
}

// Grid: (ceil(G / 8), N) blocks of 8 warps, a warp an (image, group).
__global__ void __launch_bounds__(THREADS)
groupnorm_nhwc_finalize_kernel(const float2* __restrict__ partial,
                               const __nv_bfloat16* __restrict__ weight,
                               const __nv_bfloat16* __restrict__ bias,
                               float* __restrict__ scale,
                               float* __restrict__ shift, int HW, int C,
                               int G, int P, int K, float eps) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int n = blockIdx.y;
  if (g >= G) return;  // a whole warp
  const int cpg = C / G;
  float cn = 0.f, cm = 0.f, cq = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float2 s = partial[(static_cast<size_t>(n) * K + k) * G + g];
    const int pixels = min((k + 1) * P, HW) - k * P;
    merge(cn, cm, cq, static_cast<float>(pixels) * cpg, s.x, s.y);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float on = __shfl_down_sync(FULL, cn, off);
    const float om = __shfl_down_sync(FULL, cm, off);
    const float oq = __shfl_down_sync(FULL, cq, off);
    if (lane < off) merge(cn, cm, cq, on, om, oq);
  }
  const float mean = __shfl_sync(FULL, cm, 0);
  const float var = __shfl_sync(FULL, cq, 0) / __shfl_sync(FULL, cn, 0);
  const float rstd = 1.f / sqrtf(var + eps);
  for (int c = lane; c < cpg; c += 32) {
    const int ch = g * cpg + c;
    const float s = __bfloat162float(weight[ch]) * rstd;
    scale[static_cast<size_t>(n) * C + ch] = s;
    shift[static_cast<size_t>(n) * C + ch] =
        fmaf(-mean, s, __bfloat162float(bias[ch]));
  }
}

// Grid: N * K blocks, the statistics' chunks in reverse order.  RESIDUAL
// only with RELU.
template <bool RELU, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
groupnorm_nhwc_apply_kernel(const uint4* __restrict__ x,
                            const uint4* __restrict__ residual,
                            const float* __restrict__ scale,
                            const float* __restrict__ shift,
                            uint4* __restrict__ out, int N, int HW, int C,
                            int P, int K) {
  const int cols = C >> 3, rows = THREADS / cols;
  const int t = threadIdx.x, row = t / cols, col = t - row * cols;
  if (row >= rows) return;
  const int b = N * K - 1 - static_cast<int>(blockIdx.x);
  const int n = b / K, k = b - n * K;
  const float4* sc =
      reinterpret_cast<const float4*>(scale + static_cast<size_t>(n) * C) +
      col * 2;
  const float4* sh =
      reinterpret_cast<const float4*>(shift + static_cast<size_t>(n) * C) +
      col * 2;
  const float4 s0 = sc[0], s1 = sc[1], h0 = sh[0], h1 = sh[1];
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const int p_end = min(k * P + P, HW);
  const size_t base = static_cast<size_t>(n) * HW * cols + col;
  for (int p = k * P + row; p < p_end; p += rows * UNROLL) {
    uint4 v[UNROLL], r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * rows;
      if (q < p_end) {
        const size_t i = base + static_cast<size_t>(q) * cols;
        v[u] = __ldcs(x + i);
        if (RESIDUAL) r[u] = __ldcs(residual + i);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int q = p + u * rows;
      if (q < p_end) {
        float f[8], rf[8];
        unpack(v[u], f);
        if (RESIDUAL) unpack(r[u], rf);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float y = fmaf(f[c], s[c], h[c]);
          if (RESIDUAL) y += rf[c];
          if (RELU) y = fmaxf(y, 0.f);
          f[c] = y;
        }
        out[base + static_cast<size_t>(q) * cols] = pack(f);
      }
    }
  }
}

template <bool RELU, bool RESIDUAL>
void apply(dim3 grid, cudaStream_t stream, const void* x, const void* residual,
           const float* scale, const float* shift, void* out, int N, int HW,
           int C, int P, int K) {
  groupnorm_nhwc_apply_kernel<RELU, RESIDUAL><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(residual),
      scale, shift, static_cast<uint4*>(out), N, HW, C, P, K);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x, residual (or null) and out:
// (N, HW, C) bf16, contiguous, 16-byte aligned; weight, bias: (C,) bf16;
// scratch: 2 N C + 2 N K G floats, 16-byte aligned (the scale, the shift,
// then the partials).  C a multiple of 8 and at most 2048, G dividing C,
// P pixels a chunk, K = ceil(HW / P) chunks an image (the wrapper's plan).
// A residual is taken only with relu (a bottleneck's last norm).
// Launches the three kernels on `stream`; returns -1 for arguments it
// does not take, else cudaGetLastError().
extern "C" int utgroupnorm_nhwc_bf16(const void* x, const void* weight,
                                     const void* bias, const void* residual,
                                     void* out, void* scratch, int N, int HW,
                                     int C, int G, int P, int K, float eps,
                                     int relu, void* stream) {
  if (C < 8 || C % 8 || C > MAX_C || G < 1 || C % G || P < 1 ||
      K != (HW + P - 1) / P || N < 0 || HW < 0 || (residual && !relu))
    return -1;
  if (N == 0 || HW == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scale = static_cast<float*>(scratch);
  float* shift = scale + static_cast<size_t>(N) * C;
  float2* partial = reinterpret_cast<float2*>(shift + static_cast<size_t>(N) * C);
  const dim3 grid(static_cast<unsigned>(N) * K);
  groupnorm_nhwc_stats_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint4*>(x), partial, HW, C, G, P, K);
  groupnorm_nhwc_finalize_kernel<<<dim3((G + THREADS / 32 - 1) / (THREADS / 32),
                                        N),
                                   THREADS, 0, s>>>(
      partial, static_cast<const __nv_bfloat16*>(weight),
      static_cast<const __nv_bfloat16*>(bias), scale, shift, HW, C, G, P, K,
      eps);
  if (residual)
    apply<true, true>(grid, s, x, residual, scale, shift, out, N, HW, C, P, K);
  else if (relu)
    apply<true, false>(grid, s, x, residual, scale, shift, out, N, HW, C, P, K);
  else
    apply<false, false>(grid, s, x, residual, scale, shift, out, N, HW, C, P,
                        K);
  return static_cast<int>(cudaGetLastError());
}
