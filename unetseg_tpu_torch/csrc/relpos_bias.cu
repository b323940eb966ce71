// The expanded decomposed relative-position bias of SAM's attention, for
// Hopper: bias[r, j] = rel_h[r, j / side] + rel_w[r, j % side] over each
// row r of (batch x heads x L) queries and the L = side^2 keys, summed in
// float32 and rounded to bf16 once.
//
// Replaces no TPU kernel: the bias serves SAMed's image encoder
// (models/samed.py), a family the JAX package does not have.  The
// memory-efficient attention backend that runs the attention takes an
// additive bias as one dense (B, heads, L, L) tensor in the inputs' dtype;
// this kernel writes it from the two decomposed terms (B, heads, L, side),
// which the model computes with two small products of q and the tables.
//
// What bounds it: bytes.  One addition an element against 2 bytes written;
// the terms it reads are side / L of what it writes (1/32 over the global
// grid, 1/14 in a window) and are read again from L1.  At batch 32 a
// global block's bias is 805 MB, a windowed block's 265 MB (281 MB with
// the padded row stride): ~3.2 ms a forward at 3.35 TB/s.
//
// Design: a block takes ROWS consecutive rows; its threads first copy the
// rows' terms (2 x ROWS x side values, contiguous in both inputs) into
// shared memory as float32, then each writes 8 consecutive bf16 of one row
// with one 16-byte store, neighbouring threads on neighbouring chunks of
// the row, so each warp writes 512 contiguous bytes.  A row's stride `ld`
// is the wrapper's (a multiple of 8 elements, 16 in practice: what the
// attention backend reads without a padding copy of its own); the columns
// [L, ld) are written as zeros, so the whole allocation is defined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// Rows a block: its terms fit in 2 x ROWS x side floats of shared memory.
constexpr int ROWS = 16;
// The largest side a block's shared memory holds (8 KB of terms): a grid
// of 64, SAM's at 1024^2 inputs.
constexpr int MAX_SIDE = 64;

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

__global__ void __launch_bounds__(THREADS)
relpos_bias_kernel(const __nv_bfloat16* __restrict__ rel_h,
                   const __nv_bfloat16* __restrict__ rel_w,
                   uint4* __restrict__ out, long long rows, int side,
                   int ld) {
  __shared__ float s_h[ROWS * MAX_SIDE];
  __shared__ float s_w[ROWS * MAX_SIDE];
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int n_rows = static_cast<int>(min(static_cast<long long>(ROWS),
                                          rows - r0));
  const int terms = n_rows * side;
  const size_t base = static_cast<size_t>(r0) * side;
  for (int t = threadIdx.x; t < terms; t += THREADS) {
    s_h[t] = __bfloat162float(rel_h[base + t]);
    s_w[t] = __bfloat162float(rel_w[base + t]);
  }
  __syncthreads();
  const int L = side * side;
  const int chunks = ld >> 3;
  uint4* dst = out + static_cast<size_t>(r0) * chunks;
  for (int c = threadIdx.x; c < n_rows * chunks; c += THREADS) {
    const int row = c / chunks;
    const int j0 = (c - row * chunks) << 3;
    const float* h = s_h + row * side;
    const float* w = s_w + row * side;
    int hi = j0 / side, wi = j0 - hi * side;
    uint32_t words[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        v[u] = j0 + e + u < L ? h[hi] + w[wi] : 0.f;
        if (++wi == side) {
          wi = 0;
          ++hi;
        }
      }
      words[e >> 1] = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    }
    dst[c] = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  rel_h, rel_w: (rows, side)
// bf16, contiguous; out: (rows, ld) bf16, 16-byte aligned, ld a multiple of
// 8 and at least side^2.  Launches one kernel on `stream`; returns -1 for
// arguments it does not take, else cudaGetLastError().
extern "C" int utrelpos_bias_bf16(const void* rel_h, const void* rel_w,
                                  void* out, long long rows, int side, int ld,
                                  void* stream) {
  if (rows < 0 || side < 1 || side > MAX_SIDE || ld % 8 ||
      ld < side * side || reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  if (rows == 0) return 0;
  const long long blocks = (rows + ROWS - 1) / ROWS;
  if (blocks >= (1LL << 31)) return -1;
  relpos_bias_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rel_h),
      static_cast<const __nv_bfloat16*>(rel_w), static_cast<uint4*>(out),
      rows, side, ld);
  return static_cast<int>(cudaGetLastError());
}
