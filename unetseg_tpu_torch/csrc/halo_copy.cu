// Halo-band copy out[b, i, j, :] = x[b, row_offset + i, j, :] for i < H,
// j < W2, on bf16 NHWC, for Hopper.
//
// Replaces the two Pallas TPU copy kernels of the JAX bandwidth probe
//   benchmarks/exp_bw.py::copy_elem     (pallas_call :49), row_offset = 1:
//     x[:, 1:H+1, :W2, :] through Element blocks with a halo row band;
//   benchmarks/exp_bw.py::copy_blocked  (pallas_call :74), row_offset = 0:
//     x[:, 0:H, :W2, :] through Blocked tiles.
// On the TPU the two differ in how the block specs cut the input; here both
// are the same strided copy, and the row offset is an argument.
//
// What bounds it: bytes.  At (32, 514, 257, 128) -> (32, 512, 256, 128) it
// reads and writes 1.074 GB each, 0.641 ms at 3.35 TB/s, with no
// arithmetic.  Each output row (W2 pixels x K channels, contiguous in both
// tensors) is a run of 16-byte vectors: one block copies one output row
// with 16-byte loads and stores, neighbouring threads on neighbouring
// addresses, so every access is coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
halo_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                 int H, int W2, int Hin, int Win, int K, int row_offset) {
  const long long row = blockIdx.x;  // output row b * H + i
  const long long b = row / H;
  const int i = static_cast<int>(row - b * H);
  const int vecs = W2 * K / 8;       // 16-byte vectors in one output row
  const uint4* src = x + ((b * Hin + i + row_offset) * Win) * K / 8;
  uint4* dst = out + row * vecs;
  for (int v = threadIdx.x; v < vecs; v += THREADS) dst[v] = __ldcs(src + v);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x: (B, Hin, Win, K) bf16,
// out: (B, H, W2, K) bf16, both contiguous and 16-byte aligned, K a
// multiple of 8, row_offset + H <= Hin, W2 <= Win (checked by the Python
// wrapper).  Launches on `stream`; returns cudaGetLastError().
extern "C" int uthalo_copy_bf16(const void* x, void* out, int B, int H,
                                int W2, int Hin, int Win, int K,
                                int row_offset, void* stream) {
  const long long rows = static_cast<long long>(B) * H;
  if (rows <= 0) return 0;
  halo_copy_kernel<<<static_cast<unsigned>(rows), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), H, W2, Hin, Win,
      K, row_offset);
  return static_cast<int>(cudaGetLastError());
}
