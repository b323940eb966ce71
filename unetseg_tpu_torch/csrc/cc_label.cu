// 8-connected component labelling (CCL) and region-min propagation, for
// Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   unetseg_tpu/ops/cc_pallas.py::_propagate_min  (kernel _cc_kernel,
//   pallas_call at :137; entries propagate_min_pallas and cc_label_pallas).
// The contract is the same: for a (B, H, W) batch, every foreground pixel
// gets the minimum flat index (y*W + x, within its own image) of its
// 8-connected component and background gets the sentinel H*W; for general
// int32 seeds, every 8-connected region of non-sentinel cells gets the
// minimum seed over the region.
//
// The TPU kernel keeps the whole image in VMEM and runs segmented min-scans
// until nothing changes.  A 512^2 int32 image is 1 MiB, and a block on this
// card has at most 227 KB of shared memory, so that method does not carry
// over.  This is instead a union-find CCL in global memory after Playne and
// Hawick ("A New Algorithm for Parallel Connected-Component Labelling on
// GPUs", IEEE TPDS 2018): one thread per pixel, labels are pointers to flat
// indices within the image, and three passes over the batch:
//   (a) init:     L[p] = p on foreground, H*W on background;
//   (b) merge:    each foreground pixel unites with its foreground W, NW, N
//                 and NE neighbours (the four that cover every 8-neighbour
//                 edge once);
//   (c) compress: L[p] = find(p).
// propagate_min adds (c') an atomicMin of each seed into its root's slot and
// (d) a gather of that slot back to every pixel.
//
// Why the output is exact whatever order the atomics run in: a link is only
// ever made by atomicMin(&L[a], b) with b < a, so every pointer goes to a
// smaller index.  The root of each tree is therefore the smallest index in
// the tree, and when merging ends each component is one tree, so find(p) is
// the component's minimum flat index -- the labels are bit-equal to the
// plain version (ops/cc.py), which is why the tests demand bit equality.
// Region minima of seeds are an atomicMin, which is order-free too.
//
// What bounds it: a bool mask read once and the int32 labels written once
// are 5 bytes per pixel, 167.8 MB for 128 masks of 512^2 (0.050 ms at
// 3.35 TB/s).  The passes re-read and re-write labels and chase pointers
// through L2, and merge is a chain of dependent loads, so this first
// version sits well above that bound; a block-local pass in shared memory
// before the global merge is the known way down.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Labels are read through L2 only (ld.global.cg): other threads move them
// with atomics while a find walks them.
__device__ __forceinline__ int load_label(const int* L, int i) {
  return __ldcg(L + i);
}

__device__ __forceinline__ int find_root(const int* L, int base, int x) {
  int next = load_label(L, base + x);
  while (next != x) {
    x = next;
    next = load_label(L, base + x);
  }
  return x;
}

// Union of the trees of a and b: hang the larger root under the smaller.
// If the larger one was re-linked meanwhile, atomicMin returns its new
// parent; the loop then unites that parent with the smaller label.
__device__ void unite(int* L, int base, int a, int b) {
  a = find_root(L, base, a);
  b = find_root(L, base, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + base + a, b);
    a = (old == a) ? b : old;
  }
}

__global__ void init_from_mask(const uint8_t* __restrict__ fg, int* L, int n,
                               int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) L[i] = fg[i] ? i % hw : hw;
}

__global__ void init_from_seeds(const int* __restrict__ seeds, int sentinel,
                                int* L, int* out, int n, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int s = seeds[i];
    L[i] = (s != sentinel) ? i % hw : hw;
    out[i] = s;  // root slots start at their own seed; background stays
  }
}

__global__ void merge(int* L, int n, int h, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hw = h * w;
  const int base = i - i % hw;
  const int p = i - base;
  if (load_label(L, i) == hw) return;  // background never changes
  const int y = p / w, x = p - (p / w) * w;
  // Foreground is exactly "label != hw" all through the merge.
  auto fg = [&](int q) { return load_label(L, base + q) != hw; };
  if (y > 0 && fg(p - w)) {
    // N is foreground: W, NW and NE are 8-neighbours of N and reach it
    // through their own edges, so one union covers them.
    unite(L, base, p, p - w);
  } else {
    if (x > 0 && fg(p - 1)) {
      unite(L, base, p, p - 1);  // W covers NW (W's own N edge)
    } else if (x > 0 && y > 0 && fg(p - w - 1)) {
      unite(L, base, p, p - w - 1);
    }
    if (x + 1 < w && y > 0 && fg(p - w + 1)) unite(L, base, p, p - w + 1);
  }
}

// L[p] = find(p); with seeds, also atomicMin each seed into its root's slot.
__global__ void compress(int* L, const int* __restrict__ seeds, int* out,
                         int n, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int base = i - i % hw;
  if (load_label(L, i) == hw) return;
  const int root = find_root(L, base, i - base);
  L[i] = root;
  if (seeds) atomicMin(out + base + root, seeds[i]);
}

// Every region cell takes its root's minimum.  Roots only read their own
// slot, so the in-place update is race-free.
__global__ void gather_root_min(int* out, const int* __restrict__ L, int n,
                                int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = L[i];
  if (r != hw) out[i] = out[i - i % hw + r];
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// fg: (B, H, W) bytes (0 = background); labels: (B, H, W) int32 out.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int utcc_label(const uint8_t* fg, int* labels, int b, int h, int w,
                          cudaStream_t stream) {
  const int hw = h * w, n = b * hw;
  if (n == 0) return 0;
  init_from_mask<<<blocks(n), THREADS, 0, stream>>>(fg, labels, n, hw);
  merge<<<blocks(n), THREADS, 0, stream>>>(labels, n, h, w);
  compress<<<blocks(n), THREADS, 0, stream>>>(labels, nullptr, nullptr, n, hw);
  return static_cast<int>(cudaGetLastError());
}

// seeds: (B, H, W) int32; labels: (B, H, W) int32 scratch; out: (B, H, W)
// int32, each non-sentinel cell's region minimum, sentinel elsewhere.
extern "C" int utcc_propagate_min(const int* seeds, int sentinel, int* labels,
                                  int* out, int b, int h, int w,
                                  cudaStream_t stream) {
  const int hw = h * w, n = b * hw;
  if (n == 0) return 0;
  init_from_seeds<<<blocks(n), THREADS, 0, stream>>>(seeds, sentinel, labels,
                                                      out, n, hw);
  merge<<<blocks(n), THREADS, 0, stream>>>(labels, n, h, w);
  compress<<<blocks(n), THREADS, 0, stream>>>(labels, seeds, out, n, hw);
  gather_root_min<<<blocks(n), THREADS, 0, stream>>>(out, labels, n, hw);
  return static_cast<int>(cudaGetLastError());
}
