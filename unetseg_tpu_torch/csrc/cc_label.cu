// 8-connected component labelling (CCL), component areas and border touch,
// and region-min propagation, for Hopper.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   unetseg_tpu/ops/cc_pallas.py::_propagate_min  (kernel _cc_kernel,
//   pallas_call at :137; entries propagate_min_pallas and cc_label_pallas).
// The contract is the same: for a (B, H, W) batch, every foreground pixel
// gets the minimum flat index (y*W + x, within its own image) of its
// 8-connected component and background gets the sentinel H*W; for general
// int32 seeds, every 8-connected region of non-sentinel cells gets the
// minimum seed over the region.  The stats entry also returns, for each
// component, its area and whether it touches the image border, in one int32
// table slot per root (what the device mask cleanup asks of a component),
// so the cleanup needs no per-pixel scatter.
//
// The TPU kernel keeps the whole image in VMEM and runs segmented min-scans
// until nothing changes.  A 512^2 int32 image is 1 MiB and a block on this
// card has at most 227 KB of shared memory, so that method does not carry
// over.  This is a block-based union-find after Playne and Hawick (IEEE
// TPDS 2018) and Allegretti et al., in three launches over tiles of at most
// TILE_CAP pixels (TH rows by TW columns of one image, TW a power of two;
// ops/cc_kernel.tile_plan picks them, 32 x 128 at W = 512):
//   (a) local_pass, one block per tile: the tile's mask as one 32-bit mask
//       per 32-pixel row segment (two 16-byte loads a segment); each run of
//       foreground in a segment is one union-find node, on tile-local
//       indices with shared atomics, and unites with the run continuing it
//       from the left segment and with each run above it touches; then per
//       run the tile's area and border touch per local component, and the
//       labels out: a local root writes its image index, a member the
//       negative code -(local root)-1, background H*W;
//   (b) border_pass, one block per tile: the pixels of a tile's top row and
//       left column unite, in global memory, with their 8-neighbours in
//       other tiles (each edge between two tiles once);
//   (c) compress_pass, one block per tile: each local root finds its global
//       root, adds its area into the global root's slot (one atomic per tile
//       and component, not one per pixel) and ORs its touch bit there, then
//       every member takes its local root's global root from shared memory.
// propagate_min adds (d) gather_min, each cell's region minimum from its
// root's slot.
//
// Why the output is exact whatever order the atomics run in: a link is only
// ever made by atomicMin(&L[a], b) with b < a, so every pointer goes to a
// smaller index, and a tile-local row-major index orders pixels as the
// image's y*W + x does.  The root of each tree is therefore the smallest
// index in it; a local root is its component's minimum within the tile and
// the global root the component's minimum, so the labels are bit-equal to
// the plain version (ops/cc.py).  Areas are sums and touches ORs, region
// minima atomicMin: all order-free.
//
// What bounds it: a bool mask read once and the int32 labels written once
// are 5 bytes per pixel, 167.8 MB for 128 masks of 512^2 (0.050 ms at
// 3.35 TB/s).  The design moves about 13: the mask (1 B) and the labels
// (4 B) in (a), the labels read (4 B) and, on foreground, written (4 B)
// again in (c); pointer chasing stays in shared memory but for the few
// local roots per tile.  Union-find works on runs, not pixels, so the
// instructions per pixel are few: a mask bit, a run start, a label.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_W = 128;      // widest tile, columns (a power of two)
constexpr int TILE_CAP = 4096;   // pixels per tile: 16 KB of shared labels
constexpr int PER_THREAD = TILE_CAP / THREADS;
constexpr int SEGMENTS = TILE_CAP / 32;  // 32-pixel row segments per tile
constexpr int BG = -1;           // background in the shared labels
constexpr int TOUCH = INT_MIN;   // bit 31 of a stats slot: touches the border
constexpr int AREA = INT_MAX;    // bits 0-30: the area

enum Mode { LABELS = 0, STATS = 1, SEEDS = 2 };

struct Tiling {
  int h, w;        // image
  int th, tw, lg;  // tile rows, columns, log2(columns)
  int tiles_h, tiles_w;
};

struct Tile {
  int y0, x0;      // first row and column
  size_t base;     // first pixel of the image in the batch
  size_t slots;    // first stats slot of the image: b * (H*W + 1)
};

__device__ __forceinline__ Tile tile_of(const Tiling& t, int block) {
  const int tiles = t.tiles_h * t.tiles_w;
  const int b = block / tiles, r = block - b * tiles;
  const int ty = r / t.tiles_w, tx = r - ty * t.tiles_w;
  const size_t hw = static_cast<size_t>(t.h) * t.w;
  return {ty * t.th, tx * t.tw, b * hw, b * (hw + 1)};
}

// ---- shared-memory union-find (tile-local indices) -----------------------

__device__ __forceinline__ int find_s(const volatile int* lab, int x) {
  int next = lab[x];
  while (next != x) {
    x = next;
    next = lab[x];
  }
  return x;
}

// The root of x, with every node on the way pointed at it.  Only while no
// union runs: a concurrent find may read either pointer, both lead to the
// root.
__device__ __forceinline__ int find_compress_s(int* lab, int x) {
  volatile int* v = lab;
  int root = x, next;
  while ((next = v[root]) != root) root = next;
  while ((next = v[x]) != root) {
    v[x] = root;
    x = next;
  }
  return root;
}

// Union of the trees of a and b: hang the larger root under the smaller.
// If the larger one was re-linked meanwhile, atomicMin returns its new
// parent; the loop then unites that parent with the smaller label.
__device__ void unite_s(int* lab, int a, int b) {
  a = find_s(lab, a);
  b = find_s(lab, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(lab + a, b);
    a = (old == a) ? b : old;
  }
}

// ---- global union-find (image indices) ------------------------------------
// Labels are read through L2 only (ld.global.cg): other blocks move them with
// atomics while a find walks them.  Only local roots are ever linked, so a
// walk past its first step reads non-negative entries only.

__device__ __forceinline__ int find_g(const int* L, size_t base, int x) {
  int next = __ldcg(L + base + x);
  while (next != x) {
    x = next;
    next = __ldcg(L + base + x);
  }
  return x;
}

// The first step of a walk from image pixel q: a member's code names its
// local root by its index in q's tile.
__device__ __forceinline__ int parent_g(const int* L, size_t base, int q,
                                        const Tiling& t) {
  const int v = __ldcg(L + base + q);
  if (v >= 0) return v;
  const int lr = -v - 1;
  const int y = q / t.w, x = q - y * t.w;
  return (y - y % t.th + (lr >> t.lg)) * t.w + (x & ~(t.tw - 1)) +
         (lr & (t.tw - 1));
}

__device__ void unite_g(int* L, size_t base, int a, int b) {
  a = find_g(L, base, a);
  b = find_g(L, base, b);
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

// ---- (a) the tile in shared memory ----------------------------------------
// A tile row is cut into segments of WW = min(32, TW) pixels, one 32-bit
// mask each; a thread owns a segment while runs are found and united, and
// pixels one by one (i = thread + k * THREADS, coalesced) when labels go out.

__device__ __forceinline__ unsigned run_starts(unsigned m) {
  return m & ~(m << 1);
}

// The first pixel (bit) of the run of m that holds bit q.
__device__ __forceinline__ int run_start(unsigned m, int q) {
  return 31 - __clz(run_starts(m) & (0xffffffffu >> (31 - q)));
}

// Bits of 4 bytes, one per byte that is not 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned v) {
  return ((__vcmpne4(v, 0) & 0x01010101u) * 0x01020408u) >> 24;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
local_pass(const uint8_t* __restrict__ fg, const int* __restrict__ seeds,
           int sentinel, int* __restrict__ L, int* __restrict__ table,
           Tiling t) {
  __shared__ int lab[TILE_CAP];
  // STATS: area | touch per local root; SEEDS: seed minimum per local root.
  __shared__ int acc[MODE == LABELS ? 1 : TILE_CAP];
  __shared__ unsigned bits[SEGMENTS];
  const Tile tile = tile_of(t, blockIdx.x);
  const int hw = t.h * t.w;
  const int ww = min(32, t.tw), nw = t.tw / ww, nseg = t.th * nw;
  const int seg = threadIdx.x, row = seg / nw, wx = seg - row * nw;
  const int y = tile.y0 + row, xs = tile.x0 + wx * ww;  // segment origin
  const int node0 = row * t.tw + wx * ww;               // its first pixel
  const bool owner = seg < nseg;

  // Load: a segment's mask, by two 16-byte loads where the row allows.
  unsigned m = 0;
  if (owner && y < t.h && xs < t.w) {
    const size_t p = tile.base + static_cast<size_t>(y) * t.w + xs;
    if (MODE != SEEDS && ww == 32 && xs + 32 <= t.w &&
        (reinterpret_cast<uintptr_t>(fg + p) & 15) == 0) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(fg + p));
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(fg + p) + 1);
      m = nonzero_bytes(a.x) | nonzero_bytes(a.y) << 4 |
          nonzero_bytes(a.z) << 8 | nonzero_bytes(a.w) << 12 |
          nonzero_bytes(c.x) << 16 | nonzero_bytes(c.y) << 20 |
          nonzero_bytes(c.z) << 24 | nonzero_bytes(c.w) << 28;
    } else {
      const int n = min(ww, t.w - xs);
      for (int j = 0; j < n; ++j) {
        const bool on = (MODE == SEEDS) ? seeds[p + j] != sentinel
                                        : fg[p + j] != 0;
        m |= static_cast<unsigned>(on) << j;
      }
    }
  }
  if (owner) bits[seg] = m;
  // Every run's first pixel is a union-find node (a root, to begin with).
  for (unsigned r = run_starts(m); r; r &= r - 1) {
    const int node = node0 + __ffs(r) - 1;
    lab[node] = node;
    if (MODE == STATS) acc[node] = 0;
    if (MODE == SEEDS) acc[node] = INT_MAX;
  }
  __syncthreads();

  // Merge: each run unites with the run that continues it from the
  // segment on its left, and with each run of the row above that touches
  // it (bits a-1 .. b+1); a run above that continues into the segment
  // above this one is already one with it, so it is skipped.
  for (unsigned r = run_starts(m); r; r &= r - 1) {
    const int a = __ffs(r) - 1;
    const unsigned rest = ~m & (0xffffffffu << a);
    const int b = (rest ? __ffs(rest) - 1 : 32) - 1;
    const int node = node0 + a;
    if (a == 0 && wx > 0 && (bits[seg - 1] >> (ww - 1) & 1))
      unite_s(lab, node, node - ww + run_start(bits[seg - 1], ww - 1));
    if (row == 0) continue;
    const unsigned up = bits[seg - nw];
    const int lo = max(a - 1, 0), hi = min(b + 1, ww - 1);
    const unsigned hits =
        up & (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
    for (unsigned f = hits & ~(hits << 1); f; f &= f - 1)
      unite_s(lab, node, node0 - t.tw + run_start(up, __ffs(f) - 1));
    if (a == 0 && wx > 0 && !(up & 1) &&
        (bits[seg - nw - 1] >> (ww - 1) & 1))
      unite_s(lab, node, node0 - t.tw - ww +
                             run_start(bits[seg - nw - 1], ww - 1));
    if (b == ww - 1 && wx + 1 < nw && !(up >> (ww - 1) & 1) &&
        (bits[seg - nw + 1] & 1))
      unite_s(lab, node, node0 - t.tw + ww);
  }
  __syncthreads();

  // Compress (no union runs now, so a find may shorten what it walks),
  // then the stats of each run into its root.
  for (unsigned r = run_starts(m); r; r &= r - 1)
    find_compress_s(lab, node0 + __ffs(r) - 1);
  __syncthreads();
  if (MODE == STATS) {
    for (unsigned r = run_starts(m); r; r &= r - 1) {
      const int a = __ffs(r) - 1;
      const unsigned rest = ~m & (0xffffffffu << a);
      const int b = (rest ? __ffs(rest) - 1 : 32) - 1;
      const int root = lab[node0 + a];
      atomicAdd(acc + root, b - a + 1);
      if (y == 0 || y == t.h - 1 || xs + a == 0 || xs + b == t.w - 1)
        atomicOr(acc + root, TOUCH);
    }
  }
  // Per pixel from here: TW <= THREADS, so a thread keeps one column of the
  // tile and its pixels lie THREADS / TW rows apart.
  const int col = threadIdx.x & (t.tw - 1), j = col & (ww - 1);
  const int cseg = col / ww, rstep = THREADS >> t.lg, px = tile.x0 + col;
  const int r_end = min(t.th, t.h - tile.y0);
  const unsigned upto = 0xffffffffu >> (31 - j);
  if (MODE == SEEDS && px < t.w) {
    for (int r = threadIdx.x >> t.lg; r < r_end; r += rstep) {
      const unsigned mi = bits[r * nw + cseg];
      if (!(mi >> j & 1)) continue;
      const int i = r * t.tw + col;
      atomicMin(acc + lab[i - j + 31 - __clz(run_starts(mi) & upto)],
                seeds[tile.base + static_cast<size_t>(tile.y0 + r) * t.w +
                      px]);
    }
  }
  if (MODE != LABELS) __syncthreads();

  // Labels out: a local root its image index, a member the code of its
  // local root, background H*W.
  if (px < t.w) {
    for (int r = threadIdx.x >> t.lg; r < r_end; r += rstep) {
      const unsigned mi = bits[r * nw + cseg];
      const int i = r * t.tw + col, q = (tile.y0 + r) * t.w + px;
      int out = hw;
      if (mi >> j & 1) {
        const int root = lab[i - j + 31 - __clz(run_starts(mi) & upto)];
        out = -root - 1;
        if (root == i) {
          out = q;
          if (MODE == STATS) table[tile.slots + q] = acc[i];
          if (MODE == SEEDS) table[tile.base + q] = acc[i];
        }
      }
      L[tile.base + q] = out;
    }
  }
  // The background slot is gathered too (and masked off): keep it defined.
  if (MODE == STATS && tile.y0 == 0 && tile.x0 == 0 && threadIdx.x == 0)
    table[tile.slots + hw] = 0;
}

// ---- (b) edges between tiles -----------------------------------------------

__global__ void __launch_bounds__(THREADS)
border_pass(int* L, Tiling t) {
  const Tile tile = tile_of(t, blockIdx.x);
  const int hw = t.h * t.w;
  const int y_end = min(tile.y0 + t.th, t.h);
  for (int k = threadIdx.x; k < t.tw + t.th; k += THREADS) {
    const bool top = k < t.tw;
    const int y = top ? tile.y0 : tile.y0 + (k - t.tw);
    const int x = top ? tile.x0 + k : tile.x0;
    if ((top ? tile.y0 == 0 : tile.x0 == 0) || y >= t.h || x >= t.w) continue;
    const int p = y * t.w + x;
    if (__ldcg(L + tile.base + p) == hw) continue;
    const int a = parent_g(L, tile.base, p, t);
    auto link = [&](int q) {
      if (__ldcg(L + tile.base + q) != hw)
        unite_g(L, tile.base, a, parent_g(L, tile.base, q, t));
    };
    if (top) {  // N, NW and NE lie in the tile row above
      link(p - t.w);
      if (x > 0) link(p - t.w - 1);
      if (x + 1 < t.w) link(p - t.w + 1);
    } else {    // W, and NW and SW inside this tile row, lie in the tile left
      link(p - 1);
      if (y > tile.y0) link(p - t.w - 1);
      if (y + 1 < y_end) link(p + t.w - 1);
    }
  }
}

// ---- (c) global roots, stats, final labels ---------------------------------

template <int MODE>
__global__ void __launch_bounds__(THREADS)
compress_pass(int* L, int* table, Tiling t) {
  __shared__ int groot[TILE_CAP];
  const Tile tile = tile_of(t, blockIdx.x);
  const int hw = t.h * t.w;
  // A thread keeps one column of the tile, as in the local pass.
  const int col = threadIdx.x & (t.tw - 1), r0 = threadIdx.x >> t.lg;
  const int rstep = THREADS >> t.lg, px = tile.x0 + col;
  const int r_end = px < t.w ? min(t.th, t.h - tile.y0) : 0;
  int label[PER_THREAD];

#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int r = r0 + k * rstep;
    label[k] = r < r_end ? __ldcg(L + tile.base + (tile.y0 + r) * t.w + px)
                         : hw;
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int v = label[k];
    if (v < 0 || v == hw) continue;
    // A local root: v is its parent after (b).
    const int r = r0 + k * rstep;
    const int q = (tile.y0 + r) * t.w + px;
    const int g = find_g(L, tile.base, v);
    groot[r * t.tw + col] = g;
    if (g == q) continue;
    L[tile.base + q] = g;  // path compression: g is still an ancestor
    if (MODE == STATS) {
      const int s = table[tile.slots + q];
      atomicAdd(table + tile.slots + g, s & AREA);
      if (s & TOUCH) atomicOr(table + tile.slots + g, TOUCH);
    }
    if (MODE == SEEDS) atomicMin(table + tile.base + g, table[tile.base + q]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    if (label[k] >= 0) continue;
    L[tile.base + (tile.y0 + r0 + k * rstep) * t.w + px] =
        groot[-label[k] - 1];
  }
}

// ---- (d) region minima back to every cell -----------------------------------

// Every region cell takes its root's minimum.  Roots only read their own
// slot, so the in-place update is race-free.
__global__ void gather_min(int* out, const int* __restrict__ L, int sentinel,
                           int n, int hw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = L[i];
  out[i] = (r == hw) ? sentinel : out[i - i % hw + r];
}

bool plan_ok(int b, int h, int w, int th, int tw, Tiling* t) {
  if (b < 1 || h < 1 || w < 1 || th < 1 || tw < 1 || tw > TILE_W ||
      (tw & (tw - 1)) || th > TILE_CAP / (tw < 32 ? 32 : tw) ||
      static_cast<long long>(b) * h * w >= INT_MAX)
    return false;
  int lg = 0;
  while ((1 << lg) < tw) ++lg;
  *t = {h, w, th, tw, lg, (h + th - 1) / th, (w + tw - 1) / tw};
  return static_cast<long long>(b) * t->tiles_h * t->tiles_w < INT_MAX;
}

template <int MODE>
int run(const uint8_t* fg, const int* seeds, int sentinel, int* L,
        int* table, int b, const Tiling& t, cudaStream_t stream) {
  const int grid = b * t.tiles_h * t.tiles_w;
  local_pass<MODE><<<grid, THREADS, 0, stream>>>(fg, seeds, sentinel, L,
                                                 table, t);
  if (t.tiles_h * t.tiles_w > 1)
    border_pass<<<grid, THREADS, 0, stream>>>(L, t);
  compress_pass<MODE><<<grid, THREADS, 0, stream>>>(L, table, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fg: (B, H, W) bytes (0 = background); labels: (B, H, W) int32 out; stats:
// B * (H*W + 1) int32 out or null.  Image b's root r has slot
// b * (H*W + 1) + r: its area in bits 0-30, bit 31 set when it touches the
// image border; slot b * (H*W + 1) + H*W is 0; other slots are not written.
// th x tw is the tile (ops/cc_kernel.tile_plan).  Returns -1 for a tile the
// kernel does not take, else cudaGetLastError() after the launches.
extern "C" int utcc_label(const uint8_t* fg, int* labels, int* stats, int b,
                          int h, int w, int th, int tw, cudaStream_t stream) {
  Tiling t;
  if (!plan_ok(b, h, w, th, tw, &t)) return -1;
  return stats ? run<STATS>(fg, nullptr, 0, labels, stats, b, t, stream)
               : run<LABELS>(fg, nullptr, 0, labels, nullptr, b, t, stream);
}

// seeds: (B, H, W) int32; labels: (B, H, W) int32 scratch; out: (B, H, W)
// int32, each non-sentinel cell's region minimum, sentinel elsewhere.
extern "C" int utcc_propagate_min(const int* seeds, int sentinel, int* labels,
                                  int* out, int b, int h, int w, int th,
                                  int tw, cudaStream_t stream) {
  Tiling t;
  if (!plan_ok(b, h, w, th, tw, &t)) return -1;
  const int err = run<SEEDS>(nullptr, seeds, sentinel, labels, out, b, t,
                             stream);
  if (err) return err;
  const int hw = h * w, n = b * hw;
  gather_min<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      out, labels, sentinel, n, hw);
  return static_cast<int>(cudaGetLastError());
}
