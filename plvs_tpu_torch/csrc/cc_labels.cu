// Connected-component minimum labels over an 8-connected cell grid.
//
// Replaces the TPU kernel plvs_tpu/ops/cc_labels.py::cc_min_labels
// (_make_kernel: the whole grid resident in VMEM, 6 fixed chunks of 8
// one-cell Jacobi sweeps + 4 shift-doubling segmented min-scans, no early
// exit). Contract: out[p] = min of init over p's connected component, where
// bit ci of conn[p] links p to its neighbour at (y - SY[ci], x - SX[ci])
// (cyclic, as jnp.roll/pltpu.roll wrap) with (SY, SX) the SHIFTS order
// (1,0) (-1,0) (0,1) (0,-1) (1,1) (-1,-1) (1,-1) (-1,1). Links are taken as
// undirected; the line detector's links are symmetric by construction.
//
// What bounds it on an H100: neither bytes nor operations. At 640x480 the
// half-resolution grid is 240 x 320 = 76,800 cells; the function reads init
// and conn and writes out (12 B/cell, ~0.92 MB, ~0.3 us at 3.35 TB/s). The
// first design (four launches: init, Playne-Hawick atomicMin union in global
// memory, compress, gather) took 0.565 ms of device time on a rendered
// frame, 0.540 ms of it in the union pass: union-find chains walked hop by
// hop through L2 with no path compression. What bounds this design is the
// latency of the dependent shared-memory loads and atomics of the union
// loops, which diverge across a warp's lanes, on the cluster's 8 SMs; so it
// unites along as few links as it can (run heads by ballot, links that
// others carry skipped) and keeps the trees shallow (random linking).
//
// This design keeps the whole grid's union-find state on chip, in the
// distributed shared memory of one thread-block cluster of 8 blocks, and
// runs in one launch. Cell g (row-major) belongs to block g / chunk, chunk =
// ceil(H*W / 8); each block holds parent[] and rootmin[] for its cells, 8 B
// a cell, so a cluster holds up to 8 * 227 KB / 8 B = 232,448 cells (every
// camera the repo configures: 360 x 640 = 230,400 at 1280x720).
//   (a) point each cell at the head of its run of left-linked cells within
//       its warp's 32 cells (a ballot), and stage the block's link bits as
//       bytes in shared memory;
//   (b) unite along every link whose two ends the block owns and that no
//       other link carries (carried() below), in the block's own shared
//       memory: atomicCAS hooking of one root under the
//       other by a hashed priority of the cell index (random linking: trees
//       stay O(log n) deep, where hooking by index chains a straight edge
//       cell by cell), path halving in find;
//   (b') point every cell at its block-local root and fold init into that
//       root's rootmin (one atomic per warp where the warp shares a root,
//       as in a filled region);
//   (c) cluster.sync(); unite along the links that cross blocks (the
//       cyclic wraps included; only cells within 2W of the block's run or in
//       the first or last row can have one), on the remote blocks' arrays
//       through cluster.map_shared_rank;
//   (d) cluster.sync(); each block-local root folds its minimum into its
//       final root (one remote atomic per merged block-local component, not
//       one per cell); cluster.sync(); and takes the final minimum back;
//   (e) cluster.sync(); out[g] = rootmin[parent[g]], parent[g] being a
//       block-local root; a last cluster.sync() keeps every block's shared
//       memory alive until all remote reads end.
// The result is the true fixpoint for any component shape (the TPU
// kernel's fixed chunk count can split long diagonal components). No
// device scratch.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;
constexpr int THREADS = 1024;
constexpr int MAX_SMEM = 232448;  // 227 KB: an H100 block's dynamic limit

// Slot of cell g in the block's own array (phase b: both ends local).
struct LocalSlot {
  int* arr;
  int base;
  __device__ int* operator()(int g) const { return arr + (g - base); }
};

// Slot of cell g in its owner block's array, anywhere in the cluster (the
// block's own cells without the cluster mapping).
struct ClusterSlot {
  int* arr;
  int base, count, chunk;
  __device__ int* operator()(int g) const {
    if (static_cast<unsigned>(g - base) < static_cast<unsigned>(count))
      return arr + (g - base);
    const int owner = g / chunk;
    return cg::this_cluster().map_shared_rank(arr, owner) + (g - owner * chunk);
  }
};

template <class Slot>
__device__ __forceinline__ int load(Slot s, int g) {
  return *static_cast<volatile int*>(s(g));
}

// Linking priority: a bijective hash of the cell index. Hooking the root of
// larger priority under the other keeps trees O(log n) deep in expectation
// whatever order the links come in; hooking by index would chain a straight
// edge cell by cell.
__device__ __forceinline__ unsigned priority(int g) {
  unsigned x = static_cast<unsigned>(g) * 0x9E3779B1u;
  return x ^ (x >> 16);
}

// Root of x, halving the path on the way. Only roots are ever hooked, and
// a halving step only stores an ancestor into a non-root, so it races with
// nothing that could lose a link.
template <class Slot>
__device__ int find_root(Slot s, int x) {
  int p = load(s, x);
  while (p != x) {
    const int gp = load(s, p);
    if (gp == p) return p;
    *static_cast<volatile int*>(s(x)) = gp;
    x = gp;
    p = load(s, x);
  }
  return x;
}

// Root of x without writing (for phases where nothing links any more).
template <class Slot>
__device__ int find_root_ro(Slot s, int x) {
  int p = load(s, x);
  while (p != x) {
    x = p;
    p = load(s, x);
  }
  return x;
}

template <class Slot>
__device__ void unite(Slot s, int a, int b) {
  while (true) {
    a = find_root(s, a);
    b = find_root(s, b);
    if (a == b) return;
    if (priority(a) > priority(b)) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(s(b), b, a) == b) return;  // hook b if still a root
  }
}

// Cell index of (y - SY[ci], x - SX[ci]), wrapping cyclically; (SY, SX)
// in registers, since lanes of a warp ask for different ci.
__device__ __forceinline__ int neighbour(int y, int x, int ci, int h, int w) {
  const int k = ci >> 1;  // (1,0) (0,1) (1,1) (1,-1), negated for odd ci
  int sy = k == 1 ? 0 : 1;
  int sx = k == 0 ? 0 : (k == 3 ? -1 : 1);
  if (ci & 1) {
    sy = -sy;
    sx = -sx;
  }
  int ny = y - sy, nx = x - sx;
  ny = ny < 0 ? ny + h : (ny >= h ? ny - h : ny);
  nx = nx < 0 ? nx + w : (nx >= w ? nx - w : nx);
  return ny * w + nx;
}

// Whether link ci of cell g = (y, x) is carried by other links, so that
// uniting along it adds nothing (bits: g's link bits, q: the link's other
// end, links(c): cell c's link bits):
//  * a downward or rightward link (odd ci) whose reverse q sets: q unites it;
//  * an upward link (ci 0, 4, 6) of a cell linked to its left neighbour
//    (not across the wrap), whose left neighbour has the same link to q's
//    left neighbour, which q is linked to: the leftmost cell of the row
//    run unites it. In a filled region that leaves one upward union per
//    run instead of three per cell.
template <class Links>
__device__ __forceinline__ bool carried(Links links, int q, int ci, int bits,
                                        int y, int x, int w) {
  if (ci & 1) return (links(q) >> (ci ^ 1)) & 1;
  if (ci == 2 || x == 0 || !((bits >> 2) & 1) || !((links(q) >> 2) & 1))
    return false;
  return (links(y * w + x - 1) >> ci) & 1;
}

__global__ void __launch_bounds__(THREADS, 1)
cc_cluster_kernel(const int* __restrict__ init, const int* __restrict__ conn,
                  int* __restrict__ out, int h, int w, int chunk) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = h * w;
  const int base = rank * chunk;
  const int count = max(0, min(chunk, n - base));
  int* parent = smem;
  int* rootmin = smem + chunk;
  const LocalSlot local{parent, base};
  const ClusterSlot par{parent, base, count, chunk};
  const ClusterSlot rmin{rootmin, base, count, chunk};
  const auto mine = [&](int q) {
    return static_cast<unsigned>(q - base) < static_cast<unsigned>(count);
  };

  // (a) each cell points at the head of its run of left-linked cells
  // within its warp's 32 consecutive cells (a ballot, no atomics: uniting
  // along the run would have every lane of the warp contend for the same
  // roots). The block's link bits are staged as bytes in rootmin's space,
  // which (b) reads and (b') then reclaims.
  auto* links8 = reinterpret_cast<unsigned char*>(rootmin);
  auto* todo8 = links8 + chunk;
  const auto links = [&](int c) {
    return mine(c) ? static_cast<int>(links8[c - base]) : conn[c];
  };
  const int lane = threadIdx.x & 31;
  const auto left_linked = [&](int g, int bits) {
    return g % w > 0 && ((bits >> 2) & 1);
  };
  for (int i = 0; i * THREADS < count; ++i) {
    const int l = i * THREADS + threadIdx.x;
    const int g = base + l;
    const int bits = l < count ? conn[g] : 0;
    const unsigned linked = __ballot_sync(0xffffffffu, left_linked(g, bits));
    const unsigned starts = ~linked & (0xffffffffu >> (31 - lane));
    const int head = starts ? 31 - __clz(starts) : 0;
    if (l < count) {
      parent[l] = g - (lane - head);
      links8[l] = static_cast<unsigned char>(bits);
    }
  }
  __syncthreads();

  // (b) links inside the block. First each cell's links to unite, in one
  // pass without divergent loops: the other end in the block, not carried
  // by other links, and for a run's inner cells (not the first of a
  // 32-cell segment) not the left link, which (a) already joined.
  for (int l = threadIdx.x; l < count; l += THREADS) {
    const int g = base + l;
    const int bits = links8[l];
    int todo = 0;
    if (bits) {
      const int y = g / w, x = g - y * w;
#pragma unroll
      for (int ci = 0; ci < 8; ++ci) {
        const int q = neighbour(y, x, ci, h, w);
        if (((bits >> ci) & 1) && mine(q) &&
            !carried(links, q, ci, bits, y, x, w))
          todo |= 1 << ci;
      }
      if ((l & 31) && left_linked(g, bits)) todo &= ~(1 << 2);
    }
    todo8[l] = static_cast<unsigned char>(todo);
  }
  __syncthreads();
  // then the unions (one loop over a cell's set bits, so that a warp runs
  // one copy of the divergent union code)
  for (int l = threadIdx.x; l < count; l += THREADS) {
    int todo = todo8[l];
    if (todo == 0) continue;
    const int g = base + l;
    const int y = g / w, x = g - y * w;
    for (; todo; todo &= todo - 1)
      unite(local, g, neighbour(y, x, __ffs(todo) - 1, h, w));
  }
  __syncthreads();
  for (int l = threadIdx.x; l < count; l += THREADS) rootmin[l] = INT_MAX;
  __syncthreads();

  // (b') each cell points at its block-local root, whose rootmin slot takes
  // the minimum of init over the block-local component (one atomic per
  // warp where the whole warp shares a root, as in a filled region); bit i
  // of is_root marks cell threadIdx.x + i * THREADS as a block-local root
  unsigned is_root = 0;
  for (int i = 0; i * THREADS < count; ++i) {
    const int l = i * THREADS + threadIdx.x;
    const unsigned active = __ballot_sync(0xffffffffu, l < count);
    if (l >= count) continue;
    const int g = base + l;
    const int r = find_root_ro(local, g);
    const int v = init[g];
    const int lead = __ffs(active) - 1;
    if (__all_sync(active, r == __shfl_sync(active, r, lead))) {
      const int m = __reduce_min_sync(active, v);
      if (lane == lead) atomicMin(rootmin + (r - base), m);
    } else {
      atomicMin(rootmin + (r - base), v);
    }
    parent[l] = r;  // an ancestor: concurrent finds stay on their path
    if (r == g) is_root |= 1u << i;
  }
  cluster.sync();

  // (c) links that cross blocks: only cells within 2w of the block's run
  // of cells, or in the first or last image row, can have one
  const auto global_links = [&](int c) { return conn[c]; };
  for (int l = threadIdx.x; l < count; l += THREADS) {
    const int g = base + l;
    if (l >= 2 * w && l < count - 2 * w && g >= w && g < n - w) continue;
    const int bits = conn[g];
    if (bits == 0) continue;
    const int y = g / w, x = g - y * w;
    int todo = 0;
#pragma unroll
    for (int ci = 0; ci < 8; ++ci) {
      const int q = neighbour(y, x, ci, h, w);
      if (((bits >> ci) & 1) && !mine(q) &&
          !carried(global_links, q, ci, bits, y, x, w))
        todo |= 1 << ci;
    }
    for (; todo; todo &= todo - 1)
      unite(par, g, neighbour(y, x, __ffs(todo) - 1, h, w));
  }
  cluster.sync();

  // (d) each block-local root folds its minimum into its final root, then
  // takes the final minimum back into its own slot
  for (int i = 0; i * THREADS < count; ++i) {
    if (!((is_root >> i) & 1)) continue;
    const int l = i * THREADS + threadIdx.x;
    const int r = find_root(par, base + l);
    if (r != base + l) atomicMin(rmin(r), rootmin[l]);
  }
  cluster.sync();
  for (int i = 0; i * THREADS < count; ++i) {
    if (!((is_root >> i) & 1)) continue;
    const int l = i * THREADS + threadIdx.x;
    const int r = find_root_ro(par, base + l);
    if (r != base + l) rootmin[l] = *rmin(r);
  }
  cluster.sync();

  // (e) a cell's parent is a block-local root (its own, or one of another
  // block that a find in (c) halved its path to)
  for (int l = threadIdx.x; l < count; l += THREADS)
    out[base + l] = *rmin(parent[l]);
  cluster.sync();
}

cudaLaunchConfig_t launch_config(int smem, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t allow_max_smem() {
  static cudaError_t once = cudaFuncSetAttribute(
      cc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  return once;
}

// Shared memory of each cluster block at an h x w grid, in bytes (the
// wrapper's smem_per_block; it refuses grids where this exceeds MAX_SMEM).
int smem_per_block(int h, int w) {
  const int chunk = (h * w + CLUSTER - 1) / CLUSTER;
  return chunk * 2 * static_cast<int>(sizeof(int));
}

}  // namespace

// Clusters of this kernel the card can hold at once with the full shared
// memory per block (0: the cluster cannot be scheduled).
extern "C" int plvs_cc_max_active_clusters(int* clusters) {
  cudaError_t e = allow_max_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(MAX_SMEM, nullptr, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, cc_cluster_kernel, &cfg));
}

extern "C" int plvs_cc_min_labels(const void* init, const void* conn,
                                  void* out, int h, int w, void* stream) {
  const int n = h * w;
  if (n <= 0) return 0;
  const int smem = smem_per_block(h, w);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_max_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config(smem, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, cc_cluster_kernel,
                         static_cast<const int*>(init),
                         static_cast<const int*>(conn),
                         static_cast<int*>(out), h, w,
                         (n + CLUSTER - 1) / CLUSTER);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
