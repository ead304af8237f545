// Census-stereo disparity: box-aggregated census cost, winner-take-all with
// uniqueness, parabolic subpixel and left-right check.
//
// Replaces the TPU kernel plvs_tpu/ops/stereo.py::disparity_wta_pallas
// (one grid step per 8-row band with the [D, 8, W] aggregated volume kept in
// VMEM, three sweeps over d). It computes the same function, borders
// included: raw(y, x, d) = popcount(cl[y, x] ^ cr[y, x - d]), 1000 where
// x < d, 0 outside the image (the row rule first); agg = integer box sum
// over (2r+1)^2 times float32(1 / (2r+1)^2); the lowest d of the smallest
// agg wins; the right-image winner reads agg(x + d, d) (1e9 past the right
// edge); a pixel is kept when best <= uniqueness * second-best (|d - best|
// > 1), |d - dR| <= lr_thresh and 0 < d < D - 1.
//
// What bounds it on an H100: operations. At 480 x 640 x 64 the census in
// (2.5 MB) and disparity out (1.2 MB) take ~1.1 us at 3.35 TB/s, while
// H*W*D XOR+popcount, 2*(2r+1)*H*W*D box additions and ~3*H*W*D compares
// are ~0.37 G operations (~6 us at the 67 T/s non-tensor rate). The TPU
// kernel's band volume (1.3 MB at D = 64, W = 640) does not fit one block's
// 227 KB of shared memory, so this first design keeps it in device memory:
//   (a) agg_kernel: one block per (64-column x 16-row tile, d); the tile's
//       raw costs with their r-halo are computed once into shared memory
//       (census reads hit L2: each image is 1.2 MB), then a separable box
//       sum (rows of 2r+1, then columns of 2r+1) writes agg[d, y, x] to a
//       [D, H, W] float32 scratch the wrapper allocates (78.6 MB at the
//       main-path shape);
//   (b) wta_kernel: one thread per pixel sweeps d twice over its column of
//       agg (coalesced across x): best / bestd and the right-image winner
//       first, then second-best, and the three costs around the winner;
//   (c) lr_kernel: one thread per pixel gathers dR = bestRd(x - bestd) and
//       applies the left-right check.
// The scratch round trip alone (~3 x 78.6 MB, >= 70 us at 3.35 TB/s) puts
// this design an order of magnitude above the bound; keeping the volume on
// chip is a later redesign.
//
// Exact against the plain PyTorch version: the cost sums are integers, and
// the float steps (the 1 / (2r+1)^2 scale, the uniqueness product and the
// subpixel parabola) use __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so
// nvcc cannot contract them into FMAs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;              // tile columns per block in (a)
constexpr int TH = 16;              // tile rows per block in (a)
constexpr int THREADS = 256;
constexpr int INVALID_COST = 1000;  // 1e3 in the TPU kernel
constexpr float BIG = 1e9f;

__global__ void agg_kernel(const int32_t* __restrict__ cl,
                           const int32_t* __restrict__ cr,
                           float* __restrict__ agg, int h, int w, int r,
                           float inv_k2) {
  extern __shared__ int smem[];
  const int k = 2 * r + 1;
  const int rw = TW + 2 * r;
  const int rh = TH + 2 * r;
  int* raw = smem;              // [rh][rw]
  int* hsum = smem + rh * rw;   // [rh][TW]
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int d = blockIdx.z;

  for (int i = threadIdx.x; i < rh * rw; i += THREADS) {
    const int yy = y0 - r + i / rw;
    const int xx = x0 - r + i % rw;
    int c = 0;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
      const int64_t row = static_cast<int64_t>(yy) * w;
      c = (xx < d) ? INVALID_COST
                   : __popc(static_cast<uint32_t>(cl[row + xx]) ^
                            static_cast<uint32_t>(cr[row + xx - d]));
    }
    raw[i] = c;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rh * TW; i += THREADS) {
    const int* src = raw + (i / TW) * rw + (i % TW);
    int s = 0;
    for (int t = 0; t < k; ++t) s += src[t];
    hsum[i] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int j = i / TW, c = i % TW;
    const int y = y0 + j, x = x0 + c;
    if (y >= h || x >= w) continue;
    int s = 0;
    for (int t = 0; t < k; ++t) s += hsum[(j + t) * TW + c];
    agg[(static_cast<int64_t>(d) * h + y) * w + x] =
        __fmul_rn(static_cast<float>(s), inv_k2);
  }
}

__global__ void wta_kernel(const float* __restrict__ agg,
                           int32_t* __restrict__ bestd_out,
                           int32_t* __restrict__ bestrd_out,
                           float* __restrict__ cand_out, int h, int w, int nd,
                           float uniqueness) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int x = static_cast<int>(p % w);
  const float* a = agg + p;

  float best = BIG, best_r = BIG;
  int bestd = 0, bestrd = 0;
  for (int d = 0; d < nd; ++d) {
    const float v = a[d * plane];
    if (v < best) { best = v; bestd = d; }
    if (x + d < w) {  // cost_R(x, d) = cost_L(x + d, d)
      const float vr = a[d * plane + d];
      if (vr < best_r) { best_r = vr; bestrd = d; }
    }
  }
  float second = BIG;
  for (int d = 0; d < nd; ++d) {
    const float v = a[d * plane];
    if (abs(d - bestd) > 1 && v < second) second = v;
  }
  const int bm = min(max(bestd, 1), nd - 2);
  const float c0 = a[(bm - 1) * plane];
  const float c1 = a[bm * plane];
  const float c2 = a[(bm + 1) * plane];
  const float denom = __fadd_rn(__fsub_rn(c0, __fmul_rn(2.0f, c1)), c2);
  float delta = 0.0f;
  if (fabsf(denom) > 1e-6f)
    delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(c0, c2)), denom);
  delta = fminf(fmaxf(delta, -1.0f), 1.0f);
  const bool ok = best <= __fmul_rn(uniqueness, second) && bestd > 0 &&
                  bestd < nd - 1;
  bestd_out[p] = bestd;
  bestrd_out[p] = bestrd;
  cand_out[p] = ok ? __fadd_rn(static_cast<float>(bm), delta) : -1.0f;
}

__global__ void lr_kernel(const int32_t* __restrict__ bestd,
                          const int32_t* __restrict__ bestrd,
                          const float* __restrict__ cand,
                          float* __restrict__ out, int h, int w,
                          float lr_thresh) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const int x = static_cast<int>(p % w);
  const int bd = bestd[p];
  const int dr = (x - bd >= 0) ? bestrd[p - bd] : 0;
  const float c = cand[p];
  const bool lr_ok = fabsf(__fsub_rn(static_cast<float>(bd),
                                     static_cast<float>(dr))) <= lr_thresh;
  out[p] = (c >= 0.0f && lr_ok) ? c : -1.0f;
}

}  // namespace

// agg: [nd, h, w] float32 scratch; bestd, bestrd: [h, w] int32 scratch;
// cand: [h, w] float32 scratch; out: [h, w] float32 disparity (< 0 invalid).
extern "C" int plvs_stereo_wta(const void* cl, const void* cr, void* agg,
                               void* bestd, void* bestrd, void* cand,
                               void* out, int h, int w, int nd, int r,
                               float inv_k2, float uniqueness,
                               float lr_thresh, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>((TH + 2 * r) * (TW + 2 * r) +
                                          (TH + 2 * r) * TW) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid_a((w + TW - 1) / TW, (h + TH - 1) / TH, nd);
  agg_kernel<<<grid_a, THREADS, smem, s>>>(
      static_cast<const int32_t*>(cl), static_cast<const int32_t*>(cr),
      static_cast<float*>(agg), h, w, r, inv_k2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int64_t plane = static_cast<int64_t>(h) * w;
  const unsigned blocks = static_cast<unsigned>((plane + THREADS - 1) / THREADS);
  wta_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(agg), static_cast<int32_t*>(bestd),
      static_cast<int32_t*>(bestrd), static_cast<float*>(cand), h, w, nd,
      uniqueness);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  lr_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const int32_t*>(bestd), static_cast<const int32_t*>(bestrd),
      static_cast<const float*>(cand), static_cast<float*>(out), h, w,
      lr_thresh);
  return static_cast<int>(cudaGetLastError());
}
