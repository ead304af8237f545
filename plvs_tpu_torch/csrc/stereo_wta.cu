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
// are ~0.35 G operations (~5.3 us at the 67 T/s non-tensor rate). The first
// design wrote the aggregated volume to a [D, H, W] float32 device scratch
// (78.6 MB at the main-path shape) in one launch and swept it in two more:
// 0.237 ms of device time (0.164 + 0.066 + 0.003 ms), the scratch round
// trip alone >= 70 us.
//
// This design is one launch and the volume never leaves the chip. One block
// owns a band of TH full-width rows (TH = 4; 2 for images wider than 700
// columns) and sweeps d once, two disparities per __syncthreads:
//   * the right census rows of the band and its r-row halo are staged in
//     shared memory with cp.async; each thread keeps its raw column's left
//     census words in registers (they do not depend on d);
//   * stage 1: each thread forms the raw costs of its column for the
//     TH + 2r rows and their vertical (2r+1)-sums for the TH rows, into a
//     double-buffered shared array;
//   * stage 2: each thread owns G = 4 adjacent pixels of one row, reads the
//     vertical sums with 16-B loads, slides the horizontal (2r+1)-sum along
//     them and updates each pixel's running state in registers. The state
//     compares integer box sums packed with d into one key (see D_BITS):
//     the lowest d of the smallest sum wins; second-best over
//     |d - bestd| > 1 comes in one pass (a prefix minimum of the sums at
//     d' <= d - 2 becomes `second` when a new best arrives, later sums fold
//     in when d - bestd > 1); the three sums around bm = clip(bestd, 1,
//     D - 2) are captured at step bm + 1 from the last two; and the right
//     image's winner of column x - d is an atomic minimum of keys in shared
//     memory;
//   * after the sweep, the floats are formed once and the left-right check
//     reads dR from shared memory.
// What bounds this design is instruction issue and latency at one block of
// 21 warps per SM. Shared memory is 4 B x (4 TH Wp + 2 TH W4 G + (TH+2r) W)
// with Wp the padded row of vertical sums: 86 KB at 640 columns, r = 3.
// The float steps (the scale, the uniqueness product, the subpixel
// parabola) are written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, so nvcc cannot contract them into FMAs: exact against the
// plain PyTorch version.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 704;    // keeps the pixel state in registers
constexpr int MAX_SMEM = 232448;    // 227 KB: an H100 block's dynamic limit
constexpr int INVALID_COST = 1000;  // 1e3 in the TPU kernel
constexpr float BIG = 1e9f;

// rows per band: the wrapper's band_config mirrors this
__host__ __device__ constexpr int band_rows(int cols_per_thread) {
  return cols_per_thread == 1 ? 4 : 2;
}

constexpr int G = 4;     // adjacent output columns a thread owns in stage 2
constexpr int STEP = 2;  // disparities per barrier

// The sweep compares integer box sums s: agg = float(s) * inv_k2 rounds a
// product of spacing inv_k2 >= 1/225 (r <= 7), wider than float32's ulp at
// the largest agg (1000, ulp 6.1e-5), so distinct sums give distinct aggs in
// the same order, and the integer comparisons pick what the float ones
// would. A sum and its d pack into one key, s << D_BITS | d, whose minimum
// is the lowest d of the smallest sum: the tie rule of both winners.
constexpr int D_BITS = 13;  // d < 8192; s < 2^18 for r <= 7
constexpr int D_MASK = (1 << D_BITS) - 1;
constexpr int NONE = 0x7fffffff;

struct Pixel {
  int best_key, second, pre, prev1, prev2, c0, c1, c2;
};

__device__ __forceinline__ void sweep_step(Pixel& p, int s, int key, int d,
                                           int nd) {
  if (d >= 2) p.pre = min(p.pre, p.prev2);  // min over d' <= d - 2
  if (key < p.best_key) {
    p.best_key = key;
    p.second = p.pre;
  } else if (d - (p.best_key & D_MASK) > 1) {
    p.second = min(p.second, s);
  }
  const int bm = min(max(p.best_key & D_MASK, 1), nd - 2);
  if (d == bm + 1) {
    p.c0 = p.prev2;
    p.c1 = p.prev1;
    p.c2 = s;
  }
  p.prev2 = p.prev1;
  p.prev1 = s;
}

// Slot of right column xr of band row j in the right-winner arrays, laid
// out [j][xr % G][xr / G] so that the G columns a thread owns, shifted by
// any d, fall in distinct banks across a warp.
__device__ __forceinline__ int right_slot(int j, int xr, int w4) {
  return (j * G + xr % G) * w4 + xr / G;
}

template <int R, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
stereo_band_kernel(const int32_t* __restrict__ cl,
                   const int32_t* __restrict__ cr, float* __restrict__ out,
                   int h, int w, int nd, float inv_k2, float uniqueness,
                   float lr_thresh) {
  constexpr int TH = band_rows(CPT);
  constexpr int RH = TH + 2 * R;
  constexpr int NV = G * ((2 * G + 2 * R - 1) / G);  // sums a thread reads
  extern __shared__ __align__(16) int smem[];
  const int w4 = (w + G - 1) / G;
  const int rwp = G * w4 + NV - G;  // row stride of the vertical sums
  int* vbuf = smem;                   // [2][STEP][TH][rwp] vertical sums
  int* best_r = vbuf + 2 * STEP * TH * rwp;  // [TH][G][w4] right winners
  int* rs = best_r + TH * G * w4;     // [RH][w] right census rows
  const int y0 = blockIdx.x * TH;
  const int t = threadIdx.x, nt = blockDim.x;
  // stage 2: this thread's band row and first of its G columns
  const int j2 = t / w4, x0 = (t - j2 * w4) * G;
  const bool owns = j2 < TH && y0 + j2 < h;

  unsigned row_ok = 0;
#pragma unroll
  for (int row = 0; row < RH; ++row) {
    const int y = y0 - R + row;
    if (y >= 0 && y < h) row_ok |= 1u << row;
  }
  for (int i = t; i < RH * w; i += nt) {
    const int row = i / w;
    if ((row_ok >> row) & 1)
      __pipeline_memcpy_async(rs + i, cr + ((y0 - R) * w + i), sizeof(int));
  }
  __pipeline_commit();

  uint32_t left[CPT][RH];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int xc = t + k * nt - R;
#pragma unroll
    for (int row = 0; row < RH; ++row)
      left[k][row] = (((row_ok >> row) & 1) && xc >= 0 && xc < w)
                         ? static_cast<uint32_t>(cl[(y0 - R + row) * w + xc])
                         : 0u;
  }
  for (int i = t; i < TH * G * w4; i += nt) {
    best_r[i] = NONE;
  }
  Pixel px[G];
#pragma unroll
  for (int k = 0; k < G; ++k)
    px[k] = Pixel{NONE, NONE, NONE, 0, 0, 0, 0, 0};
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int d0 = 0; d0 < nd; d0 += STEP) {
    int* vb0 = vbuf + ((d0 / STEP) & 1) * STEP * TH * rwp;
    // stage 1: raw costs of this thread's column(s), vertical box sums,
    // for STEP disparities
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = t + k * nt;
      if (c >= w + 2 * R) continue;
      const int xc = c - R;
      const bool col_ok = xc >= 0 && xc < w;
#pragma unroll
      for (int e = 0; e < STEP; ++e) {
        const int d = d0 + e;
        if (d >= nd) break;
        int* vb = vb0 + e * TH * rwp;
        int raw[RH];
#pragma unroll
        for (int row = 0; row < RH; ++row) {
          int v = 0;
          if (col_ok && ((row_ok >> row) & 1))
            v = xc < d ? INVALID_COST
                       : __popc(left[k][row] ^
                                static_cast<uint32_t>(rs[row * w + xc - d]));
          raw[row] = v;
        }
        int s = 0;
#pragma unroll
        for (int row = 0; row <= 2 * R; ++row) s += raw[row];
        vb[c] = s;
#pragma unroll
        for (int j = 1; j < TH; ++j) {
          s += raw[j + 2 * R] - raw[j - 1];
          vb[j * rwp + c] = s;
        }
      }
    }
    __syncthreads();
    // stage 2: sliding horizontal box sums over G adjacent columns, the
    // per-pixel sweep in d order, and the right-image winners (an atomic
    // minimum of keys: column xr takes candidates from x = xr + d and
    // xr + d + 1 within one step)
    if (owns) {
#pragma unroll
      for (int e = 0; e < STEP; ++e) {
        const int d = d0 + e;
        if (d >= nd) break;
        int vals[NV];
        const int4* row =
            reinterpret_cast<const int4*>(vb0 + (e * TH + j2) * rwp + x0);
#pragma unroll
        for (int q = 0; q < NV / G; ++q) {
          const int4 v4 = row[q];
          vals[G * q] = v4.x;
          vals[G * q + 1] = v4.y;
          vals[G * q + 2] = v4.z;
          vals[G * q + 3] = v4.w;
        }
        int s = 0;
#pragma unroll
        for (int o = 0; o <= 2 * R; ++o) s += vals[o];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          if (k) s += vals[k + 2 * R] - vals[k - 1];
          const int x = x0 + k;
          if (x >= w) continue;
          const int key = s << D_BITS | d;
          sweep_step(px[k], s, key, d, nd);
          const int xr = x - d;  // cost_R(xr, d) = cost_L(xr + d, d)
          if (xr >= 0) atomicMin(best_r + right_slot(j2, xr, w4), key);
        }
      }
    }
  }
  __syncthreads();
  if (!owns) return;

#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int x = x0 + k;
    if (x >= w) continue;
    const Pixel& p = px[k];
    const int bestd = p.best_key & D_MASK;
    const auto agg = [&](int sum) {
      return __fmul_rn(static_cast<float>(sum), inv_k2);
    };
    const float best = agg(p.best_key >> D_BITS);
    const float second = p.second == NONE ? BIG : agg(p.second);
    const float c0 = agg(p.c0), c1 = agg(p.c1), c2 = agg(p.c2);
    const int bm = min(max(bestd, 1), nd - 2);
    const float denom = __fadd_rn(__fsub_rn(c0, __fmul_rn(2.0f, c1)), c2);
    float delta = 0.0f;
    if (fabsf(denom) > 1e-6f)
      delta = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(c0, c2)), denom);
    delta = fminf(fmaxf(delta, -1.0f), 1.0f);
    const int dr =
        x - bestd >= 0 ? best_r[right_slot(j2, x - bestd, w4)] & D_MASK : 0;
    const bool ok = best <= __fmul_rn(uniqueness, second) && bestd > 0 &&
                    bestd < nd - 1 &&
                    fabsf(__fsub_rn(static_cast<float>(bestd),
                                    static_cast<float>(dr))) <= lr_thresh;
    out[(y0 + j2) * w + x] =
        ok ? __fadd_rn(static_cast<float>(bm), delta) : -1.0f;
  }
}

template <int R, int CPT>
cudaError_t launch(const int32_t* cl, const int32_t* cr, float* out, int h,
                   int w, int nd, float inv_k2, float uniqueness,
                   float lr_thresh, int threads, int smem, cudaStream_t s) {
  static const cudaError_t allowed = cudaFuncSetAttribute(
      stereo_band_kernel<R, CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (allowed != cudaSuccess) return allowed;
  constexpr int TH = band_rows(CPT);
  stereo_band_kernel<R, CPT><<<(h + TH - 1) / TH, threads, smem, s>>>(
      cl, cr, out, h, w, nd, inv_k2, uniqueness, lr_thresh);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(int cpt, const int32_t* cl, const int32_t* cr,
                     float* out, int h, int w, int nd, float inv_k2,
                     float uniqueness, float lr_thresh, int threads, int smem,
                     cudaStream_t s) {
  if (cpt == 1)
    return launch<R, 1>(cl, cr, out, h, w, nd, inv_k2, uniqueness,
                        lr_thresh, threads, smem, s);
  if (cpt == 2)
    return launch<R, 2>(cl, cr, out, h, w, nd, inv_k2, uniqueness,
                        lr_thresh, threads, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// out: [h, w] float32 disparity (< 0 invalid). The band geometry
// (cols_per_thread, threads, smem bytes) comes from the wrapper's
// band_config, which refuses what this kernel does not take.
extern "C" int plvs_stereo_wta(const void* cl, const void* cr, void* out,
                               int h, int w, int nd, int r, float inv_k2,
                               float uniqueness, float lr_thresh,
                               int cols_per_thread, int threads, int smem,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const int rows = band_rows(cols_per_thread);
  if (threads > MAX_THREADS || threads * cols_per_thread < w + 2 * r ||
      threads < rows * ((w + G - 1) / G) || smem > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const int32_t*>(cl);
  const auto* b = static_cast<const int32_t*>(cr);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (r) {
#define PLVS_RADIUS(RR)                                                      \
  case RR:                                                                   \
    e = launch_r<RR>(cols_per_thread, a, b, o, h, w, nd, inv_k2, uniqueness, \
                     lr_thresh, threads, smem, s);                           \
    break;
    PLVS_RADIUS(0) PLVS_RADIUS(1) PLVS_RADIUS(2) PLVS_RADIUS(3)
    PLVS_RADIUS(4) PLVS_RADIUS(5) PLVS_RADIUS(6) PLVS_RADIUS(7)
#undef PLVS_RADIUS
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
