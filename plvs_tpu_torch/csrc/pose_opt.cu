// The motion-only pose solve of plvs_tpu_torch/solvers/pose_opt.py in one
// launch: every robust Gauss-Newton iteration of every round, the exit once
// the step is negligible, the chi2 in/outlier re-classification after each
// round, the last round without the Huber kernel, and the optional SE3
// prior.
//
// Replaces no Pallas kernel. It is the counterpart of the jitted
// plvs_tpu/solvers/pose_opt.py::pose_optimize (a scan over the rounds around
// a device-side while_loop), which the port ran as an eager Python loop of
// ~12k (points) to ~20k (points and lines) small launches a solve, with one
// host read of the step norm per iteration.
//
// What bounds it on an H100: neither bytes nor operations. A solve at the
// tracker's shapes reads ~40 KB once (1,000 point rows, 100 line rows) and
// does ~13 MFLOP over its 40 iterations. Its time is set by the chain of 40
// dependent iterations, each a block-wide reduction of the 27 sums of the
// normal equations, then a 6x6 solve and an SE3 update that the next
// iteration needs before it can start.
//
// The design keeps that chain inside one thread block of 256 threads. The
// rows are staged once into shared memory when they fit (else they are read
// in place, through L1). Row i belongs to thread i % 256 in every pass, and
// its in/outlier flag lives in the output with that thread. Each thread
// accumulates its rows' 21 upper entries of H and 6 of b in registers; warp
// shuffles, then one slot a warp in shared memory, sum them in a fixed
// order, so the sum is the same from run to run, with no atomics. Every
// thread then sums the 8 warp slots and solves the same 6x6 system itself,
// so the new pose needs no broadcast and an iteration costs one barrier
// (the warp slots are double-buffered by the iteration's parity). Masked
// rows are weighted by zero, not skipped, as in the plain loop, so a
// non-finite row gives the outcome it gives there. The kernel never waits
// for the host: the exit is decided on the device, and the iterations run
// are added to a device counter with one atomic a solve.

#include <cstdint>
#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUMS = 27;             // H's 21 upper entries (row-major), b's 6
constexpr int STAGE_FLOATS = 11000;  // 44,000 B of static shared memory

struct Args {
  Cam cam;
  const float *Xw, *uvr, *isig;
  const uint8_t* mask;
  int n;
  const float *Xs, *Xe, *nld, *lisig;
  const uint8_t* lmask;
  int l;
  const float *R0, *t0;
  const float *prior_R, *prior_t, *prior_info;  // all null without a prior
  int rounds, iters, stage;
  float line_weight;
  float *R_out, *t_out;
  uint8_t *in_pts, *in_lines;
  int64_t* num_inliers;
  unsigned long long* iters_acc;
};

// pose_opt._point_residual_jac for one row: residual (uR zeroed for a mono
// row), Jacobian and the row's depth; returns whether the row is stereo
__device__ __forceinline__ bool point_row(const Cam& c, const float* R,
                                          const float* t, const float* Xw,
                                          const float* uvr, float res[3],
                                          float J[3][6], float& z) {
  float X[3], uv[2], Jp[2][3];
  apply(R, t, Xw, X);
  project(c, X, uv);
  z = X[2];
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  const bool stereo = uvr[2] >= 0.0f;
  res[0] = uvr[0] - uv[0];
  res[1] = uvr[1] - uv[1];
  res[2] = stereo ? uvr[2] - (uv[0] - c.bf / zs) : 0.0f;
  project_jac(c, X, Jp);
  const float duR[3] = {Jp[0][0] + 0.0f, Jp[0][1] + 0.0f,
                        Jp[0][2] + c.bf / (zs * zs)};
  times_dX_dxi(Jp[0], X, J[0]);
  times_dX_dxi(Jp[1], X, J[1]);
  times_dX_dxi(duR, X, J[2]);
  return stereo;
}

// pose_opt._line_residual_jac for one row: the residual n . uv + d at both
// endpoints and its Jacobian (negated to the point convention); returns
// whether both endpoints lie in front (z > 0.05)
__device__ __forceinline__ bool line_row(const Cam& c, const float* R,
                                         const float* t, const float* Xs,
                                         const float* Xe, const float* nld,
                                         float res[2], float J[2][6]) {
  bool front = true;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float X[3], uv[2], Jp[2][3], Juv[2][6];
    apply(R, t, k ? Xe : Xs, X);
    project(c, X, uv);
    res[k] = nld[0] * uv[0] + nld[1] * uv[1] + nld[2];
    project_jac(c, X, Jp);
    times_dX_dxi(Jp[0], X, Juv[0]);
    times_dX_dxi(Jp[1], X, Juv[1]);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      J[k][j] = -(nld[0] * Juv[0][j] + nld[1] * Juv[1][j]);
    front = front && X[2] > 0.05f;
  }
  return front;
}

// acc += w J^T J (upper triangle) and w J^T r for one residual row
__device__ __forceinline__ void accumulate(float* acc, const float* J,
                                           float r, float w) {
  float jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) jw[i] = J[i] * w;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += jw[i] * J[j];
    acc[21 + i] += jw[i] * r;
  }
}

// se3_log: (R, t) -> (rho, theta), through so3_log's quaternion
__device__ __forceinline__ void se3_log(const float* R, const float* t,
                                        float* xi) {
  float q[4];
  rotmat_to_quat(R, q);
  const float nv = safe_norm3(q + 1);
  const float th2 = 2.0f * atan2f(nv, q[0]);
  const bool small_v = nv < LIE_EPS;
  const float scale = small_v ? 2.0f / clamp_min(q[0], LIE_EPS)
                              : th2 / (small_v ? 1.0f : nv);
  float* w = xi + 3;
  w[0] = q[1] * scale; w[1] = q[2] * scale; w[2] = q[3] * scale;
  // so3_left_jacobian_inv(w) t
  const float x = safe_norm3(w);
  float W[9], W2[9], Ji[9];
  hat(w, W);
  mul3(W, W, W2);
  const bool small = fabsf(x) < LIE_EPS;
  const float sx = small ? 1.0f : x;
  const float sinx = sinf(sx);
  const float sin_safe = fabsf(sinx) < LIE_EPS ? 1.0f : sinx;
  const float cot = small
      ? 1.0f / 12.0f + x * x / 720.0f
      : 1.0f / (small ? 1.0f : x * x)
        - (1.0f + cosf(sx)) / (2.0f * sx * sin_safe);
  eye_plus(-0.5f, W, cot, W2, Ji);
  mulv3(Ji, t, xi);
}

// torch.linalg.solve_ex(A, b) without the error check: LU with partial
// pivoting (the first largest |pivot| of the column, as LAPACK's getrf),
// then forward and back substitution; a singular A gives inf / NaN, not an
// error. Fully unrolled, so the rows stay in registers.
__device__ __forceinline__ void solve6(float A[6][6], float b[6], float x[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
        const float s = b[k];
        b[k] = b[i];
        b[i] = s;
      }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= f * A[k][j];
      b[i] -= f * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// copies count floats to the shared stage and returns where they went
__device__ __forceinline__ const float* stage_floats(float*& s,
                                                     const float* src,
                                                     int count, int tid) {
  for (int i = tid; i < count; i += THREADS) s[i] = src[i];
  const float* out = s;
  s += count;
  return out;
}

__global__ void __launch_bounds__(THREADS) pose_solve_kernel(const Args a) {
  __shared__ float stage[STAGE_FLOATS];
  __shared__ float warp_sums[2][WARPS][SUMS];
  __shared__ int warp_counts[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Cam cam = a.cam;
  const int n = a.n, l = a.l;

  const float *Xw = a.Xw, *uvr = a.uvr, *isig = a.isig;
  const float *Xs = a.Xs, *Xe = a.Xe, *nld = a.nld, *lisig = a.lisig;
  const uint8_t *mask = a.mask, *lmask = a.lmask;
  if (a.stage) {
    float* s = stage;
    Xw = stage_floats(s, Xw, 3 * n, tid);
    uvr = stage_floats(s, uvr, 3 * n, tid);
    isig = stage_floats(s, isig, n, tid);
    Xs = stage_floats(s, Xs, 3 * l, tid);
    Xe = stage_floats(s, Xe, 3 * l, tid);
    nld = stage_floats(s, nld, 3 * l, tid);
    lisig = stage_floats(s, lisig, l, tid);
    uint8_t* sb = reinterpret_cast<uint8_t*>(s);
    for (int i = tid; i < n; i += THREADS) sb[i] = mask[i];
    for (int j = tid; j < l; j += THREADS) sb[n + j] = lmask[j];
    mask = sb;
    lmask = sb + n;
    __syncthreads();
  }
  // each row's in/outlier flag lives in the output, with its thread
  for (int i = tid; i < n; i += THREADS) a.in_pts[i] = mask[i];
  for (int j = tid; j < l; j += THREADS) a.in_lines[j] = lmask[j];

  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = a.R0[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = a.t0[i];
  const bool has_prior = a.prior_info != nullptr;
  float Rp_inv[9], tp_inv[3];
  if (has_prior) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rp_inv[3 * i + j] = a.prior_R[3 * j + i];
    mulv3(Rp_inv, a.prior_t, tp_inv);
#pragma unroll
    for (int i = 0; i < 3; ++i) tp_inv[i] = -tp_inv[i];
  }

  int parity = 0, ran = 0;
  for (int round = 0; round < a.rounds; ++round) {
    const bool robust = round < a.rounds - 1;
    for (int it = 0; it < a.iters; ++it) {
      ++ran;
      float acc[SUMS];
#pragma unroll
      for (int k = 0; k < SUMS; ++k) acc[k] = 0.0f;
      for (int i = tid; i < n; i += THREADS) {
        float res[3], J[3][6], z;
        const bool stereo = point_row(cam, R, t, Xw + 3 * i, uvr + 3 * i,
                                      res, J, z);
        const bool on = mask[i] && z > 0.05f && a.in_pts[i];
        float w = isig[i] * (on ? 1.0f : 0.0f);
        if (robust) {
          const float chi2 = (res[0] * res[0] + res[1] * res[1]
                              + res[2] * res[2]) * isig[i];
          w = w * huber(chi2, stereo ? CHI2_3D : CHI2_2D);
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) accumulate(acc, J[r], res[r], w);
      }
      for (int j = tid; j < l; j += THREADS) {
        float res[2], J[2][6];
        const bool front = line_row(cam, R, t, Xs + 3 * j, Xe + 3 * j,
                                    nld + 3 * j, res, J);
        const bool on = lmask[j] && front && a.in_lines[j];
        float w = lisig[j] * (on ? 1.0f : 0.0f) * a.line_weight;
        if (robust)
          w = w * huber((res[0] * res[0] + res[1] * res[1]) * lisig[j],
                        CHI2_2D);
        accumulate(acc, J[0], res[0], w);
        accumulate(acc, J[1], res[1], w);
      }
      // the block's sums in a fixed order: lanes by shuffle, then warps
#pragma unroll
      for (int k = 0; k < SUMS; ++k) {
        float v = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) warp_sums[parity][warp][k] = v;
      }
      __syncthreads();
      float H[6][6], b[6], sum[SUMS];
#pragma unroll
      for (int k = 0; k < SUMS; ++k) {
        sum[k] = warp_sums[parity][0][k];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum[k] += warp_sums[parity][w][k];
      }
      parity ^= 1;
      int k = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = sum[k++];
        b[i] = sum[21 + i];
      }
      if (has_prior) {
        // e = log(T T_prior^-1); H += info, b -= info e
        float Re[9], te[3], e[6];
        mul3(R, Rp_inv, Re);
        mulv3(R, tp_inv, te);
#pragma unroll
        for (int i = 0; i < 3; ++i) te[i] += t[i];
        se3_log(Re, te, e);
        const float* info = a.prior_info;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          float ie = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            H[i][j] += info[6 * i + j];
            ie += info[6 * i + j] * e[j];
          }
          b[i] -= ie;
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) H[i][i] += 1e-6f;
      float dx[6], dR[9], dt[3], Rn[9], tn[3], q[4];
      solve6(H, b, dx);
      se3_exp(dx, dR, dt);
      mul3(dR, R, Rn);
      mulv3(dR, t, tn);
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = tn[i] + dt[i];
      rotmat_to_quat(Rn, q);
      quat_to_rotmat(q, R);
      float dd = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) dd += dx[i] * dx[i];
      if (static_cast<double>(dd) < 1e-16) break;
    }
    // re-classify in/outliers for the next round (outliers may return)
    for (int i = tid; i < n; i += THREADS) {
      float res[3], J[3][6], z;
      const bool stereo = point_row(cam, R, t, Xw + 3 * i, uvr + 3 * i, res,
                                    J, z);
      const float chi2 = (res[0] * res[0] + res[1] * res[1]
                          + res[2] * res[2]) * isig[i];
      a.in_pts[i] = mask[i] && z > 0.05f
                    && chi2 <= (stereo ? CHI2_3D : CHI2_2D);
    }
    for (int j = tid; j < l; j += THREADS) {
      float res[2], J[2][6];
      const bool front = line_row(cam, R, t, Xs + 3 * j, Xe + 3 * j,
                                  nld + 3 * j, res, J);
      const float chi2 = (res[0] * res[0] + res[1] * res[1]) * lisig[j];
      a.in_lines[j] = lmask[j] && front && chi2 <= CHI2_2D;
    }
  }

  int count = 0;
  for (int i = tid; i < n; i += THREADS) count += a.in_pts[i];
  for (int j = tid; j < l; j += THREADS) count += a.in_lines[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int64_t total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_counts[w];
    *a.num_inliers = total;
#pragma unroll
    for (int i = 0; i < 9; ++i) a.R_out[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) a.t_out[i] = t[i];
    atomicAdd(a.iters_acc, static_cast<unsigned long long>(ran));
  }
}

}  // namespace

// One whole solve, one launch on `stream`. Pointers are device pointers of
// contiguous float32 / bool tensors (the line ones may be null with l == 0,
// the prior's all null without a prior); cam_params is a host array of 9
// floats. Returns the launch's cudaError_t.
extern "C" int plvs_pose_solve(
    const void* Xw, const void* uvr, const void* isig, const void* mask,
    int n, const void* Xs, const void* Xe, const void* nld,
    const void* lisig, const void* lmask, int l, const void* R0,
    const void* t0, const void* prior_R, const void* prior_t,
    const void* prior_info, int cam_kind, const float* cam_params, float bf,
    int rounds, int iters, float line_weight, void* R_out, void* t_out,
    void* in_pts, void* in_lines, void* num_inliers, void* iters_acc,
    void* stream) {
  Args a;
  a.cam.kind = cam_kind;
  for (int i = 0; i < 9; ++i) a.cam.p[i] = cam_params[i];
  a.cam.bf = bf;
  a.Xw = static_cast<const float*>(Xw);
  a.uvr = static_cast<const float*>(uvr);
  a.isig = static_cast<const float*>(isig);
  a.mask = static_cast<const uint8_t*>(mask);
  a.n = n;
  a.Xs = static_cast<const float*>(Xs);
  a.Xe = static_cast<const float*>(Xe);
  a.nld = static_cast<const float*>(nld);
  a.lisig = static_cast<const float*>(lisig);
  a.lmask = static_cast<const uint8_t*>(lmask);
  a.l = l;
  a.R0 = static_cast<const float*>(R0);
  a.t0 = static_cast<const float*>(t0);
  a.prior_R = static_cast<const float*>(prior_R);
  a.prior_t = static_cast<const float*>(prior_t);
  a.prior_info = static_cast<const float*>(prior_info);
  a.rounds = rounds;
  a.iters = iters;
  a.line_weight = line_weight;
  a.stage = 7LL * n + 10LL * l + (n + l + 3LL) / 4 <= STAGE_FLOATS;
  a.R_out = static_cast<float*>(R_out);
  a.t_out = static_cast<float*>(t_out);
  a.in_pts = static_cast<uint8_t*>(in_pts);
  a.in_lines = static_cast<uint8_t*>(in_lines);
  a.num_inliers = static_cast<int64_t*>(num_inliers);
  a.iters_acc = static_cast<unsigned long long*>(iters_acc);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(pose_solve_kernel), dim3(1),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream)));
}
