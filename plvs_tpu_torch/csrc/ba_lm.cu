// The bundle adjustment of plvs_tpu_torch/solvers/ba.py (the scatter-free
// formulation, block-Jacobi PCG) in one launch: every LM iteration and every
// CG iteration of a solve, the accept test and the damping schedule decided
// on the device, with no host read.
//
// Replaces no Pallas kernel. It is the counterpart of the jitted
// plvs_tpu/solvers/ba.py::bundle_adjust (two nested while_loops), which the
// port ran as an eager loop of ~13k small launches a local solve (5 LM x 14
// CG), each segment sum a cumulative-sum scan over the observation rows.
//
// What bounds it on an H100: neither bytes nor operations. The benchmark
// cells' largest local solves (K 7 cameras, P ~2.2k points, M ~3.9k point
// rows, a few dozen line rows) keep ~0.6 MB of Jacobian rows, all
// L2-resident; one CG iteration reads them once (~0.2 us of HBM time even
// from device memory) and does ~0.3 MFLOP. A window of 17 cameras and 30k
// rows is ~5x that. The time is set by the chain of dependent steps: up to
// 5 x 14 CG iterations of three grid-wide barriers each (the matvec's
// landmark half, its camera half with the step length's dot product, the
// update with the next dot product) and four more an LM iteration, ~0.3-1
// ms of barriers a solve at the full trip count.
//
// Design. One cooperative launch of at most one block per SM, phases
// separated by grid.sync(). The wrapper orders the rows once a solve (by
// point, by line and by camera, with CSR offsets). Every point or line
// block of H, b and the matvec is summed by one thread walking its run of
// rows; every camera block by one thread block walking its run, then a
// fixed-order block reduction; every dot product from per-block partials
// that each block adds in block order. No float atomics and no scan: two
// runs give the same bits, and each block's sum carries eps x its own sum.
// The Jacobian rows are evaluated once per LM iteration into the
// workspace (36 floats a point row, 48 a line row) and read by every
// matvec. Data written by other blocks is read with __ldcg (through L2):
// L1 is not coherent across SMs. Masked rows are weighted by zero, not
// skipped, as in the plain solve. Every block takes each stop decision
// (the CG's rz <= 1e-12 rz0, the LM's converged accept) from the same
// sums, so all leave their loops together; iterations past a stop, which
// the plain solve's active flags leave without effect, are not run.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "geometry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 1024;
constexpr int PROW = 36;  // Jc 18 | Jp 9 | wr 3 | wr * res 3 | pad 3
// Jc 24 | Jl 12 (Jxs, Jxe, Jxds, Jxde) | wr 4 | wr * res 4
constexpr int LROW = 48;
constexpr float LINE_CHI2_DEPTH = 9.488f;
constexpr unsigned FULL = 0xffffffffu;

// partial sums, MAX_BLOCKS each
enum { PART_RZ, PART_PAP_LM, PART_PAP_CAM, PART_COST_P, PART_NOK,
       PART_COST_L, NPART };

// device pointers, in the order the wrapper passes them
enum { P_R0, P_T0, P_FIXED, P_CAM_MASK, P_X0, P_PT_MASK, P_OBS_CAM,
       P_OBS_PT, P_UVR, P_ISIG, P_OBS_MASK, P_XS0, P_XE0, P_LN_MASK,
       P_LOBS_CAM, P_LOBS_LINE, P_NLD, P_LISIG, P_LOBS_MASK, P_LDEPTH, P_ORD,
       P_OFF, P_WS, P_R_OUT, P_T_OUT, P_X_OUT, P_XS_OUT, P_XE_OUT, P_INFO_F,
       P_INFO_I, P_ACC, NPTR };

struct Work {
  float *prow, *lrow, *g, *lg;
  float *cx, *cr, *cz, *cp, *cAp, *cM, *cld, *R[2], *t[2];
  float *px, *pr, *pz, *pp, *pAp, *pM, *pld, *X[2];
  float *lx, *lr, *lz, *lp, *lAp, *lM, *lld, *Xs[2], *Xe[2];
  float* part;
};

struct Args {
  Cam cam;
  float bf_line;  // the line rows' disparity scale (cam.bf, else fx / 10)
  int K, P, M, L, Ml, num_iters, cg_iters;
  float lam0, line_weight;
  const float *R0, *t0, *X0, *uvr, *isig, *Xs0, *Xe0, *nld, *lisig, *ldepth;
  const uint8_t *fixed, *cam_mask, *pt_mask, *obs_mask, *ln_mask, *lobs_mask;
  const int64_t *obs_cam, *obs_pt, *lobs_cam, *lobs_line, *ord, *off;
  Work w;
  float *R_out, *t_out, *X_out, *Xs_out, *Xe_out, *info_f;
  int* info_i;
  unsigned long long* acc;
};

// the workspace's layout; returns its size in floats (base may be null)
long long layout(int K, int P, int M, int L, int Ml, float* base, Work* w) {
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += (count + 3) / 4 * 4;
    return p;
  };
  w->prow = take(1LL * PROW * M);
  w->lrow = take(1LL * LROW * Ml);
  w->g = take(6LL * M);
  w->lg = take(6LL * Ml);
  float** cam6[] = {&w->cx, &w->cr, &w->cz, &w->cp, &w->cAp, &w->cld};
  for (float** p : cam6) *p = take(6LL * K);
  w->cM = take(36LL * K);
  float** pt3[] = {&w->px, &w->pr, &w->pz, &w->pp, &w->pAp, &w->pld};
  for (float** p : pt3) *p = take(3LL * P);
  w->pM = take(9LL * P);
  float** ln6[] = {&w->lx, &w->lr, &w->lz, &w->lp, &w->lAp, &w->lld};
  for (float** p : ln6) *p = take(6LL * L);
  w->lM = take(36LL * L);
  for (int b = 0; b < 2; ++b) {
    w->R[b] = take(9LL * K);
    w->t[b] = take(3LL * K);
    w->X[b] = take(3LL * P);
    w->Xs[b] = take(3LL * L);
    w->Xe[b] = take(3LL * L);
  }
  w->part = take(1LL * NPART * MAX_BLOCKS);
  return n;
}

// -- reductions in a fixed order ---------------------------------------------

// every thread of the block gets the block's sums of v, in the same order
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
    if (lane == 0) sh[warp * N + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = sh[k];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += sh[w * N + k];
    v[k] = s;
  }
  __syncthreads();
}

// the sum of one partial array over the grid's blocks: every warp of every
// block computes it in the same order
__device__ __forceinline__ float grid_total(const float* part) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int i = lane; i < static_cast<int>(gridDim.x); i += 32)
    s += __ldcg(part + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  return __shfl_sync(FULL, s, 0);
}

// the block's sum of each thread's v (thread 0 adds extra after it), then
// written to the block's slot of a partial array
__device__ __forceinline__ void put_partial(float v, float extra, float* part,
                                            float* sh) {
  float s[1] = {v};
  block_sum<1>(s, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s[0] + extra;
}

// -- small dense algebra -----------------------------------------------------

// torch.linalg.inv_ex without the error check: Gauss-Jordan with partial
// pivoting (the first largest |pivot|); a singular A gives inf / NaN
template <int N>
__device__ __forceinline__ void invert(float A[N][N], float B[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) B[i][j] = i == j ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (i == p) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
          s = B[k][j];
          B[k][j] = B[i][j];
          B[i][j] = s;
        }
      }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[k][j] *= inv;
      B[k][j] *= inv;
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i != k) {
        const float f = A[i][k];
#pragma unroll
        for (int j = 0; j < N; ++j) {
          A[i][j] -= f * A[k][j];
          B[i][j] -= f * B[k][j];
        }
      }
  }
}

// from the upper triangle of a symmetric block (row-major, N(N+1)/2
// entries): ld = lam diag + 1e-8, and M = (H + diag(ld) + 1e-8 I)^-1
// (ba.py's damped() then inv())
template <int N>
__device__ __forceinline__ void damp_invert(const float* up, float lam,
                                            float* ld, float* M) {
  float A[N][N], B[N][N];
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) A[i][j] = A[j][i] = up[k++];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ld[i] = lam * A[i][i] + 1e-8f;
    A[i][i] = (A[i][i] + ld[i]) + 1e-8f;
  }
  invert<N>(A, B);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) M[N * i + j] = B[i][j];
}

// acc[upper(i, j)] += sum_r w_r J_ri J_rj and acc[T + i] += sum_r J_ri v_r
// over R rows of width N (T = N(N+1)/2), each row's sum formed first
template <int R, int N>
__device__ __forceinline__ void add_normal(float* acc, const float* J,
                                           const float* w, const float* v) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) s += J[N * r + i] * w[r] * J[N * r + j];
      acc[k++] += s;
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) s += J[N * r + i] * v[r];
    acc[k + i] += s;
  }
}

__device__ __forceinline__ void load(float* dst, const float* src, int n) {
  for (int i = 0; i < n; ++i) dst[i] = __ldcg(src + i);
}

// -- the residual rows -------------------------------------------------------

// ba._point_terms for one row at (R, t, Xw): residual (uR zeroed for a mono
// row), the row weights' stereo flag and the validity; with J, also
// Jc = -(Jrows [I | -hat(Xc)]) and Jp = -(Jrows Rm)
__device__ __forceinline__ void point_row(const Args& a, int m,
                                          const float* R, const float* t,
                                          const float* Xw, float res[3],
                                          bool& stereo, bool& ok,
                                          float* Jc, float* Jp) {
  const Cam& c = a.cam;
  const float* o = a.uvr + 3 * m;
  float X[3], uv[2];
  apply(R, t, Xw, X);
  project(c, X, uv);
  const float z = X[2];
  const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
  const float uR = uv[0] - c.bf / zs;
  stereo = o[2] >= 0.0f;
  res[0] = o[0] - uv[0];
  res[1] = o[1] - uv[1];
  res[2] = stereo ? o[2] - uR : 0.0f;
  ok = a.obs_mask[m] && z > 0.05f;
  if (Jc == nullptr) return;
  float Jr[3][3];
  float Jproj[2][3];
  project_jac(c, X, Jproj);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    Jr[0][j] = Jproj[0][j];
    Jr[1][j] = Jproj[1][j];
  }
  Jr[2][0] = Jproj[0][0] + 0.0f;
  Jr[2][1] = Jproj[0][1] + 0.0f;
  Jr[2][2] = Jproj[0][2] + c.bf / (zs * zs);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float row[6];
    times_dX_dxi(Jr[r], X, row);
#pragma unroll
    for (int j = 0; j < 6; ++j) Jc[6 * r + j] = -row[j];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Jp[3 * r + j] = -(Jr[r][0] * R[j] + Jr[r][1] * R[3 + j]
                        + Jr[r][2] * R[6 + j]);
  }
}

__device__ __forceinline__ float point_chi2(const Args& a, int m,
                                            const float res[3]) {
  return (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]) * a.isig[m];
}

// ba._line_terms for one row at (R, t, Xs, Xe): residual (the endpoints'
// line distances, then their disparity residuals where a depth was
// measured), the depth flags and the validity; with Jc, also the Jacobian
// rows (Jc [4, 6]; Jx the endpoint blocks' nonzero [3]s: Jxs, Jxe, Jxds,
// Jxde)
__device__ __forceinline__ void line_row(const Args& a, int m,
                                         const float* R, const float* t,
                                         const float* Xs, const float* Xe,
                                         float res[4], bool has[2], bool& ok,
                                         float* Jc, float* Jx) {
  const Cam& c = a.cam;
  const float* nld = a.nld + 3 * m;
  const float bf = a.bf_line;
  bool front = true;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float X[3], uv[2];
    apply(R, t, e ? Xe : Xs, X);
    project(c, X, uv);
    res[e] = (nld[0] * uv[0] + nld[1] * uv[1]) + nld[2];
    const float z = X[2];
    const float zs = fabsf(z) < 1e-6f ? 1e-6f : z;
    const float zm = a.ldepth[2 * m + e];
    has[e] = zm > 0.0f;
    res[2 + e] = has[e] ? bf / zm - bf / zs : 0.0f;
    front = front && z > 0.05f;
    if (Jc == nullptr) continue;
    float Jproj[2][3], dr[3];
    project_jac(c, X, Jproj);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dr[j] = nld[0] * Jproj[0][j] + nld[1] * Jproj[1][j];
    const float drd[3] = {0.0f, 0.0f, bf / (zs * zs)};
    times_dX_dxi(dr, X, Jc + 6 * e);
    times_dX_dxi(drd, X, Jc + 6 * (2 + e));
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Jx[3 * e + j] = dr[0] * R[j] + dr[1] * R[3 + j] + dr[2] * R[6 + j];
      Jx[3 * (2 + e) + j] =
          drd[0] * R[j] + drd[1] * R[3 + j] + drd[2] * R[6 + j];
    }
  }
  ok = a.lobs_mask[m] && front;
}

__device__ __forceinline__ float line_chi2(const Args& a, int m,
                                           const float res[4]) {
  return (res[0] * res[0] + res[1] * res[1] + res[2] * res[2]
          + res[3] * res[3]) * a.lisig[m];
}

// -- the solve's phases ------------------------------------------------------

struct State {
  const float *R, *t, *X, *Xs, *Xe;
};

// the cost (ba.py's cost_fn) of `s`, as partial sums of every block
__device__ void cost_phase(const Args& a, const State& s, float* sh) {
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  float cp = 0.0f, nok = 0.0f, cl = 0.0f;
  for (int m = gt; m < a.M; m += gs) {
    const int c = static_cast<int>(a.obs_cam[m]);
    const int p = static_cast<int>(a.obs_pt[m]);
    float R[9], t[3], X[3], res[3];
    load(R, s.R + 9 * c, 9);
    load(t, s.t + 3 * c, 3);
    load(X, s.X + 3 * p, 3);
    bool st, ok;
    point_row(a, m, R, t, X, res, st, ok, nullptr, nullptr);
    const float thr = st ? CHI2_3D : CHI2_2D;
    const float chi2 = point_chi2(a, m, res);
    cp += (chi2 < thr * 2.0f || chi2 != chi2 ? chi2 : thr * 2.0f)
          * (ok ? 1.0f : 0.0f);
    nok += ok ? 1.0f : 0.0f;
  }
  if (a.L > 0)
    for (int m = gt; m < a.Ml; m += gs) {
      const int c = static_cast<int>(a.lobs_cam[m]);
      const int l = static_cast<int>(a.lobs_line[m]);
      float R[9], t[3], Xs[3], Xe[3], res[4];
      load(R, s.R + 9 * c, 9);
      load(t, s.t + 3 * c, 3);
      load(Xs, s.Xs + 3 * l, 3);
      load(Xe, s.Xe + 3 * l, 3);
      bool has[2], ok;
      line_row(a, m, R, t, Xs, Xe, res, has, ok, nullptr, nullptr);
      const float rows =
          2.0f + (has[0] ? 1.0f : 0.0f) + (has[1] ? 1.0f : 0.0f);
      const float thr = rows > 2.5f ? LINE_CHI2_DEPTH : CHI2_2D;
      const float chi2 = line_chi2(a, m, res);
      cl += (chi2 < thr * 2.0f || chi2 != chi2 ? chi2 : thr * 2.0f)
            * (ok ? 1.0f : 0.0f);
    }
  float v[3] = {cp, nok, cl};
  block_sum<3>(v, sh);
  if (threadIdx.x == 0) {
    a.w.part[PART_COST_P * MAX_BLOCKS + blockIdx.x] = v[0];
    a.w.part[PART_NOK * MAX_BLOCKS + blockIdx.x] = v[1];
    a.w.part[PART_COST_L * MAX_BLOCKS + blockIdx.x] = v[2];
  }
}

// after cost_phase and a grid barrier: the cost, inf when no point row is
// valid
__device__ __forceinline__ float cost_total(const Args& a) {
  const float* part = a.w.part;
  float c = grid_total(part + PART_COST_P * MAX_BLOCKS);
  const float n = grid_total(part + PART_NOK * MAX_BLOCKS);
  if (a.L > 0)
    c = c + a.line_weight * grid_total(part + PART_COST_L * MAX_BLOCKS);
  return n > 0.0f ? c : __int_as_float(0x7f800000);
}

// the Jacobian rows, weights and weighted residuals at `s`
__device__ void linearize_phase(const Args& a, const State& s) {
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  for (int m = gt; m < a.M; m += gs) {
    const int c = static_cast<int>(a.obs_cam[m]);
    const int p = static_cast<int>(a.obs_pt[m]);
    float R[9], t[3], X[3], res[3], row[PROW];
    load(R, s.R + 9 * c, 9);
    load(t, s.t + 3 * c, 3);
    load(X, s.X + 3 * p, 3);
    bool st, ok;
    point_row(a, m, R, t, X, res, st, ok, row, row + 18);
    const float rw = huber(point_chi2(a, m, res), st ? CHI2_3D : CHI2_2D);
    const float w = a.isig[m] * rw * (ok ? 1.0f : 0.0f);
    const float wr[3] = {w * 1.0f, w * 1.0f, w * (st ? 1.0f : 0.0f)};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      row[27 + r] = wr[r];
      row[30 + r] = wr[r] * res[r];
    }
    float* dst = a.w.prow + static_cast<long long>(PROW) * m;
#pragma unroll
    for (int i = 0; i < 33; ++i) dst[i] = row[i];
  }
  if (a.L > 0)
    for (int m = gt; m < a.Ml; m += gs) {
      const int c = static_cast<int>(a.lobs_cam[m]);
      const int l = static_cast<int>(a.lobs_line[m]);
      float R[9], t[3], Xs[3], Xe[3], res[4], row[LROW];
      load(R, s.R + 9 * c, 9);
      load(t, s.t + 3 * c, 3);
      load(Xs, s.Xs + 3 * l, 3);
      load(Xe, s.Xe + 3 * l, 3);
      bool has[2], ok;
      line_row(a, m, R, t, Xs, Xe, res, has, ok, row, row + 24);
      const float rw = huber(line_chi2(a, m, res), CHI2_2D);
      const float w = a.line_weight * a.lisig[m] * rw * (ok ? 1.0f : 0.0f);
      const float wr[4] = {w * 1.0f, w * 1.0f, w * (has[0] ? 1.0f : 0.0f),
                           w * (has[1] ? 1.0f : 0.0f)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        row[36 + r] = wr[r];
        row[40 + r] = wr[r] * res[r];
      }
      float* dst = a.w.lrow + static_cast<long long>(LROW) * m;
#pragma unroll
      for (int i = 0; i < LROW; ++i) dst[i] = row[i];
    }
}

__device__ __forceinline__ float free_cam(const Args& a, int c) {
  return (!a.fixed[c] && a.cam_mask[c]) ? 1.0f : 0.0f;
}

// the endpoint block of a line row as a dense [4, 6] Jacobian
__device__ __forceinline__ void line_jl(const float* Jx, float* Jl) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const bool second = j >= 3;
      const bool end = r & 1;  // rows 1 and 3 belong to the end point
      Jl[6 * r + j] = second == end ? Jx[3 * r + (j % 3)] : 0.0f;
    }
}

// b and the damped block-diagonal inverse of every block; the CG's start
// (x = 0, r = b, z = M r, p = 0); the partials of r . z
__device__ void normal_phase(const Args& a, float lam, float* sh) {
  const Work& w = a.w;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  float rz = 0.0f;
  for (int p = gt; p < a.P; p += gs) {
    float acc[9] = {};
    const int j0 = static_cast<int>(a.off[p]);
    const int j1 = static_cast<int>(a.off[p + 1]);
    for (int j = j0; j < j1; ++j) {
      const float* row = w.prow + PROW * a.ord[j];
      float Jp[9], wr[3], v[3];
      load(Jp, row + 18, 9);
      load(wr, row + 27, 3);
      load(v, row + 30, 3);
      add_normal<3, 3>(acc, Jp, wr, v);
    }
    const float mk = a.pt_mask[p] ? 1.0f : 0.0f;
    float M[9], ld[3], r[3];
    damp_invert<3>(acc, lam, ld, M);
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = -acc[6 + i] * mk;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float z = (M[3 * i] * r[0] + M[3 * i + 1] * r[1]
                       + M[3 * i + 2] * r[2]) * mk;
      w.px[3 * p + i] = 0.0f;
      w.pr[3 * p + i] = r[i];
      w.pz[3 * p + i] = z;
      w.pp[3 * p + i] = 0.0f;
      w.pld[3 * p + i] = ld[i];
      rz += r[i] * z;
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) w.pM[9 * p + i] = M[i];
  }
  if (a.L > 0)
    for (int l = gt; l < a.L; l += gs) {
      float acc[27] = {};
      const int base = a.P + a.K;
      const int j0 = static_cast<int>(a.off[base + l]);
      const int j1 = static_cast<int>(a.off[base + l + 1]);
      for (int j = j0; j < j1; ++j) {
        const float* row = w.lrow + LROW * (a.ord[j] - 2LL * a.M);
        float Jx[12], Jl[24], wr[4], v[4];
        load(Jx, row + 24, 12);
        load(wr, row + 36, 4);
        load(v, row + 40, 4);
        line_jl(Jx, Jl);
        add_normal<4, 6>(acc, Jl, wr, v);
      }
      const float mk = a.ln_mask[l] ? 1.0f : 0.0f;
      float M[36], ld[6], r[6];
      damp_invert<6>(acc, lam, ld, M);
#pragma unroll
      for (int i = 0; i < 6; ++i) r[i] = -acc[21 + i] * mk;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float z = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) z += M[6 * i + j] * r[j];
        z *= mk;
        w.lx[6 * l + i] = 0.0f;
        w.lr[6 * l + i] = r[i];
        w.lz[6 * l + i] = z;
        w.lp[6 * l + i] = 0.0f;
        w.lld[6 * l + i] = ld[i];
        rz += r[i] * z;
      }
#pragma unroll
      for (int i = 0; i < 36; ++i) w.lM[36 * l + i] = M[i];
    }
  // cameras: one block each
  float rz_cam = 0.0f;
  for (int c = blockIdx.x; c < a.K; c += gridDim.x) {
    float acc[54] = {};
    const int j0 = static_cast<int>(a.off[a.P + c]);
    const int j1 = static_cast<int>(a.off[a.P + c + 1]);
    for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
      const float* row = w.prow + PROW * (a.ord[j] - a.M);
      float Jc[18], wr[3], v[3];
      load(Jc, row, 18);
      load(wr, row + 27, 3);
      load(v, row + 30, 3);
      add_normal<3, 6>(acc, Jc, wr, v);
    }
    if (a.L > 0) {
      const int base = a.P + a.K + a.L;
      const int k0 = static_cast<int>(a.off[base + c]);
      const int k1 = static_cast<int>(a.off[base + c + 1]);
      for (int j = k0 + threadIdx.x; j < k1; j += THREADS) {
        const float* row = w.lrow + LROW * (a.ord[j] - 2LL * a.M - a.Ml);
        float Jc[24], wr[4], v[4];
        load(Jc, row, 24);
        load(wr, row + 36, 4);
        load(v, row + 40, 4);
        add_normal<4, 6>(acc + 27, Jc, wr, v);
      }
    }
    block_sum<54>(acc, sh);
    if (threadIdx.x == 0) {
      float H[21], M[36], ld[6], r[6];
#pragma unroll
      for (int i = 0; i < 21; ++i) H[i] = acc[i] + acc[27 + i];
      damp_invert<6>(H, lam, ld, M);
      const float f = free_cam(a, c);
#pragma unroll
      for (int i = 0; i < 6; ++i) r[i] = (-acc[21 + i] - acc[48 + i]) * f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float z = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) z += M[6 * i + j] * r[j];
        z *= f;
        w.cx[6 * c + i] = 0.0f;
        w.cr[6 * c + i] = r[i];
        w.cz[6 * c + i] = z;
        w.cp[6 * c + i] = 0.0f;
        w.cld[6 * c + i] = ld[i];
        rz_cam += r[i] * z;
      }
#pragma unroll
      for (int i = 0; i < 36; ++i) w.cM[36 * c + i] = M[i];
    }
  }
  put_partial(rz, rz_cam, w.part + PART_RZ * MAX_BLOCKS, sh);
}

// the camera block c's direction p = z + beta p_old, masked
__device__ __forceinline__ void cam_dir(const Args& a, int c, float beta,
                                        float* x) {
  const float f = free_cam(a, c);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    x[i] = (__ldcg(a.w.cz + 6 * c + i) + beta * __ldcg(a.w.cp + 6 * c + i))
           * f;
}

// the matvec's landmark half: p = z + beta p_old for every point and line,
// their A p, each row's camera product (Jc^T u, into g / lg), and the
// partials of their p . A p
__device__ void matvec_landmarks(const Args& a, float beta, float* sh) {
  const Work& w = a.w;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  float pap = 0.0f;
  for (int p = gt; p < a.P; p += gs) {
    const float mk = a.pt_mask[p] ? 1.0f : 0.0f;
    float pp[3], xp[3], y[3] = {};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pp[i] = __ldcg(w.pz + 3 * p + i) + beta * __ldcg(w.pp + 3 * p + i);
      w.pp[3 * p + i] = pp[i];
      xp[i] = pp[i] * mk;
    }
    const int j0 = static_cast<int>(a.off[p]);
    const int j1 = static_cast<int>(a.off[p + 1]);
    for (int j = j0; j < j1; ++j) {
      const long long m = a.ord[j];
      const float* row = w.prow + PROW * m;
      float Jc[18], Jp[9], wr[3], xc[6], u[3];
      load(Jc, row, 18);
      load(Jp, row + 18, 9);
      load(wr, row + 27, 3);
      cam_dir(a, static_cast<int>(a.obs_cam[m]), beta, xc);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float sc = 0.0f, sp = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k) sc += Jc[6 * r + k] * xc[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) sp += Jp[3 * r + k] * xp[k];
        u[r] = (sc + sp) * wr[r];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        y[i] += Jp[i] * u[0] + Jp[3 + i] * u[1] + Jp[6 + i] * u[2];
#pragma unroll
      for (int i = 0; i < 6; ++i)
        w.g[6 * m + i] = Jc[i] * u[0] + Jc[6 + i] * u[1] + Jc[12 + i] * u[2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ap = (y[i] + __ldcg(w.pld + 3 * p + i) * xp[i]) * mk;
      w.pAp[3 * p + i] = ap;
      pap += pp[i] * ap;
    }
  }
  if (a.L > 0)
    for (int l = gt; l < a.L; l += gs) {
      const float mk = a.ln_mask[l] ? 1.0f : 0.0f;
      float pl[6], xl[6], y[6] = {};
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        pl[i] = __ldcg(w.lz + 6 * l + i) + beta * __ldcg(w.lp + 6 * l + i);
        w.lp[6 * l + i] = pl[i];
        xl[i] = pl[i] * mk;
      }
      const int base = a.P + a.K;
      const int j0 = static_cast<int>(a.off[base + l]);
      const int j1 = static_cast<int>(a.off[base + l + 1]);
      for (int j = j0; j < j1; ++j) {
        const long long m = a.ord[j] - 2LL * a.M;
        const float* row = w.lrow + LROW * m;
        float Jc[24], Jx[12], Jl[24], wr[4], xc[6], u[4];
        load(Jc, row, 24);
        load(Jx, row + 24, 12);
        load(wr, row + 36, 4);
        line_jl(Jx, Jl);
        cam_dir(a, static_cast<int>(a.lobs_cam[m]), beta, xc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float sc = 0.0f, sl = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            sc += Jc[6 * r + k] * xc[k];
            sl += Jl[6 * r + k] * xl[k];
          }
          u[r] = (sc + sl) * wr[r];
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          y[i] += Jl[i] * u[0] + Jl[6 + i] * u[1] + Jl[12 + i] * u[2]
                  + Jl[18 + i] * u[3];
          w.lg[6 * m + i] = Jc[i] * u[0] + Jc[6 + i] * u[1]
                            + Jc[12 + i] * u[2] + Jc[18 + i] * u[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float ap = y[i] + __ldcg(w.lld + 6 * l + i) * xl[i];
        w.lAp[6 * l + i] = ap;
        pap += pl[i] * ap;
      }
    }
  put_partial(pap, 0.0f, w.part + PART_PAP_LM * MAX_BLOCKS, sh);
}

// the matvec's camera half: each camera block sums its rows' products, and
// the partials of the cameras' p . A p
__device__ void matvec_cameras(const Args& a, float beta, float* sh) {
  const Work& w = a.w;
  float pap = 0.0f;
  for (int c = blockIdx.x; c < a.K; c += gridDim.x) {
    float y[12] = {};
    const int j0 = static_cast<int>(a.off[a.P + c]);
    const int j1 = static_cast<int>(a.off[a.P + c + 1]);
    for (int j = j0 + threadIdx.x; j < j1; j += THREADS) {
      const float* g = w.g + 6 * (a.ord[j] - a.M);
#pragma unroll
      for (int i = 0; i < 6; ++i) y[i] += __ldcg(g + i);
    }
    if (a.L > 0) {
      const int base = a.P + a.K + a.L;
      const int k0 = static_cast<int>(a.off[base + c]);
      const int k1 = static_cast<int>(a.off[base + c + 1]);
      for (int j = k0 + threadIdx.x; j < k1; j += THREADS) {
        const float* g = w.lg + 6 * (a.ord[j] - 2LL * a.M - a.Ml);
#pragma unroll
        for (int i = 0; i < 6; ++i) y[6 + i] += __ldcg(g + i);
      }
    }
    block_sum<12>(y, sh);
    if (threadIdx.x == 0) {
      float xc[6];
      const float f = free_cam(a, c);
      cam_dir(a, c, beta, xc);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float pc =
            __ldcg(w.cz + 6 * c + i) + beta * __ldcg(w.cp + 6 * c + i);
        const float ap =
            ((y[i] + y[6 + i]) + __ldcg(w.cld + 6 * c + i) * xc[i]) * f;
        w.cp[6 * c + i] = pc;
        w.cAp[6 * c + i] = ap;
        pap += pc * ap;
      }
    }
  }
  put_partial(0.0f, pap, w.part + PART_PAP_CAM * MAX_BLOCKS, sh);
}

// x += alpha p, r -= alpha A p, z = M r for every block; the partials of
// r . z
template <int N>
__device__ __forceinline__ float cg_update(float* x, float* r, float* z,
                                           const float* p, const float* Ap,
                                           const float* M, float mk,
                                           float alpha) {
  float rn[N], s = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = __ldcg(x + i) + alpha * __ldcg(p + i);
    rn[i] = __ldcg(r + i) - alpha * __ldcg(Ap + i);
    r[i] = rn[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) v += __ldcg(M + N * i + j) * rn[j];
    v *= mk;
    z[i] = v;
    s += rn[i] * v;
  }
  return s;
}

__device__ void update_phase(const Args& a, float alpha, float* sh) {
  const Work& w = a.w;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  float rz = 0.0f;
  for (int e = gt; e < a.K + a.P + a.L; e += gs) {
    if (e < a.K) {
      const int c = e;
      rz += cg_update<6>(w.cx + 6 * c, w.cr + 6 * c, w.cz + 6 * c,
                         w.cp + 6 * c, w.cAp + 6 * c, w.cM + 36 * c,
                         free_cam(a, c), alpha);
    } else if (e < a.K + a.P) {
      const int p = e - a.K;
      rz += cg_update<3>(w.px + 3 * p, w.pr + 3 * p, w.pz + 3 * p,
                         w.pp + 3 * p, w.pAp + 3 * p, w.pM + 9 * p,
                         a.pt_mask[p] ? 1.0f : 0.0f, alpha);
    } else {
      const int l = e - a.K - a.P;
      rz += cg_update<6>(w.lx + 6 * l, w.lr + 6 * l, w.lz + 6 * l,
                         w.lp + 6 * l, w.lAp + 6 * l, w.lM + 36 * l,
                         a.ln_mask[l] ? 1.0f : 0.0f, alpha);
    }
  }
  put_partial(rz, 0.0f, w.part + PART_RZ * MAX_BLOCKS, sh);
}

// the step applied to `s`, into `n`: (R, t) <- normalize(exp(dx) (R, t)),
// points and line endpoints plus their deltas
__device__ void apply_phase(const Args& a, const State& s, int nb) {
  const Work& w = a.w;
  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  for (int e = gt; e < a.K + a.P + a.L; e += gs) {
    if (e < a.K) {
      const int c = e;
      float dx[6], dR[9], dt[3], R[9], t[3], Rn[9], tn[3], q[4];
      load(dx, w.cx + 6 * c, 6);
      load(R, s.R + 9 * c, 9);
      load(t, s.t + 3 * c, 3);
      se3_exp(dx, dR, dt);
      mul3(dR, R, Rn);
      mulv3(dR, t, tn);
      rotmat_to_quat(Rn, q);
      quat_to_rotmat(q, R);
#pragma unroll
      for (int i = 0; i < 9; ++i) w.R[nb][9 * c + i] = R[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) w.t[nb][3 * c + i] = tn[i] + dt[i];
    } else if (e < a.K + a.P) {
      const int p = e - a.K;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        w.X[nb][3 * p + i] =
            __ldcg(s.X + 3 * p + i) + __ldcg(w.px + 3 * p + i);
    } else {
      const int l = e - a.K - a.P;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w.Xs[nb][3 * l + i] =
            __ldcg(s.Xs + 3 * l + i) + __ldcg(w.lx + 6 * l + i);
        w.Xe[nb][3 * l + i] =
            __ldcg(s.Xe + 3 * l + i) + __ldcg(w.lx + 6 * l + 3 + i);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ba_lm_kernel(const Args a) {
  __shared__ float sh[WARPS * 54];
  cg::grid_group grid = cg::this_grid();
  const Work& w = a.w;
  const float* part = w.part;

  State cur = {a.R0, a.t0, a.X0, a.Xs0, a.Xe0};
  int nb = 0;  // the workspace state that the next step is written to
  cost_phase(a, cur, sh);
  grid.sync();
  const float cost0 = cost_total(a);
  float cost = cost0, lam = a.lam0;
  int lm_n = 0, cg_n = 0;
  for (int it = 0; it < a.num_iters; ++it) {
    linearize_phase(a, cur);
    grid.sync();
    normal_phase(a, lam, sh);
    grid.sync();
    float rz = grid_total(part + PART_RZ * MAX_BLOCKS);
    const float rz0 = rz;
    float beta = 0.0f;
    int n_cg = 0;
    for (int k = 0; k < a.cg_iters && rz > 1e-12f * rz0; ++k) {
      matvec_landmarks(a, beta, sh);
      grid.sync();
      matvec_cameras(a, beta, sh);
      grid.sync();
      float pap = grid_total(part + PART_PAP_LM * MAX_BLOCKS)
                  + grid_total(part + PART_PAP_CAM * MAX_BLOCKS);
      const float alpha = rz / (fabsf(pap) < 1e-20f ? 1e-20f : pap);
      update_phase(a, alpha, sh);
      grid.sync();
      const float rz_new = grid_total(part + PART_RZ * MAX_BLOCKS);
      beta = rz_new / (fabsf(rz) < 1e-20f ? 1e-20f : rz);
      rz = rz_new;
      ++n_cg;
    }
    apply_phase(a, cur, nb);
    grid.sync();
    const State next = {w.R[nb], w.t[nb], w.X[nb], w.Xs[nb], w.Xe[nb]};
    cost_phase(a, next, sh);
    grid.sync();
    const float cost_new = cost_total(a);
    const bool accept = cost_new < cost;
    const bool done = accept && (cost - cost_new < 1e-6f * cost);
    if (accept) {
      cur = next;
      nb ^= 1;
      cost = cost_new;
      lam = clamp_min(lam * 0.5f, 1e-7f);
    } else {
      lam = clamp_max(lam * 4.0f, 1e4f);
    }
    ++lm_n;
    cg_n += n_cg;
    if (done) break;
  }

  const int gt = blockIdx.x * THREADS + threadIdx.x;
  const int gs = gridDim.x * THREADS;
  for (int i = gt; i < 9 * a.K; i += gs) a.R_out[i] = __ldcg(cur.R + i);
  for (int i = gt; i < 3 * a.K; i += gs) a.t_out[i] = __ldcg(cur.t + i);
  for (int i = gt; i < 3 * a.P; i += gs) a.X_out[i] = __ldcg(cur.X + i);
  for (int i = gt; i < 3 * a.L; i += gs) {
    a.Xs_out[i] = __ldcg(cur.Xs + i);
    a.Xe_out[i] = __ldcg(cur.Xe + i);
  }
  if (gt == 0) {
    a.info_f[0] = cost0;
    a.info_f[1] = cost;
    a.info_f[2] = lam;
    a.info_i[0] = lm_n;
    a.info_i[1] = cg_n;
    atomicAdd(a.acc, static_cast<unsigned long long>(lm_n));
    atomicAdd(a.acc + 1, static_cast<unsigned long long>(cg_n));
  }
}

int grid_blocks(int K, int work) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(ba_lm_kernel), THREADS, 0);
    resident = sms * (per_sm < 1 ? 1 : per_sm);
    if (resident > sms) resident = sms;  // one block an SM: cheaper barriers
    if (resident > MAX_BLOCKS) resident = MAX_BLOCKS;
    if (resident < 1) resident = 1;
  }
  int want = (work + THREADS - 1) / THREADS;
  if (want < K) want = K;
  if (want < 1) want = 1;
  return want < resident ? want : resident;
}

}  // namespace

// The workspace a solve of these sizes needs, in floats.
extern "C" long long plvs_ba_workspace_floats(int K, int P, int M, int L,
                                              int Ml) {
  Work w;
  return layout(K, P, M, L, Ml, nullptr, &w);
}

// One whole solve, one cooperative launch on `stream`. ptr: NPTR device
// pointers in the order of the enum above (contiguous float32 tensors, bool
// masks, int64 index columns; the line ones unread with L == 0); dims: K,
// P, M, L, Ml, camera kind, LM iterations, CG iterations; fp: the camera's
// 9 parameters, bf, the line rows' bf, lam0, line weight. Returns the
// launch's cudaError_t.
extern "C" int plvs_ba_solve(const unsigned long long* ptr, const int* dims,
                             const float* fp, void* stream) {
  Args a;
  a.cam.kind = dims[5];
  for (int i = 0; i < 9; ++i) a.cam.p[i] = fp[i];
  a.cam.bf = fp[9];
  a.bf_line = fp[10];
  a.lam0 = fp[11];
  a.line_weight = fp[12];
  a.K = dims[0];
  a.P = dims[1];
  a.M = dims[2];
  a.L = dims[3];
  a.Ml = dims[4];
  a.num_iters = dims[6];
  a.cg_iters = dims[7];
  auto f = [&](int i) { return reinterpret_cast<float*>(ptr[i]); };
  auto b = [&](int i) { return reinterpret_cast<const uint8_t*>(ptr[i]); };
  auto l = [&](int i) { return reinterpret_cast<const int64_t*>(ptr[i]); };
  a.R0 = f(P_R0);
  a.t0 = f(P_T0);
  a.fixed = b(P_FIXED);
  a.cam_mask = b(P_CAM_MASK);
  a.X0 = f(P_X0);
  a.pt_mask = b(P_PT_MASK);
  a.obs_cam = l(P_OBS_CAM);
  a.obs_pt = l(P_OBS_PT);
  a.uvr = f(P_UVR);
  a.isig = f(P_ISIG);
  a.obs_mask = b(P_OBS_MASK);
  a.Xs0 = f(P_XS0);
  a.Xe0 = f(P_XE0);
  a.ln_mask = b(P_LN_MASK);
  a.lobs_cam = l(P_LOBS_CAM);
  a.lobs_line = l(P_LOBS_LINE);
  a.nld = f(P_NLD);
  a.lisig = f(P_LISIG);
  a.lobs_mask = b(P_LOBS_MASK);
  a.ldepth = f(P_LDEPTH);
  a.ord = l(P_ORD);
  a.off = l(P_OFF);
  layout(a.K, a.P, a.M, a.L, a.Ml, f(P_WS), &a.w);
  a.R_out = f(P_R_OUT);
  a.t_out = f(P_T_OUT);
  a.X_out = f(P_X_OUT);
  a.Xs_out = f(P_XS_OUT);
  a.Xe_out = f(P_XE_OUT);
  a.info_f = f(P_INFO_F);
  a.info_i = reinterpret_cast<int*>(ptr[P_INFO_I]);
  a.acc = reinterpret_cast<unsigned long long*>(ptr[P_ACC]);
  int work = a.M > a.Ml ? a.M : a.Ml;
  if (a.K + a.P + a.L > work) work = a.K + a.P + a.L;
  const int blocks = grid_blocks(a.K, work);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ba_lm_kernel), dim3(blocks),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream)));
}
