// Device helpers shared by the solver kernels (pose_opt.cu, ba_lm.cu): the
// camera models of plvs_tpu_torch/geometry/cameras.py, the Huber weight of
// solvers/robust.py and the SE3 maps of geometry/lie.py, each written to
// give the plain PyTorch version's float32 arithmetic operation for
// operation where that costs nothing.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float CHI2_2D = 5.991f;    // solvers/robust.py
constexpr float CHI2_3D = 7.815f;
constexpr float LIE_EPS = 1e-6f;     // geometry/lie.py's small-angle switch

struct Cam {
  int kind;     // 0 PINHOLE (fx fy cx cy k1 k2 p1 p2 k3), 1 KANNALA_BRANDT8
  float p[9];   // (fx fy cx cy k1 k2 k3 k4)
  float bf;
};

// torch.where(|x| < eps, eps, x)
__device__ __forceinline__ float nz(float x, float eps) {
  return fabsf(x) < eps ? eps : x;
}

// torch.clamp: a NaN stays NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// robust.huber_weight
__device__ __forceinline__ float huber(float chi2, float delta2) {
  return clamp_max(sqrtf(delta2 / clamp_min(chi2, 1e-12f)), 1.0f);
}

// q = R p + t
__device__ __forceinline__ void apply(const float* R, const float* t,
                                      const float* p, float* q) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    q[i] = R[3 * i] * p[0] + R[3 * i + 1] * p[1] + R[3 * i + 2] * p[2] + t[i];
}

// C = A B, 3x3 row-major
__device__ __forceinline__ void mul3(const float* A, const float* B,
                                     float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                     + A[3 * i + 2] * B[6 + j];
}

// y = A x, 3x3 row-major
__device__ __forceinline__ void mulv3(const float* A, const float* x,
                                      float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// cameras.project: pixels of a camera-frame point
__device__ __forceinline__ void project(const Cam& c, const float* X,
                                        float* uv) {
  if (c.kind == 0) {
    const float k1 = c.p[4], k2 = c.p[5], p1 = c.p[6], p2 = c.p[7],
                k3 = c.p[8];
    const float inv_z = 1.0f / nz(X[2], 1e-9f);
    const float x = X[0] * inv_z, y = X[1] * inv_z;
    const float r2 = x * x + y * y;
    const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
    const float xd = x * radial + 2.0f * p1 * x * y + p2 * (r2 + 2.0f * x * x);
    const float yd = y * radial + p1 * (r2 + 2.0f * y * y) + 2.0f * p2 * x * y;
    uv[0] = c.p[0] * xd + c.p[2];
    uv[1] = c.p[1] * yd + c.p[3];
    return;
  }
  const float k1 = c.p[4], k2 = c.p[5], k3 = c.p[6], k4 = c.p[7];
  const float x = X[0], y = X[1], z = X[2];
  const float r = sqrtf(x * x + y * y);
  const float th = atan2f(r, z);
  const float t2 = th * th;
  const float th_d = th * (1.0f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
  const bool small = r < 1e-9f;
  const float inv_r = 1.0f / (small ? 1e-9f : r);
  const float s = small ? 1.0f / nz(z, 1e-9f) : th_d * inv_r;
  uv[0] = c.p[0] * x * s + c.p[2];
  uv[1] = c.p[1] * y * s + c.p[3];
}

// cameras.project_jac: d(pixel)/d(Xc), distortion-free for PINHOLE
__device__ __forceinline__ void project_jac(const Cam& c, const float* X,
                                            float J[2][3]) {
  const float x = X[0], y = X[1], z = X[2];
  const float fx = c.p[0], fy = c.p[1];
  if (c.kind == 0) {
    const float inv_z = 1.0f / nz(z, 1e-9f);
    const float inv_z2 = inv_z * inv_z;
    J[0][0] = fx * inv_z;
    J[0][1] = 0.0f;
    J[0][2] = -fx * x * inv_z2;
    J[1][0] = 0.0f;
    J[1][1] = fy * inv_z;
    J[1][2] = -fy * y * inv_z2;
    return;
  }
  const float k1 = c.p[4], k2 = c.p[5], k3 = c.p[6], k4 = c.p[7];
  const float r2 = x * x + y * y;
  const float r = sqrtf(r2);
  const float rs = r < 1e-9f ? 1e-9f : r;
  const float norm2 = r2 + z * z;
  const float th = atan2f(r, z);
  const float t2 = th * th;
  const float th_d = th * (1.0f + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))));
  const float d_thd = 1.0f + t2 * (3.0f * k1 + t2 * (5.0f * k2 + t2 * (
      7.0f * k3 + 9.0f * k4 * t2)));
  const float dth_dx = x * z / (norm2 * rs);
  const float dth_dy = y * z / (norm2 * rs);
  const float dth_dz = -r / norm2;
  const float s = th_d / rs;
  const float ds_dth = d_thd / rs;
  const float ds_dx = ds_dth * dth_dx + (-th_d / (rs * rs)) * (x / rs);
  const float ds_dy = ds_dth * dth_dy + (-th_d / (rs * rs)) * (y / rs);
  const float ds_dz = ds_dth * dth_dz;
  J[0][0] = fx * (s + x * ds_dx);
  J[0][1] = fx * x * ds_dy;
  J[0][2] = fx * x * ds_dz;
  J[1][0] = fy * y * ds_dx;
  J[1][1] = fy * (s + y * ds_dy);
  J[1][2] = fy * y * ds_dz;
}

// out = a [I | -hat(X)] (pose_opt._dX_dxi for the left update), the zero
// entries multiplied as in the plain matrix product
__device__ __forceinline__ void times_dX_dxi(const float* a, const float* X,
                                             float* out) {
  const float x = X[0], y = X[1], z = X[2];
  const float JX[3][6] = {{1.0f, 0.0f, 0.0f, -0.0f, z, -y},
                          {0.0f, 1.0f, 0.0f, -z, -0.0f, x},
                          {0.0f, 0.0f, 1.0f, y, -x, -0.0f}};
#pragma unroll
  for (int j = 0; j < 6; ++j)
    out[j] = a[0] * JX[0][j] + a[1] * JX[1][j] + a[2] * JX[2][j];
}

// -- geometry/lie.py --------------------------------------------------------

__device__ __forceinline__ float safe_norm3(const float* v) {
  return sqrtf(clamp_min(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-24f));
}

__device__ __forceinline__ void hat(const float* w, float* W) {
  W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

__device__ __forceinline__ float sinc(float x) {
  const bool small = fabsf(x) < LIE_EPS;
  const float s = small ? 1.0f : x;
  return small ? 1.0f - x * x / 6.0f : sinf(s) / s;
}

__device__ __forceinline__ float cosc(float x) {
  const bool small = fabsf(x) < LIE_EPS;
  const float s2 = small ? 1.0f : x * x;
  return small ? 0.5f - x * x / 24.0f : (1.0f - cosf(small ? 1.0f : x)) / s2;
}

__device__ __forceinline__ float sin3(float x) {
  const bool small = fabsf(x) < LIE_EPS;
  const float xs = small ? 1.0f : x;
  const float s3 = small ? 1.0f : x * x * x;
  return small ? 1.0f / 6.0f - x * x / 120.0f : (xs - sinf(xs)) / s3;
}

// out = I + a W + b W2
__device__ __forceinline__ void eye_plus(float a, const float* W, float b,
                                         const float* W2, float* out) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    out[i] = ((i % 4 == 0) ? 1.0f : 0.0f) + a * W[i] + b * W2[i];
}

// se3_exp: (rho, theta) -> (R, t)
__device__ __forceinline__ void se3_exp(const float* xi, float* R, float* t) {
  float W[9], W2[9], Jl[9];
  const float th = safe_norm3(xi + 3);
  hat(xi + 3, W);
  mul3(W, W, W2);
  eye_plus(sinc(th), W, cosc(th), W2, R);
  eye_plus(cosc(th), W, sin3(th), W2, Jl);
  mulv3(Jl, xi, t);
}

// rotmat_to_quat: (w, x, y, z), w >= 0, by the largest pivot
__device__ __forceinline__ void rotmat_to_quat(const float* m, float* q) {
  const float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4],
              m12 = m[5], m20 = m[6], m21 = m[7], m22 = m[8];
  const float tr = m00 + m11 + m22;
  const float c[4] = {1.0f + tr, 1.0f + m00 - m11 - m22,
                      1.0f - m00 + m11 - m22, 1.0f - m00 - m11 + m22};
  // torch.argmax: the first largest, a NaN counting as the largest
  int idx = 0;
  float best = c[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (c[i] > best || (c[i] != c[i] && best == best)) {
      idx = i;
      best = c[i];
    }
  float a, b, cc, d;
  if (idx == 0) {
    a = c[0]; b = m21 - m12; cc = m02 - m20; d = m10 - m01;
  } else if (idx == 1) {
    a = m21 - m12; b = c[1]; cc = m01 + m10; d = m02 + m20;
  } else if (idx == 2) {
    a = m02 - m20; b = m01 + m10; cc = c[2]; d = m12 + m21;
  } else {
    a = m10 - m01; b = m02 + m20; cc = m12 + m21; d = c[3];
  }
  const float n = sqrtf(a * a + b * b + cc * cc + d * d);
  a /= n; b /= n; cc /= n; d /= n;
  const float sg = a < 0.0f ? -1.0f : 1.0f;
  q[0] = a * sg; q[1] = b * sg; q[2] = cc * sg; q[3] = d * sg;
}

__device__ __forceinline__ void quat_to_rotmat(const float* q0, float* R) {
  const float n = sqrtf(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2]
                        + q0[3] * q0[3]);
  const float w = q0[0] / n, x = q0[1] / n, y = q0[2] / n, z = q0[3] / n;
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - z * w);
  R[2] = 2.0f * (x * z + y * w);
  R[3] = 2.0f * (x * y + z * w);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - x * w);
  R[6] = 2.0f * (x * z - y * w);
  R[7] = 2.0f * (y * z + x * w);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

}  // namespace
