// Device code shared by the port's LM kernels: B1 (track_solve.cu) and B4
// (cam_solve.cu).
//
// Forward-mode dual numbers of a fixed tangent width NW = 6, the small SO(3)
// algebra on them (core/geometry's exp_so3 and log_SO3), the non-laser
// factor rows of the two-frame window [frame 0 | frame 1] (IMU, wheel,
// ground, prior; solve/factors and ops/track_solve.residual), a 30x30
// Cholesky that skips statically frozen dims, its triangular solves, the
// SO(3) wrap, and the Schur reduction of frame 0 that feeds the
// marginalization prior.  Everything here runs inside one thread block.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 30;
constexpr int NW = 6;       // tangent width of the dual numbers
constexpr int R_NL = 37;    // non-laser rows: imu 15, wheel 3, ground 4, prior 15
constexpr float EPS = 1e-8f;
constexpr float PI_F = 3.14159265358979323846f;

// ---------------------------------------------------------------- duals --

struct Dual {
  float v;
  float d[NW];
};

__device__ __forceinline__ Dual cst(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = 0.f;
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] - b.d[j];
  return r;
}
__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = -a.d[j];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * b.v + a.v * b.d[j];
  return r;
}
__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
  const float ib = 1.f / b.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = (a.d[j] - r.v * b.d[j]) * ib;
  return r;
}
__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}
__device__ __forceinline__ Dual operator+(float a, const Dual& b) { return b + a; }
__device__ __forceinline__ Dual operator-(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v - b;
  return r;
}
__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = -b.d[j];
  return r;
}
__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * b;
  return r;
}
__device__ __forceinline__ Dual operator*(float a, const Dual& b) { return b * a; }
__device__ __forceinline__ Dual operator/(const Dual& a, float b) {
  Dual r;
  r.v = a.v / b;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] / b;
  return r;
}
__device__ __forceinline__ Dual operator/(float a, const Dual& b) { return cst(a) / b; }

__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
  const float k = 0.5f / r.v;
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * k;
  return r;
}
__device__ __forceinline__ Dual dsin(const Dual& a) {
  Dual r;
  r.v = sinf(a.v);
  const float k = cosf(a.v);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * k;
  return r;
}
__device__ __forceinline__ Dual dcos(const Dual& a) {
  Dual r;
  r.v = cosf(a.v);
  const float k = -sinf(a.v);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * k;
  return r;
}
__device__ __forceinline__ Dual dasin(const Dual& a) {
  Dual r;
  r.v = asinf(a.v);
  const float k = 1.f / sqrtf(1.f - a.v * a.v);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = a.d[j] * k;
  return r;
}
// atan2(y, x)
__device__ __forceinline__ Dual datan2(const Dual& y, const Dual& x) {
  Dual r;
  r.v = atan2f(y.v, x.v);
  const float k = 1.f / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int j = 0; j < NW; ++j) r.d[j] = (x.v * y.d[j] - y.v * x.d[j]) * k;
  return r;
}
// torch.clamp(a, min=lo): the tangent passes where a >= lo
__device__ __forceinline__ Dual dmax(const Dual& a, float lo) {
  return a.v >= lo ? a : cst(lo);
}
__device__ __forceinline__ Dual dclamp(const Dual& a, float lo, float hi) {
  if (a.v < lo) return cst(lo);
  if (a.v > hi) return cst(hi);
  return a;
}
__device__ __forceinline__ Dual sel(bool c, const Dual& a, const Dual& b) { return c ? a : b; }

// ------------------------------------------------------ small geometry --

struct V3 {
  Dual x, y, z;
};
struct M3 {
  Dual a[3][3];
};
// constant (x-independent) 3x3 and 3-vector
struct F3 {
  float a[3][3];
};

__device__ __forceinline__ V3 v3(const Dual& x, const Dual& y, const Dual& z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 operator+(const V3& a, const V3& b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(const V3& a, const V3& b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 neg(const V3& a) { return v3(-a.x, -a.y, -a.z); }

__device__ __forceinline__ M3 mm(const M3& A, const M3& B) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] + A.a[i][2] * B.a[2][j];
  return C;
}
__device__ __forceinline__ M3 mmf(const M3& A, const F3& B) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] + A.a[i][2] * B.a[2][j];
  return C;
}
__device__ __forceinline__ M3 mt(const M3& A) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C.a[i][j] = A.a[j][i];
  return C;
}
__device__ __forceinline__ V3 mv(const M3& A, const V3& v) {
  return v3(A.a[0][0] * v.x + A.a[0][1] * v.y + A.a[0][2] * v.z,
            A.a[1][0] * v.x + A.a[1][1] * v.y + A.a[1][2] * v.z,
            A.a[2][0] * v.x + A.a[2][1] * v.y + A.a[2][2] * v.z);
}
__device__ __forceinline__ V3 mvf(const M3& A, const float* v) {
  return v3(A.a[0][0] * v[0] + A.a[0][1] * v[1] + A.a[0][2] * v[2],
            A.a[1][0] * v[0] + A.a[1][1] * v[1] + A.a[1][2] * v[2],
            A.a[2][0] * v[0] + A.a[2][1] * v[1] + A.a[2][2] * v[2]);
}

// core/geometry.exp_so3 (Rodrigues, Taylor branch below theta^2 < 1e-8)
__device__ M3 exp_so3(const V3& w) {
  const Dual th2 = w.x * w.x + w.y * w.y + w.z * w.z;
  const Dual th = dsqrt(dmax(th2, EPS * EPS));
  const bool small = th2.v < EPS;
  const Dual a = small ? 1.f - th2 / 6.f : dsin(th) / th;
  const Dual b = small ? 0.5f - th2 / 24.f : (1.f - dcos(th)) / (th * th);
  const Dual dg = 1.f - b * th2;
  M3 R;
  R.a[0][0] = dg + b * w.x * w.x;
  R.a[0][1] = -(a * w.z) + b * w.x * w.y;
  R.a[0][2] = a * w.y + b * w.x * w.z;
  R.a[1][0] = a * w.z + b * w.x * w.y;
  R.a[1][1] = dg + b * w.y * w.y;
  R.a[1][2] = -(a * w.x) + b * w.y * w.z;
  R.a[2][0] = -(a * w.y) + b * w.x * w.z;
  R.a[2][1] = a * w.x + b * w.y * w.z;
  R.a[2][2] = dg + b * w.z * w.z;
  return R;
}

__device__ __forceinline__ Dual ssqrt(const Dual& x) { return dsqrt(dmax(x, EPS)); }

// core/geometry.log_SO3: Shepperd quaternion (largest pivot, first on
// ties), canonical hemisphere, angle = 2 atan2(|qv|, qw)
__device__ V3 log_so3(const M3& R) {
  const Dual &m00 = R.a[0][0], &m01 = R.a[0][1], &m02 = R.a[0][2];
  const Dual &m10 = R.a[1][0], &m11 = R.a[1][1], &m12 = R.a[1][2];
  const Dual &m20 = R.a[2][0], &m21 = R.a[2][1], &m22 = R.a[2][2];
  const Dual tr = m00 + m11 + m22;
  const bool b0 = (tr.v >= m00.v) && (tr.v >= m11.v) && (tr.v >= m22.v);
  const bool b1 = !b0 && (m00.v >= m11.v) && (m00.v >= m22.v);
  const bool b2 = !b0 && !b1 && (m11.v >= m22.v);
  Dual q0, q1, q2, q3;
  if (b0) {
    const Dual s = ssqrt(1.f + tr) * 2.f;
    q0 = 0.25f * s; q1 = (m21 - m12) / s; q2 = (m02 - m20) / s; q3 = (m10 - m01) / s;
  } else if (b1) {
    const Dual s = ssqrt(1.f + m00 - m11 - m22) * 2.f;
    q0 = (m21 - m12) / s; q1 = 0.25f * s; q2 = (m01 + m10) / s; q3 = (m02 + m20) / s;
  } else if (b2) {
    const Dual s = ssqrt(1.f + m11 - m00 - m22) * 2.f;
    q0 = (m02 - m20) / s; q1 = (m01 + m10) / s; q2 = 0.25f * s; q3 = (m12 + m21) / s;
  } else {
    const Dual s = ssqrt(1.f + m22 - m00 - m11) * 2.f;
    q0 = (m10 - m01) / s; q1 = (m02 + m20) / s; q2 = (m12 + m21) / s; q3 = 0.25f * s;
  }
  const Dual qn = dsqrt(dmax(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, EPS * EPS));
  q0 = q0 / qn; q1 = q1 / qn; q2 = q2 / qn; q3 = q3 / qn;
  if (q0.v < 0.f) { q0 = -q0; q1 = -q1; q2 = -q2; q3 = -q3; }
  const Dual sh = dsqrt(dmax(q1 * q1 + q2 * q2 + q3 * q3, EPS * EPS));
  const Dual ang = 2.f * datan2(sh, q0);
  const Dual scale = sh.v < EPS ? cst(2.f) : ang / dmax(sh, EPS);
  return v3(scale * q1, scale * q2, scale * q3);
}

__device__ __forceinline__ Dual safe_norm3(const V3& v) {
  return dsqrt(dmax(v.x * v.x + v.y * v.y + v.z * v.z, EPS * EPS));
}

// ------------------------------------------------------- system inputs --

struct Sys {
  const float* x0;     // (30,)
  const float* free;   // (30,)
  const float* imu_J;  // (15,15)
  const float* imu_sqrtP;
  const float* imu_X;  // (15,)
  const float* prior_J;
  const float* prior_X;
  const float* T_il;   // (4,4)
  const float* T_iw;
  const float* wheel;  // (9,) [log p, log q, diag whitener]
  const float* scal;   // (6,) [Dt, g, ground p info, ground q info, ground weight, prior valid]
  const float* laser;  // (M,11)
};

// state entry k as a dual seeded on columns [c0, c0 + NW)
__device__ __forceinline__ Dual X(const float* x, int k, int c0) {
  Dual r = cst(x[k]);
  const int j = k - c0;
  if (j >= 0 && j < NW) r.d[j] = 1.f;
  return r;
}
__device__ __forceinline__ V3 X3(const float* x, int k, int c0) {
  return v3(X(x, k, c0), X(x, k + 1, c0), X(x, k + 2, c0));
}
__device__ __forceinline__ F3 rot_of(const float* T) {
  F3 R;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R.a[i][j] = T[i * 4 + j];
  return R;
}

// IMU factor (imu_factor.h:75-87) before whitening: the 15 raw rows
__device__ void imu_raw(const Sys& s, const float* x, int c0, Dual* out) {
  const float* J = s.imu_J;
  const float* Xp = s.imu_X;
  Dual dba[3], dbw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dba[k] = X(x, 9 + k, c0) - Xp[9 + k];
    dbw[k] = X(x, 12 + k, c0) - Xp[12 + k];
  }
  Dual alpha[3], beta[3], gamma[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    alpha[i] = cst(Xp[i]);
    beta[i] = cst(Xp[3 + i]);
    gamma[i] = cst(Xp[6 + i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      alpha[i] = alpha[i] + J[i * 15 + 9 + k] * dba[k] + J[i * 15 + 12 + k] * dbw[k];
      beta[i] = beta[i] + J[(3 + i) * 15 + 9 + k] * dba[k] + J[(3 + i) * 15 + 12 + k] * dbw[k];
      gamma[i] = gamma[i] + J[(6 + i) * 15 + 12 + k] * dbw[k];
    }
  }
  const float Dt = s.scal[0], g = s.scal[1];
  const V3 p0 = X3(x, 0, c0), q0 = X3(x, 3, c0), v0 = X3(x, 6, c0);
  const V3 p1 = X3(x, 15, c0), q1 = X3(x, 18, c0), v1 = X3(x, 21, c0);
  const M3 R_iw = exp_so3(neg(q0));
  V3 va = p1 - p0 - v3(v0.x * Dt, v0.y * Dt, v0.z * Dt);
  va.z = va.z + 0.5f * g * Dt * Dt;
  V3 vb = v1 - v0;
  vb.z = vb.z + g * Dt;
  const V3 Ra = mv(R_iw, va), Rb = mv(R_iw, vb);
  const M3 Rg = mm(exp_so3(v3(-gamma[0], -gamma[1], -gamma[2])), mm(R_iw, exp_so3(q1)));
  const V3 rg = log_so3(Rg);
  out[0] = alpha[0] - Ra.x; out[1] = alpha[1] - Ra.y; out[2] = alpha[2] - Ra.z;
  out[3] = beta[0] - Rb.x; out[4] = beta[1] - Rb.y; out[5] = beta[2] - Rb.z;
  out[6] = rg.x; out[7] = rg.y; out[8] = rg.z;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[9 + k] = X(x, 24 + k, c0) - X(x, 9 + k, c0);
}

// wheel factor (wheel_factor.h:39-70): 3 whitened rows
__device__ void wheel_rows(const Sys& s, const float* x, int c0, Dual* out) {
  const F3 Rw = rot_of(s.T_iw);
  const float pw[3] = {s.T_iw[3], s.T_iw[7], s.T_iw[11]};
  const V3 p0 = X3(x, 0, c0), q0 = X3(x, 3, c0);
  const V3 p1 = X3(x, 15, c0), q1 = X3(x, 18, c0);
  const M3 R0 = exp_so3(q0), R1 = exp_so3(q1);
  const M3 RiT = mt(mmf(R0, Rw));
  const M3 rel_R = mm(RiT, mmf(R1, Rw));
  const V3 rel_p = mv(RiT, mvf(R1, pw) + p1 - mvf(R0, pw) - p0);
  const V3 q_rel = log_so3(rel_R);
  const float* w = s.wheel;
  const float op0 = w[0], op1 = w[1];
  const float o_len = sqrtf(op0 * op0 + op1 * op1 + EPS);
  const float on = sqrtf(fmaxf(op0 * op0 + op1 * op1, EPS * EPS));
  const float ou0 = op0 / on, ou1 = op1 / on;
  const Dual l2 = rel_p.x * rel_p.x + rel_p.y * rel_p.y;
  const Dual length = dsqrt(l2 + EPS);
  const Dual nn = dsqrt(dmax(l2, EPS * EPS));
  const bool both = (on > 1e-4f) && (nn.v > 1e-4f);
  const Dual nu0 = rel_p.x / nn, nu1 = rel_p.y / nn;
  const Dual crz = ou0 * nu1 - ou1 * nu0;  // cross(o_u, n_u): x, y parts are 0
  const Dual sinn = dsqrt(dmax(crz * crz, EPS * EPS));
  const Dual angle = both ? dasin(dclamp(sinn, 0.f, 1.f - 1e-6f)) : nn;
  const Dual r0 = (length.v < 1e-4f || o_len < 1e-4f) ? length : o_len - length;
  const Dual qn = safe_norm3(q_rel);
  const float oqn = sqrtf(fmaxf(w[3] * w[3] + w[4] * w[4] + w[5] * w[5], EPS * EPS));
  const Dual r2 = (qn.v < 1e-3f || oqn < 1e-3f) ? qn : oqn - qn;
  out[0] = w[6] * r0;
  out[1] = w[7] * angle;
  out[2] = w[8] * r2;
}

// ground factors (ground_factor.h:25-89) of frame f: 2 rows
__device__ void ground_rows(const Sys& s, const float* x, int f, Dual* out) {
  const int c0 = 15 * f;
  const F3 Rw = rot_of(s.T_iw);
  const float pw[3] = {s.T_iw[3], s.T_iw[7], s.T_iw[11]};
  const V3 p = X3(x, c0, c0), q = X3(x, c0 + 3, c0);
  const M3 R = exp_so3(q);
  const Dual z = mvf(R, pw).z + p.z;
  const M3 To = mmf(R, Rw);
  const Dual sg = dsqrt(dmax(To.a[0][2] * To.a[0][2] + To.a[1][2] * To.a[1][2], EPS * EPS));
  const Dual ang = dasin(dclamp(sg, 0.f, 1.f - 1e-6f));
  const float gw = s.scal[4];
  out[0] = s.scal[2] * z * gw;
  out[1] = s.scal[3] * ang * gw;
}

// The non-laser rows of the two-frame window at xs: IMU 0-14 (threads 0-4,
// one window of NW columns each), wheel 15-17 (threads 5-6), ground 18-21
// (threads 7-8), prior 22-36 (threads 9-23).  Rows' Jacobians go to Jnl,
// which the caller zeroes first; values to rnl.  Threads >= 24 do nothing.
__device__ void base_rows(const Sys& s, const float* xs, int tid, float (*Jnl)[D], float* rnl) {
  if (tid < 5) {
    const int c0 = NW * tid;
    Dual raw[15];
    imu_raw(s, xs, c0, raw);
    const float* W = s.imu_sqrtP;
    for (int i = 0; i < 15; ++i) {
      float acc[NW] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float val = 0.f;
      for (int k = 0; k < 15; ++k) {
        const float wik = W[i * 15 + k];
        val += wik * raw[k].v;
#pragma unroll
        for (int j = 0; j < NW; ++j) acc[j] += wik * raw[k].d[j];
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) Jnl[i][c0 + j] = acc[j];
      if (tid == 0) rnl[i] = val;
    }
  } else if (tid < 7) {
    const int c0 = tid == 5 ? 0 : 15;
    Dual r[3];
    wheel_rows(s, xs, c0, r);
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < NW; ++j) Jnl[15 + i][c0 + j] = r[i].d[j];
      if (tid == 5) rnl[15 + i] = r[i].v;
    }
  } else if (tid < 9) {
    const int f = tid - 7;
    Dual r[2];
    ground_rows(s, xs, f, r);
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < NW; ++j) Jnl[18 + 2 * f + i][15 * f + j] = r[i].d[j];
      rnl[18 + 2 * f + i] = r[i].v;
    }
  } else if (tid < 24) {
    const int i = tid - 9;
    const float pv = s.scal[5];
    float val = 0.f;
    for (int k = 0; k < 15; ++k) {
      const float a = s.prior_J[i * 15 + k];
      val += a * (xs[k] - s.prior_X[k]);
      Jnl[22 + i][k] = a * pv;
    }
    rnl[22 + i] = val * pv;
  }
}

// in-place lower Cholesky of A (n x n, row stride D) that skips the dims in
// the bit mask `skip` (their rows/cols must be identity): pivot
// sqrt(max(A_kk, 1e-20)), L_kk = A_kk / pivot (liwslam _cholesky)
__device__ void cholesky(float (*A)[D], int n, uint32_t skip) {
  for (int k = 0; k < n; ++k) {
    if (skip >> k & 1u) {
      for (int i = k; i < n; ++i) A[i][k] = (i == k) ? 1.f : 0.f;
      continue;
    }
    const float piv = sqrtf(fmaxf(A[k][k], 1e-20f));
    for (int i = k; i < n; ++i) A[i][k] = A[i][k] / piv;
    for (int i = k + 1; i < n; ++i) {
      const float lik = A[i][k];
      for (int j = k + 1; j <= i; ++j) A[i][j] -= lik * A[j][k];
    }
  }
}
// L y = b, then L^T x = y, in place in b (skip dims stay 0)
__device__ void chol_solve(float (*L)[D], int n, uint32_t skip, float* b) {
  for (int k = 0; k < n; ++k) {
    if (skip >> k & 1u) { b[k] = 0.f; continue; }
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += L[k][j] * b[j];
    b[k] = (b[k] - acc) / L[k][k];
  }
  for (int k = n - 1; k >= 0; --k) {
    if (skip >> k & 1u) { b[k] = 0.f; continue; }
    float acc = 0.f;
    for (int j = k + 1; j < n; ++j) acc += L[j][k] * b[j];
    b[k] = (b[k] - acc) / L[k][k];
  }
}

__device__ float so3_wrap_scale(const float* w) {
  const float th = sqrtf(fmaxf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], EPS * EPS));
  const float two_pi = 2.f * PI_F;
  const float wrapped = th - two_pi * floorf((th + PI_F) / two_pi);
  return th > PI_F ? wrapped / th : 1.f;
}

// Schur reduction of frame 0 out of the normal equations (H, g) of the
// 30-dim window (gn.marginalize, keep = 15): Hmm + 1e-8 I, equilibrated
// 15x15 Cholesky (in A), symmetrised dH (15x15) and dg (15,).  One thread.
__device__ void schur_frame0(float (*H)[D], const float* g, float (*A)[D], float* dH, float* dgo) {
  float sc[15];
  for (int i = 0; i < 15; ++i) {
    for (int j = 0; j < 15; ++j) A[i][j] = H[i][j] + (i == j ? 1e-8f : 0.f);
  }
  for (int i = 0; i < 15; ++i) sc[i] = 1.f / sqrtf(fmaxf(A[i][i], 1e-20f));
  for (int i = 0; i < 15; ++i)
    for (int j = 0; j <= i; ++j) A[i][j] *= sc[i] * sc[j];
  cholesky(A, 15, 0u);
  // sol[:, c] for c < 15: Hmm^-1 H[0:15, 15 + c]; column 15: Hmm^-1 g[0:15]
  float sol[15][16];
  for (int c = 0; c < 16; ++c) {
    float rhs[D];
    for (int i = 0; i < 15; ++i) rhs[i] = sc[i] * (c < 15 ? H[i][15 + c] : g[i]);
    chol_solve(A, 15, 0u, rhs);
    for (int i = 0; i < 15; ++i) sol[i][c] = sc[i] * rhs[i];
  }
  float dHt[15][15];
  for (int i = 0; i < 15; ++i) {
    for (int j = 0; j < 15; ++j) {
      float acc = 0.f;
      for (int k = 0; k < 15; ++k) acc += H[15 + i][k] * sol[k][j];
      dHt[i][j] = H[15 + i][15 + j] - acc;
    }
    float acc = 0.f;
    for (int k = 0; k < 15; ++k) acc += H[15 + i][k] * sol[k][15];
    dgo[i] = g[15 + i] - acc;
  }
  for (int i = 0; i < 15; ++i)
    for (int j = 0; j < 15; ++j) dH[i * 15 + j] = 0.5f * (dHt[i][j] + dHt[j][i]);
}

}  // namespace
