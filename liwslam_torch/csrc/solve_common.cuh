// Device code shared by the port's LM kernels: B1 (track_solve.cu) and B4
// (cam_solve.cu).
//
// Forward-mode dual numbers of a tangent width W (a template argument), the
// small SO(3) algebra on them (core/geometry's exp_so3 and log_SO3), the non-laser
// factor rows of the two-frame window [frame 0 | frame 1] (IMU, wheel,
// ground, prior; solve/factors and ops/track_solve.residual) with one
// factor kind a warp, the warp-parallel Cholesky in registers (it skips
// statically frozen dims) with its triangular solves, the SO(3) wrap, and
// the Schur reduction of frame 0 that feeds the marginalization prior.
// Everything here runs inside one thread block of THREADS threads.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 30;
constexpr int R_NL = 37;    // non-laser rows: imu 15, wheel 3, ground 4, prior 15
constexpr float EPS = 1e-8f;
constexpr float PI_F = 3.14159265358979323846f;

// ---------------------------------------------------------------- duals --

// A forward-mode dual number with W tangents.  W is a template argument:
// the base rows run W = 1 (one tangent column a lane), the laser and
// camera rows W = 3 (p, q or a landmark a pass).  A narrow dual keeps
// fewer registers live and less code on each lane's chain, and the block
// has lanes to spare for more passes.  Each tangent is computed on its
// own, so a column's derivative does not depend on W.
template <int W>
struct DualT {
  float v;
  float d[W];
};

template <int W>
__device__ __forceinline__ DualT<W> cst(float v) {
  DualT<W> r;
  r.v = v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = 0.f;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator+(const DualT<W>& a, const DualT<W>& b) {
  DualT<W> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] + b.d[j];
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator-(const DualT<W>& a, const DualT<W>& b) {
  DualT<W> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] - b.d[j];
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator-(const DualT<W>& a) {
  DualT<W> r;
  r.v = -a.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = -a.d[j];
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator*(const DualT<W>& a, const DualT<W>& b) {
  DualT<W> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * b.v + a.v * b.d[j];
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator/(const DualT<W>& a, const DualT<W>& b) {
  DualT<W> r;
  r.v = a.v / b.v;
  const float ib = 1.f / b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = (a.d[j] - r.v * b.d[j]) * ib;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator+(const DualT<W>& a, float b) {
  DualT<W> r = a;
  r.v = a.v + b;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator+(float a, const DualT<W>& b) {
  return b + a;
}
template <int W>
__device__ __forceinline__ DualT<W> operator-(const DualT<W>& a, float b) {
  DualT<W> r = a;
  r.v = a.v - b;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator-(float a, const DualT<W>& b) {
  DualT<W> r;
  r.v = a - b.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = -b.d[j];
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator*(const DualT<W>& a, float b) {
  DualT<W> r;
  r.v = a.v * b;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * b;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator*(float a, const DualT<W>& b) {
  return b * a;
}
template <int W>
__device__ __forceinline__ DualT<W> operator/(const DualT<W>& a, float b) {
  DualT<W> r;
  r.v = a.v / b;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] / b;
  return r;
}
template <int W>
__device__ __forceinline__ DualT<W> operator/(float a, const DualT<W>& b) {
  return cst<W>(a) / b;
}

template <int W>
__device__ __forceinline__ DualT<W> dsqrt(const DualT<W>& a) {
  DualT<W> r;
  r.v = sqrtf(a.v);
  const float k = 0.5f / r.v;
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * k;
  return r;
}
// sin(a) and cos(a) from one sincosf (the same values as sinf and cosf)
template <int W>
__device__ __forceinline__ void dsincos(const DualT<W>& a, DualT<W>& s, DualT<W>& c) {
  float sv, cv;
  sincosf(a.v, &sv, &cv);
  s.v = sv;
  c.v = cv;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    s.d[j] = a.d[j] * cv;
    c.d[j] = a.d[j] * -sv;
  }
}
template <int W>
__device__ __forceinline__ DualT<W> dasin(const DualT<W>& a) {
  DualT<W> r;
  r.v = asinf(a.v);
  const float k = 1.f / sqrtf(1.f - a.v * a.v);
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = a.d[j] * k;
  return r;
}
// atan2(y, x)
template <int W>
__device__ __forceinline__ DualT<W> datan2(const DualT<W>& y, const DualT<W>& x) {
  DualT<W> r;
  r.v = atan2f(y.v, x.v);
  const float k = 1.f / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int j = 0; j < W; ++j) r.d[j] = (x.v * y.d[j] - y.v * x.d[j]) * k;
  return r;
}
// torch.clamp(a, min=lo): the tangent passes where a >= lo
template <int W>
__device__ __forceinline__ DualT<W> dmax(const DualT<W>& a, float lo) {
  return a.v >= lo ? a : cst<W>(lo);
}
template <int W>
__device__ __forceinline__ DualT<W> dclamp(const DualT<W>& a, float lo, float hi) {
  if (a.v < lo) return cst<W>(lo);
  if (a.v > hi) return cst<W>(hi);
  return a;
}

// ------------------------------------------------------ small geometry --

template <int W>
struct V3 {
  DualT<W> x, y, z;
};
template <int W>
struct M3 {
  DualT<W> a[3][3];
};
// constant (x-independent) 3x3 and 3-vector
struct F3 {
  float a[3][3];
};

template <int W>
__device__ __forceinline__ V3<W> v3(const DualT<W>& x, const DualT<W>& y, const DualT<W>& z) {
  V3<W> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
template <int W>
__device__ __forceinline__ V3<W> operator+(const V3<W>& a, const V3<W>& b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
template <int W>
__device__ __forceinline__ V3<W> operator-(const V3<W>& a, const V3<W>& b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <int W>
__device__ __forceinline__ V3<W> neg(const V3<W>& a) {
  return v3(-a.x, -a.y, -a.z);
}

template <int W>
__device__ __forceinline__ M3<W> mm(const M3<W>& A, const M3<W>& B) {
  M3<W> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] + A.a[i][2] * B.a[2][j];
  return C;
}
template <int W>
__device__ __forceinline__ M3<W> mmf(const M3<W>& A, const F3& B) {
  M3<W> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] + A.a[i][2] * B.a[2][j];
  return C;
}
template <int W>
__device__ __forceinline__ M3<W> mt(const M3<W>& A) {
  M3<W> C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C.a[i][j] = A.a[j][i];
  return C;
}
template <int W>
__device__ __forceinline__ V3<W> mv(const M3<W>& A, const V3<W>& v) {
  return v3(A.a[0][0] * v.x + A.a[0][1] * v.y + A.a[0][2] * v.z,
            A.a[1][0] * v.x + A.a[1][1] * v.y + A.a[1][2] * v.z,
            A.a[2][0] * v.x + A.a[2][1] * v.y + A.a[2][2] * v.z);
}
template <int W>
__device__ __forceinline__ V3<W> mvf(const M3<W>& A, const float* v) {
  return v3(A.a[0][0] * v[0] + A.a[0][1] * v[1] + A.a[0][2] * v[2],
            A.a[1][0] * v[0] + A.a[1][1] * v[1] + A.a[1][2] * v[2],
            A.a[2][0] * v[0] + A.a[2][1] * v[1] + A.a[2][2] * v[2]);
}

// core/geometry.exp_so3 (Rodrigues, Taylor branch below theta^2 < 1e-8).
// exp_so3 and log_so3 are not inlined: one copy of each serves every
// factor of a width, so the instruction cache holds it across callers.
template <int W>
__device__ __noinline__ M3<W> exp_so3(const V3<W>& w) {
  const DualT<W> th2 = w.x * w.x + w.y * w.y + w.z * w.z;
  const DualT<W> th = dsqrt(dmax(th2, EPS * EPS));
  const bool small = th2.v < EPS;
  DualT<W> sn, cs;
  dsincos(th, sn, cs);
  const DualT<W> a = small ? 1.f - th2 / 6.f : sn / th;
  const DualT<W> b = small ? 0.5f - th2 / 24.f : (1.f - cs) / (th * th);
  const DualT<W> dg = 1.f - b * th2;
  M3<W> R;
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

template <int W>
__device__ __forceinline__ DualT<W> ssqrt(const DualT<W>& x) {
  return dsqrt(dmax(x, EPS));
}

// core/geometry.log_SO3: Shepperd quaternion (largest pivot, first on
// ties), canonical hemisphere, angle = 2 atan2(|qv|, qw).  The four pivot
// cases are one code path: the case picks the operands (the same
// expressions as case by case), so the divisions are written once.
template <int W>
__device__ __noinline__ V3<W> log_so3(const M3<W>& R) {
  using Dual = DualT<W>;
  const Dual &m00 = R.a[0][0], &m01 = R.a[0][1], &m02 = R.a[0][2];
  const Dual &m10 = R.a[1][0], &m11 = R.a[1][1], &m12 = R.a[1][2];
  const Dual &m20 = R.a[2][0], &m21 = R.a[2][1], &m22 = R.a[2][2];
  const Dual tr = m00 + m11 + m22;
  const bool b0 = (tr.v >= m00.v) && (tr.v >= m11.v) && (tr.v >= m22.v);
  const bool b1 = !b0 && (m00.v >= m11.v) && (m00.v >= m22.v);
  const bool b2 = !b0 && !b1 && (m11.v >= m22.v);
  const int p = b0 ? 0 : (b1 ? 1 : (b2 ? 2 : 3));  // the quaternion entry that pivots
  const Dual t = p == 0 ? 1.f + tr
                        : (p == 1 ? 1.f + m00 - m11 - m22
                                  : (p == 2 ? 1.f + m11 - m00 - m22 : 1.f + m22 - m00 - m11));
  const Dual s = ssqrt(t) * 2.f;
  const Dual A = m21 - m12, B = m02 - m20, C = m10 - m01;
  const Dual P = m01 + m10, Q = m02 + m20, S = m12 + m21;
  // numerators of the entries that do not pivot, row p of
  // [[-, A, B, C], [A, -, P, Q], [B, P, -, S], [C, Q, S, -]]
  const Dual n0 = p == 1 ? A : (p == 2 ? B : C);
  const Dual n1 = p == 0 ? A : (p == 2 ? P : Q);
  const Dual n2 = p == 0 ? B : (p == 1 ? P : S);
  const Dual n3 = p == 0 ? C : (p == 1 ? Q : S);
  const Dual piv = 0.25f * s;
  Dual q0 = p == 0 ? piv : n0 / s;
  Dual q1 = p == 1 ? piv : n1 / s;
  Dual q2 = p == 2 ? piv : n2 / s;
  Dual q3 = p == 3 ? piv : n3 / s;
  const Dual qn = dsqrt(dmax(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3, EPS * EPS));
  q0 = q0 / qn; q1 = q1 / qn; q2 = q2 / qn; q3 = q3 / qn;
  if (q0.v < 0.f) { q0 = -q0; q1 = -q1; q2 = -q2; q3 = -q3; }
  const Dual sh = dsqrt(dmax(q1 * q1 + q2 * q2 + q3 * q3, EPS * EPS));
  const Dual ang = 2.f * datan2(sh, q0);
  const Dual scale = sh.v < EPS ? cst<W>(2.f) : ang / dmax(sh, EPS);
  return v3(scale * q1, scale * q2, scale * q3);
}

template <int W>
__device__ __forceinline__ DualT<W> safe_norm3(const V3<W>& v) {
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

// state entry k as a dual seeded on columns [c0, c0 + W)
template <int W>
__device__ __forceinline__ DualT<W> X(const float* x, int k, int c0) {
  DualT<W> r = cst<W>(x[k]);
  const int j = k - c0;
#pragma unroll
  for (int t = 0; t < W; ++t) r.d[t] = t == j ? 1.f : 0.f;
  return r;
}
template <int W>
__device__ __forceinline__ V3<W> X3(const float* x, int k, int c0) {
  return v3(X<W>(x, k, c0), X<W>(x, k + 1, c0), X<W>(x, k + 2, c0));
}
__device__ __forceinline__ F3 rot_of(const float* T) {
  F3 R;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R.a[i][j] = T[i * 4 + j];
  return R;
}

// IMU factor (imu_factor.h:75-87) before whitening, in two parts that run
// on two warps, so that fewer dual-number matrices are live in one
// thread.  Rows 0-5 (alpha, beta):
template <int W>
__device__ __forceinline__ void imu_raw_pv(const Sys& s, const float* x, int c0, DualT<W>* out) {
  using Dual = DualT<W>;
  const float* J = s.imu_J;
  const float* Xp = s.imu_X;
  Dual dba[3], dbw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dba[k] = X<W>(x, 9 + k, c0) - Xp[9 + k];
    dbw[k] = X<W>(x, 12 + k, c0) - Xp[12 + k];
  }
  Dual alpha[3], beta[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    alpha[i] = cst<W>(Xp[i]);
    beta[i] = cst<W>(Xp[3 + i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      alpha[i] = alpha[i] + J[i * 15 + 9 + k] * dba[k] + J[i * 15 + 12 + k] * dbw[k];
      beta[i] = beta[i] + J[(3 + i) * 15 + 9 + k] * dba[k] + J[(3 + i) * 15 + 12 + k] * dbw[k];
    }
  }
  const float Dt = s.scal[0], g = s.scal[1];
  const V3<W> p0 = X3<W>(x, 0, c0), q0 = X3<W>(x, 3, c0), v0 = X3<W>(x, 6, c0);
  const V3<W> p1 = X3<W>(x, 15, c0), v1 = X3<W>(x, 21, c0);
  const M3<W> R_iw = exp_so3(neg(q0));
  V3<W> va = p1 - p0 - v3(v0.x * Dt, v0.y * Dt, v0.z * Dt);
  va.z = va.z + 0.5f * g * Dt * Dt;
  V3<W> vb = v1 - v0;
  vb.z = vb.z + g * Dt;
  const V3<W> Ra = mv(R_iw, va), Rb = mv(R_iw, vb);
  out[0] = alpha[0] - Ra.x; out[1] = alpha[1] - Ra.y; out[2] = alpha[2] - Ra.z;
  out[3] = beta[0] - Rb.x; out[4] = beta[1] - Rb.y; out[5] = beta[2] - Rb.z;
}

// rows 6-8 (gamma): log(exp(-gamma) R_iw exp(q1))
template <int W>
__device__ __forceinline__ void imu_raw_rot(const Sys& s, const float* x, int c0, DualT<W>* out) {
  using Dual = DualT<W>;
  const float* J = s.imu_J;
  const float* Xp = s.imu_X;
  Dual dbw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dbw[k] = X<W>(x, 12 + k, c0) - Xp[12 + k];
  Dual gamma[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gamma[i] = cst<W>(Xp[6 + i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) gamma[i] = gamma[i] + J[(6 + i) * 15 + 12 + k] * dbw[k];
  }
  const V3<W> q0 = X3<W>(x, 3, c0), q1 = X3<W>(x, 18, c0);
  const M3<W> R_iw = exp_so3(neg(q0));
  const M3<W> Rg = mm(exp_so3(v3(-gamma[0], -gamma[1], -gamma[2])), mm(R_iw, exp_so3(q1)));
  const V3<W> rg = log_so3(Rg);
  out[0] = rg.x; out[1] = rg.y; out[2] = rg.z;
}

// wheel factor (wheel_factor.h:39-70): 3 whitened rows
template <int W>
__device__ __forceinline__ void wheel_rows(const Sys& s, const float* x, int c0, DualT<W>* out) {
  using Dual = DualT<W>;
  const F3 Rw = rot_of(s.T_iw);
  const float pw[3] = {s.T_iw[3], s.T_iw[7], s.T_iw[11]};
  const V3<W> p0 = X3<W>(x, 0, c0), q0 = X3<W>(x, 3, c0);
  const V3<W> p1 = X3<W>(x, 15, c0), q1 = X3<W>(x, 18, c0);
  const M3<W> R0 = exp_so3(q0), R1 = exp_so3(q1);
  const M3<W> RiT = mt(mmf(R0, Rw));
  const M3<W> rel_R = mm(RiT, mmf(R1, Rw));
  const V3<W> rel_p = mv(RiT, mvf(R1, pw) + p1 - mvf(R0, pw) - p0);
  const V3<W> q_rel = log_so3(rel_R);
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

// ground factors (ground_factor.h:25-89) of frame f: 2 rows, tangents on
// [c0, c0 + W)
template <int W>
__device__ __forceinline__ void ground_rows(const Sys& s, const float* x, int f, int c0, DualT<W>* out) {
  using Dual = DualT<W>;
  const F3 Rw = rot_of(s.T_iw);
  const float pw[3] = {s.T_iw[3], s.T_iw[7], s.T_iw[11]};
  const V3<W> p = X3<W>(x, 15 * f, c0), q = X3<W>(x, 15 * f + 3, c0);
  const M3<W> R = exp_so3(q);
  const Dual z = mvf(R, pw).z + p.z;
  const M3<W> To = mmf(R, Rw);
  const Dual sg = dsqrt(dmax(To.a[0][2] * To.a[0][2] + To.a[1][2] * To.a[1][2], EPS * EPS));
  const Dual ang = dasin(dclamp(sg, 0.f, 1.f - 1e-6f));
  const float gw = s.scal[4];
  out[0] = s.scal[2] * z * gw;
  out[1] = s.scal[3] * ang * gw;
}

// ------------------------------------------------------- warp helpers --

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;  // both kernels: 8 warps a block
constexpr int NWARPS = THREADS / 32;
constexpr int NQ = 28;        // partial sums a warp hands to the block step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the 21 upper entries (k <= l) of a symmetric 6x6, row by row
__device__ __forceinline__ int upper6(int k, int l) { return k * (11 - k) / 2 + l; }
__device__ __forceinline__ void upper6_pair(int q, int& k, int& l) {
  k = 0;
  while (q >= 6 - k) {
    q -= 6 - k;
    ++k;
  }
  l = k + q;
}
// the t-th entry (i >= j) of a lower triangle, row by row
__device__ __forceinline__ void lower_pair(int t, int& i, int& j) {
  int r = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= t) ++r;
  if (r * (r + 1) / 2 > t) --r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// ------------------------------------------------- base-row shared part --

// Shared memory of the base rows and the warp solves, the same in both
// kernels.
struct BaseSm {
  float Jnl[R_NL][D];  // whitened / weighted Jacobian rows of the base factors
  float rnl[R_NL];
  float raw[15][32];   // IMU rows before whitening: tangents 0-29, value at 30
  float W[225];        // the IMU whitener
  float T[32 * 33];    // transposition scratch of the warp solves
  float sol[15 * 16];  // Schur: Hmm^-1 [Hmr | gm]
  float dHt[225];      // Schur: dH before symmetrisation
  float red[NWARPS][NQ];  // per-warp partial sums
};

// Base-row work, one factor kind a warp (warps 0-4), so that no warp runs
// two kinds' code one after the other, and one tangent column a lane
// (dual numbers of width 1): warp 0 the IMU's alpha and beta rows (lanes
// 0-20: columns 0-17 and 21-23; they do not depend on q1 or on frame 1's
// biases), warp 1 its gamma rows (lanes 0-8: columns 3-5, 12-14 and
// 18-20, q0, bw0 and q1), warp 2 the wheel rows (lanes 0-11: columns 0-5
// and 15-20), warp 3 the ground rows (lanes 0-11: columns 0-5 of frame 0
// and 15-20 of frame 1), warp 4 the prior rows' values (lanes 0-14) and
// the IMU bias rows' values (lanes 15-20).  The columns no lane writes
// stay 0 from base_init.
constexpr int BASE_WARPS = 5;

// The x-independent part of the base rows, once a launch (all threads;
// the caller syncs): zeros, the prior's Jacobian (linear in x), the bias
// rows' +-1 tangents, the whitener.
__device__ void base_init(const Sys& s, BaseSm& b) {
  const int tid = threadIdx.x;
  const float pv = s.scal[5];
  for (int e = tid; e < R_NL * D; e += THREADS) {
    const int r = e / D, k = e % D;
    (&b.Jnl[0][0])[e] = (r >= 22 && k < 15) ? s.prior_J[(r - 22) * 15 + k] * pv : 0.f;
  }
  for (int e = tid; e < 15 * 32; e += THREADS) {
    const int r = e / 32, k = e % 32;
    float v = 0.f;
    if (r >= 9 && k == r) v = -1.f;
    if (r >= 9 && k == r + 15) v = 1.f;
    (&b.raw[0][0])[e] = v;
  }
  for (int e = tid; e < 225; e += THREADS) b.W[e] = s.imu_sqrtP[e];
}

// The base rows at xs (warps 0-4; see BASE_WARPS).  The IMU rows go to
// b.raw, to be whitened by whiten().  The lane of a factor's first column
// writes the residual values.
__device__ void base_rows(const Sys& s, const float* xs, BaseSm& b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if (lane < 21) {
      const int c = lane < 18 ? lane : lane + 3;
      DualT<1> r[6];
      imu_raw_pv<1>(s, xs, c, r);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        b.raw[i][c] = r[i].d[0];
        if (lane == 0) b.raw[i][30] = r[i].v;
      }
    }
  } else if (warp == 1) {
    if (lane < 9) {
      const int c = lane + (lane < 3 ? 3 : (lane < 6 ? 9 : 12));
      DualT<1> r[3];
      imu_raw_rot<1>(s, xs, c, r);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        b.raw[6 + i][c] = r[i].d[0];
        if (lane == 0) b.raw[6 + i][30] = r[i].v;
      }
    }
  } else if (warp == 2) {
    if (lane < 12) {
      const int c = lane < 6 ? lane : lane + 9;
      DualT<1> r[3];
      wheel_rows<1>(s, xs, c, r);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        b.Jnl[15 + i][c] = r[i].d[0];
        if (lane == 0) b.rnl[15 + i] = r[i].v;
      }
    }
  } else if (warp == 3) {
    if (lane < 12) {
      const int f = lane / 6, c = 15 * f + lane % 6;
      DualT<1> r[2];
      ground_rows<1>(s, xs, f, c, r);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        b.Jnl[18 + 2 * f + i][c] = r[i].d[0];
        if (lane % 6 == 0) b.rnl[18 + 2 * f + i] = r[i].v;
      }
    }
  } else if (warp == 4) {
    if (lane < 15) {
      const int i = lane;
      float val = 0.f;
      for (int k = 0; k < 15; ++k) val += s.prior_J[i * 15 + k] * (xs[k] - s.prior_X[k]);
      b.rnl[22 + i] = val * s.scal[5];
    } else if (lane < 21) {
      const int k = lane - 15;
      b.raw[9 + k][30] = xs[24 + k] - xs[9 + k];
    }
  }
}

// IMU rows 0-14 of Jnl and rnl: W * raw, one output entry a thread (all
// threads, after a barrier behind base_rows)
__device__ void whiten(BaseSm& b) {
  for (int e = threadIdx.x; e < 15 * 31; e += THREADS) {
    const int i = e / 31, c = e % 31;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 15; ++k) acc += b.W[i * 15 + k] * b.raw[k][c];
    if (c < D) b.Jnl[i][c] = acc;
    else b.rnl[i] = acc;
  }
}

// entries of the base rows' normal equations (after a barrier behind
// whiten): (J^T J)_ij, (J^T r)_i, |r|^2
__device__ __forceinline__ float base_jtj(const BaseSm& b, int i, int j) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R_NL; ++r) acc += b.Jnl[r][i] * b.Jnl[r][j];
  return acc;
}
__device__ __forceinline__ float base_jtr(const BaseSm& b, int i) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R_NL; ++r) acc += b.Jnl[r][i] * b.rnl[r];
  return acc;
}
__device__ __forceinline__ float base_rtr(const BaseSm& b) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R_NL; ++r) acc += b.rnl[r] * b.rnl[r];
  return acc;
}

// Each warp's sums of v[0..Q) over its lanes -> red[warp][0..Q) (lane 0
// writes); after a barrier, block_total(q) is the block's sum.
template <int Q>
__device__ __forceinline__ void warp_partials(float (&v)[Q], BaseSm& b) {
#pragma unroll
  for (int q = 0; q < Q; ++q) v[q] = warp_sum(v[q]);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) b.red[threadIdx.x >> 5][q] = v[q];
  }
}
__device__ __forceinline__ float block_total(const BaseSm& b, int q) {
  float acc = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) acc += b.red[w][q];
  return acc;
}

// --------------------------------------------------- warp factorization --

// The step loops below are not unrolled: the chain is bound by latency
// (the sqrt and the two IEEE divisions of a step, each with its slow-path
// check), not by issue, so unrolling gains nothing measurable while it
// multiplies the code the block streams through the instruction cache.
// Register arrays keep static indices by rotating: after step k, a[j]
// holds column k + 1 + j.

// Lower Cholesky of an N x N matrix (N <= 32) by one warp: lane i (< N)
// holds row i in a[0..N) (a[] is scratch on return) and L goes to shared
// memory by columns, L_ik at Lt[k * 33 + i].  Right-looking, in the k-order
// of the serial form (each entry gets its rank-1 updates in the same
// order): at step k lane k's pivot sqrt(max(A_kk, 1e-20)) is broadcast,
// every lane divides its entry k by it and stores it, and each lane reads
// column k back (one broadcast load an entry, all issued together) for
// its rank-1 update.  Steps in the bit mask `skip` (statically frozen
// dims, whose rows and columns must be identity) are skipped: L's column
// is e_k.  With FWD, the forward substitution L y = r of one right-hand
// side (lane i: r_i) runs in the same loop: its step k needs only column
// k, so its chain overlaps the factorization's.
template <int N, bool FWD>
__device__ __forceinline__ void warp_cholesky(float (&a)[N], float& r, uint32_t skip, float* Lt) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int k = 0; k < N; ++k) {
    float* col = Lt + k * 33;  // col[i] = L_ik
    if (skip >> k & 1u) {
      col[lane] = lane == k ? 1.f : 0.f;
      if (FWD && lane == k) r = 0.f;
    } else {
      const float piv = sqrtf(fmaxf(__shfl_sync(FULL, a[0], k), 1e-20f));
      // rows above k have no entry in column k: they divide piv by itself
      // and take 0, so that their scratch stays finite
      const bool below = lane >= k;
      const float q = (below ? a[0] : piv) / piv;
      const float l = below ? q : 0.f;
      col[lane] = l;
      __syncwarp();
      // entries past row N - 1 are scratch: they update scratch columns
#pragma unroll
      for (int j = 1; j < N; ++j) a[j] -= l * col[k + j];
      if (FWD) {
        const float yk = __shfl_sync(FULL, r, k) / col[k];
        r = lane == k ? yk : (lane > k ? r - l * yk : r);
      }
    }
#pragma unroll
    for (int j = 0; j + 1 < N; ++j) a[j] = a[j + 1];
  }
  __syncwarp();
}

// L^T x = y by one warp, with Lt from warp_cholesky: lane i holds y_i in r
// and gets x_i.  Step k: x_k = y_k / L_kk is broadcast from lane k and
// lanes i < k subtract L_ki x_k; L's entries come from shared memory one
// step ahead.  Skipped dims give 0.
template <int N>
__device__ __forceinline__ void warp_back_substitute(const float* Lt, float& r, uint32_t skip) {
  const int lane = threadIdx.x & 31;
  const int li = lane < N ? lane : N - 1;
  float lki = Lt[li * 33 + N - 1], lkk = Lt[(N - 1) * 33 + N - 1];
#pragma unroll 1
  for (int k = N - 1; k >= 0; --k) {
    const float cki = lki, ckk = lkk;
    if (k > 0) {
      lki = Lt[li * 33 + k - 1];
      lkk = Lt[(k - 1) * 33 + k - 1];
    }
    const float xk = (skip >> k & 1u) ? 0.f : __shfl_sync(FULL, r, k) / ckk;
    r = lane == k ? xk : (lane < k ? r - cki * xk : r);
  }
}

// One warp: the Jacobi-equilibrated solve of the damped system whose row
// i lane i holds in a[] (a[i] == dd, its diagonal) with right-hand side
// b: S = diag(1/sqrt(max(dd, 1e-20))), (S A S) y = S b by warp_cholesky
// with the `skip` steps elided (L in T, 32 x 33 floats of shared memory);
// returns S y (lane i: entry i).
template <int N>
__device__ __forceinline__ float equilibrated_solve(float (&a)[N], float dd, float b, uint32_t skip,
                                                    float* T) {
  const float sc = 1.f / sqrtf(fmaxf(dd, 1e-20f));
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] *= sc * __shfl_sync(FULL, sc, j);
  float r = b * sc;
  warp_cholesky<N, true>(a, r, skip, T);
  warp_back_substitute<N>(T, r, skip);
  return sc * r;
}

__device__ __forceinline__ float so3_wrap_scale(float w0, float w1, float w2) {
  const float th = sqrtf(fmaxf(w0 * w0 + w1 * w1 + w2 * w2, EPS * EPS));
  const float two_pi = 2.f * PI_F;
  const float wrapped = th - two_pi * floorf((th + PI_F) / two_pi);
  return th > PI_F ? wrapped / th : 1.f;
}

// lane i of a warp holding x[i] (i < D): x[3:6] and x[18:21] wrapped to
// angles <= pi
__device__ __forceinline__ float so3_wrap_lane(float v, int i) {
  const float s1 = so3_wrap_scale(__shfl_sync(FULL, v, 3), __shfl_sync(FULL, v, 4), __shfl_sync(FULL, v, 5));
  const float s2 =
      so3_wrap_scale(__shfl_sync(FULL, v, 18), __shfl_sync(FULL, v, 19), __shfl_sync(FULL, v, 20));
  return (i >= 3 && i < 6) ? v * s1 : ((i >= 18 && i < 21) ? v * s2 : v);
}

// Schur reduction of frame 0 out of the normal equations (H, g) of the
// 30-dim window (gn.marginalize, keep = 15), all threads: warp 0 factors
// the equilibrated Hmm + 1e-8 I and solves its 16 right-hand sides
// [H[0:15, 15:30] | g[0:15]], one a lane (a division a step on each lane,
// in parallel, where a row a lane would put 16 divisions a step on one
// lane's chain); then one thread an entry forms dH (15x15, symmetrised)
// and dg (15,) into device memory.
__device__ void schur_frame0(const float* H, const float* g, BaseSm& b, float* dH, float* dgo) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int i = tid < 15 ? tid : 14;
    const float sci = 1.f / sqrtf(fmaxf(H[i * D + i] + 1e-8f, 1e-20f));
    float a[15];
#pragma unroll
    for (int j = 0; j < 15; ++j)
      a[j] = (H[i * D + j] + (j == i ? 1e-8f : 0.f)) * (sci * __shfl_sync(FULL, sci, j));
    float unused = 0.f;
    warp_cholesky<15, false>(a, unused, 0u, b.T);
    // lane c < 16: right-hand side c, L y = rhs then L^T x = y in the order
    // of the scalar form
    const int c = tid < 16 ? tid : 15;
    const float* Lt = b.T;  // L_kj at Lt[j * 33 + k]
    float y[15], sc[15];
#pragma unroll
    for (int k = 0; k < 15; ++k) {
      sc[k] = __shfl_sync(FULL, sci, k);
      y[k] = sc[k] * (c < 15 ? H[k * D + 15 + c] : g[k]);
    }
#pragma unroll
    for (int k = 0; k < 15; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < k; ++j) acc += Lt[j * 33 + k] * y[j];
      y[k] = (y[k] - acc) / Lt[k * 33 + k];
    }
#pragma unroll
    for (int k = 14; k >= 0; --k) {
      float acc = 0.f;
#pragma unroll
      for (int j = k + 1; j < 15; ++j) acc += Lt[k * 33 + j] * y[j];
      y[k] = (y[k] - acc) / Lt[k * 33 + k];
    }
    if (tid < 16) {
#pragma unroll
      for (int k = 0; k < 15; ++k) b.sol[k * 16 + tid] = sc[k] * y[k];
    }
  }
  __syncthreads();
  for (int e = tid; e < 240; e += THREADS) {
    const int i = e < 225 ? e / 15 : e - 225, j = e < 225 ? e % 15 : 15;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 15; ++k) acc += H[(15 + i) * D + k] * b.sol[k * 16 + j];
    if (e < 225) b.dHt[e] = H[(15 + i) * D + 15 + j] - acc;
    else dgo[i] = g[15 + i] - acc;
  }
  __syncthreads();
  for (int e = tid; e < 225; e += THREADS) {
    const int i = e / 15, j = e % 15;
    dH[e] = 0.5f * (b.dHt[i * 15 + j] + b.dHt[j * 15 + i]);
  }
}

}  // namespace
