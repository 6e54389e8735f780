// Kernel B1: the per-frame tracking solve (LM + Schur reduction) for Hopper.
//
// Replaces the Pallas TPU kernel liwslam/ops/track_solve.py::lm_solve_track
// (_kernel :578, residual _make_residual :271, _cholesky :484,
// _solve_lower :542, _solve_upper_t :559).  Its plain PyTorch version is
// liwslam_torch/ops/track_solve.py::lm_solve_track_plain.
//
// What it computes, for each of B independent systems (one thread block
// each; the tracking path launches B = 1):
//   residual of 37 + 2M rows over the 30-dim [frame 0 | frame 1] state:
//   IMU 15, wheel 3, laser 2M (both endpoints of every match), ground 4,
//   prior 15; Levenberg-Marquardt with damping lam*max(diag,1e-12), Jacobi
//   equilibration, a 30x30 Cholesky that skips the statically frozen dims
//   (pivot clamp 1e-20), zero step when the step is non-finite, lambda in
//   [1e-10, 1e8] (x4 on reject, x0.33 on accept), early exit on ftol / xtol
//   / a rejected step with lambda at its maximum, one linearization per
//   iteration (at the trial point), SO(3) wrap of x[3:6] and x[18:21];
//   then the Schur reduction of frame 0 at the solution:
//   Hmm + 1e-8 I, equilibrated 15x15 Cholesky, symmetrised dH, and dg.
//
// What bounds it on this card: nothing the card is rated for.  One system
// at M = 64 is ~0.36 MFLOP per linearization (the dual-number Jacobian and
// H = J^T J) and a 30x30 factorization per LM step, on ~7 KB of inputs:
// tens of nanoseconds at the card's float32 rate, a few at its memory rate.  The
// time is the latency of a dependent chain inside one block: linearize,
// barrier, factor, barrier, linearize ... for ~3 LM iterations.
//
// What the design does about it: everything stays in one launch and in
// shared memory (no host round trip per iteration, no device memory
// traffic after the first read).  The Jacobian is forward-mode with
// dual numbers of a fixed tangent width of 6, seeded per factor on the
// few columns the factor touches (laser rows: p1, q1; ground: one frame's
// p, q; wheel: p0 q0 and p1 q1 in two passes; the IMU block in five passes
// of 6 columns), so no 30-wide dual ever lives in registers.  Laser rows
// run one match per thread on warps 1..3 while warp 0 runs the IMU, wheel,
// ground and prior rows; H, g and the cost are then assembled by all
// threads, each owning entries of the 30x30.  The factorizations are
// small and serial and run on thread 0 from shared memory.  A faster
// version (warp-parallel Cholesky, many systems per block) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 30;
constexpr int NW = 6;       // tangent width of the dual numbers
constexpr int R_NL = 37;    // non-laser rows: imu 15, wheel 3, ground 4, prior 15
constexpr int M_MAX = 256;  // laser matches per system
constexpr int THREADS = 128;
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

// laser factor (laser_factor.h:31-88) of match m: 2 rows (both endpoints),
// tangents on columns 15..20 (p1, q1)
__device__ void laser_rows(const Sys& s, const float* x, int m, Dual* out) {
  const float* L = s.laser + m * 11;
  const F3 Ril = rot_of(s.T_il);
  const float til[3] = {s.T_il[3], s.T_il[7], s.T_il[11]};
  const V3 p1 = X3(x, 15, 15), q1 = X3(x, 18, 15);
  const M3 R1 = exp_so3(q1);
  const M3 TR = mmf(R1, Ril);
  const V3 tt = mvf(R1, til);
  const Dual tx = tt.x + p1.x, ty = tt.y + p1.y;
  const float a2x = L[2], a2y = L[3];
  const float dlx = a2x - L[0], dly = a2y - L[1];
  const float dn = sqrtf(fmaxf(dlx * dlx + dly * dly, EPS * EPS));
  const float ux = dlx / dn, uy = dly / dn;
  const float lw = L[10];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* b = L + 4 + 3 * e;
    const Dual vx = TR.a[0][0] * b[0] + TR.a[0][1] * b[1] + TR.a[0][2] * b[2] + tx - a2x;
    const Dual vy = TR.a[1][0] * b[0] + TR.a[1][1] * b[1] + TR.a[1][2] * b[2] + ty - a2y;
    const Dual t = ux * vx + uy * vy;
    const Dual px = vx - t * ux, py = vy - t * uy;
    out[e] = dsqrt(dmax(px * px + py * py, EPS * EPS)) * lw;
  }
}

// ------------------------------------------------------ shared state ----

struct Smem {
  float x[D], xt[D], dx[D], free[D];
  float Jnl[R_NL][D];  // non-laser Jacobian rows
  float rnl[R_NL];
  float LJ[2 * M_MAX][NW];  // laser rows: tangents on columns 15..20
  float Lr[2 * M_MAX];
  float H[D][D], g[D];      // accepted linearization: J^T J, -J^T r
  float Ht[D][D], gt[D];    // trial linearization
  float A[D][D];            // factorization scratch (thread 0)
  float y[D + 1];
  float c, ct, lam;
  int done, accept;
};

// (Ht, gt, ct) <- linearization at xs; all threads take part
__device__ void linearize(const Sys& s, const float* xs, int M, Smem& sm, float (*Hout)[D],
                          float* gout, float* cout) {
  const int tid = threadIdx.x;
  for (int e = tid; e < R_NL * D; e += THREADS) (&sm.Jnl[0][0])[e] = 0.f;
  __syncthreads();
  if (tid < 32) {
    // warp 0: IMU (5 column windows), wheel (2), ground (2), prior (15 rows)
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
        for (int j = 0; j < NW; ++j) sm.Jnl[i][c0 + j] = acc[j];
        if (tid == 0) sm.rnl[i] = val;
      }
    } else if (tid < 7) {
      const int c0 = tid == 5 ? 0 : 15;
      Dual r[3];
      wheel_rows(s, xs, c0, r);
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < NW; ++j) sm.Jnl[15 + i][c0 + j] = r[i].d[j];
        if (tid == 5) sm.rnl[15 + i] = r[i].v;
      }
    } else if (tid < 9) {
      const int f = tid - 7;
      Dual r[2];
      ground_rows(s, xs, f, r);
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < NW; ++j) sm.Jnl[18 + 2 * f + i][15 * f + j] = r[i].d[j];
        sm.rnl[18 + 2 * f + i] = r[i].v;
      }
    } else if (tid < 24) {
      const int i = tid - 9;
      const float pv = s.scal[5];
      float val = 0.f;
      for (int k = 0; k < 15; ++k) {
        const float a = s.prior_J[i * 15 + k];
        val += a * (xs[k] - s.prior_X[k]);
        sm.Jnl[22 + i][k] = a * pv;
      }
      sm.rnl[22 + i] = val * pv;
    }
  } else {
    for (int m = tid - 32; m < M; m += THREADS - 32) {
      Dual r[2];
      laser_rows(s, xs, m, r);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int j = 0; j < NW; ++j) sm.LJ[2 * m + e][j] = r[e].d[j];
        sm.Lr[2 * m + e] = r[e].v;
      }
    }
  }
  __syncthreads();
  // H = J^T J, g = -J^T r, cost = |r|^2 / 2; each thread owns entries
  const int nl = 2 * M;
  for (int e = tid; e < D * D + D + 1; e += THREADS) {
    if (e < D * D) {
      const int i = e / D, j = e % D;
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.Jnl[r][i] * sm.Jnl[r][j];
      if (i >= 15 && i < 21 && j >= 15 && j < 21)
        for (int r = 0; r < nl; ++r) acc += sm.LJ[r][i - 15] * sm.LJ[r][j - 15];
      Hout[i][j] = acc;
    } else if (e < D * D + D) {
      const int i = e - D * D;
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.Jnl[r][i] * sm.rnl[r];
      if (i >= 15 && i < 21)
        for (int r = 0; r < nl; ++r) acc += sm.LJ[r][i - 15] * sm.Lr[r];
      gout[i] = -acc;
    } else {
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.rnl[r] * sm.rnl[r];
      for (int r = 0; r < nl; ++r) acc += sm.Lr[r] * sm.Lr[r];
      *cout = 0.5f * acc;
    }
  }
  __syncthreads();
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

__global__ void __launch_bounds__(THREADS) track_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ free_, const float* __restrict__ imu_J,
    const float* __restrict__ imu_sqrtP, const float* __restrict__ imu_X,
    const float* __restrict__ prior_J, const float* __restrict__ prior_X,
    const float* __restrict__ T_il, const float* __restrict__ T_iw,
    const float* __restrict__ wheel, const float* __restrict__ scal,
    const float* __restrict__ laser, int M, int max_iters, uint32_t frozen, int early_exit,
    float ftol, float xtol, float* __restrict__ x_out, float* __restrict__ cost_out,
    float* __restrict__ dH_out, float* __restrict__ dg_out, int* __restrict__ iters_out) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  Sys s;
  s.x0 = x0 + b * D;
  s.free = free_ + b * D;
  s.imu_J = imu_J + b * 225;
  s.imu_sqrtP = imu_sqrtP + b * 225;
  s.imu_X = imu_X + b * 15;
  s.prior_J = prior_J + b * 225;
  s.prior_X = prior_X + b * 15;
  s.T_il = T_il + b * 16;
  s.T_iw = T_iw + b * 16;
  s.wheel = wheel + b * 9;
  s.scal = scal + b * 6;
  s.laser = laser + (size_t)b * M * 11;

  if (tid < D) {
    sm.x[tid] = s.x0[tid];
    sm.free[tid] = s.free[tid];
  }
  if (tid == 0) {
    sm.lam = 1e-4f;
    sm.done = 0;
  }
  __syncthreads();
  linearize(s, sm.x, M, sm, sm.H, sm.g, &sm.c);

  int it = 0;
  for (; it < max_iters; ++it) {
    if (early_exit && sm.done) break;
    if (tid == 0) {
      // damped, Jacobi-equilibrated normal equations over the free dims
      float sc[D], rhs[D];
      for (int i = 0; i < D; ++i) {
        const bool fi = sm.free[i] > 0.f;
        for (int j = 0; j < D; ++j) sm.A[i][j] = sm.H[i][j] * (sm.free[i] * sm.free[j]);
        const float dg = sm.A[i][i];
        sm.A[i][i] = fi ? dg + sm.lam * fmaxf(dg, 1e-12f) : 1.f;
        rhs[i] = fi ? sm.g[i] : 0.f;
      }
      for (int i = 0; i < D; ++i) sc[i] = 1.f / sqrtf(fmaxf(sm.A[i][i], 1e-20f));
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j <= i; ++j) sm.A[i][j] *= sc[i] * sc[j];
        rhs[i] *= sc[i];
      }
      cholesky(sm.A, D, frozen);
      chol_solve(sm.A, D, frozen, rhs);
      bool finite = true;
      for (int i = 0; i < D; ++i) {
        sm.dx[i] = sc[i] * rhs[i] * sm.free[i];
        finite = finite && isfinite(sm.dx[i]);
      }
      for (int i = 0; i < D; ++i) {
        if (!finite) sm.dx[i] = 0.f;
        sm.xt[i] = sm.x[i] + sm.dx[i];
      }
      const float s1 = so3_wrap_scale(sm.xt + 3), s2 = so3_wrap_scale(sm.xt + 18);
      for (int k = 0; k < 3; ++k) {
        sm.xt[3 + k] *= s1;
        sm.xt[18 + k] *= s2;
      }
    }
    __syncthreads();
    linearize(s, sm.xt, M, sm, sm.Ht, sm.gt, &sm.ct);
    if (tid == 0) {
      const bool done = sm.done != 0;
      const bool acc = (sm.ct < sm.c) && !done;
      const float c_old = sm.c;
      if (acc) {
        for (int i = 0; i < D; ++i) sm.x[i] = sm.xt[i];
        sm.c = sm.ct;
      }
      float lam = done ? sm.lam : (acc ? sm.lam * 0.33f : sm.lam * 4.f);
      lam = fminf(fmaxf(lam, 1e-10f), 1e8f);
      sm.lam = lam;
      const float rel = fabsf(c_old - sm.ct) / fmaxf(c_old, 1e-20f);
      float mdx = 0.f, mx = 0.f;
      for (int i = 0; i < D; ++i) {
        mdx = fmaxf(mdx, fabsf(sm.dx[i]));
        mx = fmaxf(mx, fabsf(sm.x[i]));
      }
      const bool xtol_hit = mdx < xtol * (mx + xtol);
      const bool stalled = !acc && lam >= 1e8f;
      sm.done = (done || rel < ftol || xtol_hit || stalled) ? 1 : 0;
      sm.accept = acc ? 1 : 0;
    }
    __syncthreads();
    if (sm.accept) {
      for (int e = tid; e < D * D; e += THREADS) (&sm.H[0][0])[e] = (&sm.Ht[0][0])[e];
      if (tid < D) sm.g[tid] = sm.gt[tid];
    }
    __syncthreads();
  }

  // Schur reduction of frame 0 at the solution (gn.marginalize, keep = 15)
  if (tid == 0) {
    float sc[15];
    for (int i = 0; i < 15; ++i) {
      for (int j = 0; j < 15; ++j) sm.A[i][j] = sm.H[i][j] + (i == j ? 1e-8f : 0.f);
    }
    for (int i = 0; i < 15; ++i) sc[i] = 1.f / sqrtf(fmaxf(sm.A[i][i], 1e-20f));
    for (int i = 0; i < 15; ++i)
      for (int j = 0; j <= i; ++j) sm.A[i][j] *= sc[i] * sc[j];
    cholesky(sm.A, 15, 0u);
    // sol[:, c] for c < 15: Hmm^-1 H[0:15, 15 + c]; column 15: Hmm^-1 g[0:15]
    float* dH = dH_out + b * 225;
    float* dgo = dg_out + b * 15;
    float sol[15][16];
    for (int c = 0; c < 16; ++c) {
      float rhs[D];
      for (int i = 0; i < 15; ++i) rhs[i] = sc[i] * (c < 15 ? sm.H[i][15 + c] : sm.g[i]);
      chol_solve(sm.A, 15, 0u, rhs);
      for (int i = 0; i < 15; ++i) sol[i][c] = sc[i] * rhs[i];
    }
    float dHt[15][15];
    for (int i = 0; i < 15; ++i) {
      for (int j = 0; j < 15; ++j) {
        float acc = 0.f;
        for (int k = 0; k < 15; ++k) acc += sm.H[15 + i][k] * sol[k][j];
        dHt[i][j] = sm.H[15 + i][15 + j] - acc;
      }
      float acc = 0.f;
      for (int k = 0; k < 15; ++k) acc += sm.H[15 + i][k] * sol[k][15];
      dgo[i] = sm.g[15 + i] - acc;
    }
    for (int i = 0; i < 15; ++i)
      for (int j = 0; j < 15; ++j) dH[i * 15 + j] = 0.5f * (dHt[i][j] + dHt[j][i]);
    for (int i = 0; i < D; ++i) x_out[b * D + i] = sm.x[i];
    cost_out[b] = sm.c;
    iters_out[b] = it;
  }
}

}  // namespace

// C interface (ctypes).  Inputs are contiguous float32 device arrays with a
// leading batch dim B; outputs x (B,30), cost (B,), dH (B,15,15), dg (B,15)
// and the LM iterations run, iters (B,) int32.
// Launches B blocks on `stream` and returns the launch's cudaError_t.
extern "C" int liwslam_track_solve(const float* x0, const float* free_, const float* imu_J,
                                   const float* imu_sqrtP, const float* imu_X,
                                   const float* prior_J, const float* prior_X, const float* T_il,
                                   const float* T_iw, const float* wheel, const float* scal,
                                   const float* laser, int B, int M, int max_iters, int frozen,
                                   int early_exit, float ftol, float xtol, float* x_out,
                                   float* cost_out, float* dH_out, float* dg_out, int* iters_out,
                                   void* stream) {
  if (B < 1 || M < 1 || M > M_MAX) return (int)cudaErrorInvalidValue;
  track_solve_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      x0, free_, imu_J, imu_sqrtP, imu_X, prior_J, prior_X, T_il, T_iw, wheel, scal, laser, M,
      max_iters, (uint32_t)frozen, early_exit, ftol, xtol, x_out, cost_out, dH_out, dg_out,
      iters_out);
  return (int)cudaGetLastError();
}
