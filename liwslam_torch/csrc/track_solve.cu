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
//
// The dual numbers, the non-laser rows, the Cholesky and the frame-0 Schur
// reduction live in solve_common.cuh, shared with kernel B4 (cam_solve.cu).

#include "solve_common.cuh"

namespace {

constexpr int M_MAX = 256;  // laser matches per system
constexpr int THREADS = 128;

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
    base_rows(s, xs, tid, sm.Jnl, sm.rnl);
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
    schur_frame0(sm.H, sm.g, sm.A, dH_out + b * 225, dg_out + b * 15);
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
