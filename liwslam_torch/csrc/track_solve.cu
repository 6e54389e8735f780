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
// tens of nanoseconds at the card's float32 rate, a few at its memory
// rate.  The time is the length of a dependent chain inside one block:
// linearize, barrier, factor, barrier, linearize ... for up to max_iters
// LM iterations, so what counts is the latency of each link, and the code
// each link streams through the instruction cache.
//
// What the design does about it: one launch for the whole solve and the
// prior, every intermediate in shared memory or registers, and each link
// of the chain spread over the block (256 threads) so that no thread runs
// a long serial loop.
//   - Linearization (3 barriers): the base rows run one factor kind a warp
//     and one tangent column a lane (solve_common.cuh base_rows: IMU
//     alpha/beta, IMU gamma, wheel, ground, prior), while the top warps
//     run the laser rows, a p1 pass and a q1 pass of each match a thread
//     (dual numbers of width 3).  The IMU rows are whitened as a product
//     W * raw, one entry a thread; the laser block's 28 sums over the 2M
//     rows are one warp each, lanes striding the rows; H's lower triangle,
//     g and the cost are then one entry a thread.
//   - LM step (warp 0): lane i builds row i of the damped, equilibrated
//     30x30 in registers and the warp factors it (solve_common.cuh
//     warp_cholesky: pivot broadcast by a shuffle, column k broadcast
//     through shared memory, the frozen steps elided: 24, or 18 in
//     fast_mode), with the forward substitution in the same loop and the
//     back substitution after it.  The convergence maxima are warp
//     reductions, and the accepted linearization is kept by flipping
//     between two buffers, not by copying.
//   - Schur reduction (solve_common.cuh schur_frame0): the same warp
//     factorization of the 15x15, its 16 right-hand sides one a lane, dH
//     and dg one entry a thread.
// Where the time goes now (M = 64, fast_mode; H100, chip_smoke.py's
// iteration_split over max_iters = 0..8): ~0.017 ms fixed (the first
// linearization and the Schur reduction) and ~0.018 ms an LM iteration (a
// factorization, its solves and a linearization).

#include "solve_common.cuh"

namespace {

constexpr int M_MAX = 256;  // laser matches per system

// laser factor (laser_factor.h:31-88) of match m: 2 rows (both endpoints),
// tangents on p1 (columns 15..17, part 0) or on q1 (18..20, part 1)
__device__ __forceinline__ void laser_rows(const Sys& s, const float* x, int m, int part, DualT<3>* out) {
  using Dual = DualT<3>;
  const float* L = s.laser + m * 11;
  const F3 Ril = rot_of(s.T_il);
  const float til[3] = {s.T_il[3], s.T_il[7], s.T_il[11]};
  const int c0 = 15 + 3 * part;
  const V3<3> p1 = X3<3>(x, 15, c0), q1 = X3<3>(x, 18, c0);
  const M3<3> R1 = exp_so3(q1);
  const M3<3> TR = mmf(R1, Ril);
  const V3<3> tt = mvf(R1, til);
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
  BaseSm b;
  float LJ[2 * M_MAX][6];  // laser rows: tangents on columns 15..20
  float Lr[2 * M_MAX];
  float Lq[NQ];            // the laser rows' 6x6 block (21 upper entries), J^T r (6), |r|^2
  float H[2][D * D], g[2][D];  // linearizations: [cur] accepted, [cur ^ 1] trial
  float x[D], xt[D], dx[D], free[D];
  float c, ct, lam;
  int done, cur;
};

// (H[k], g[k], *cost) <- linearization at xs; all threads take part
__device__ void linearize(const Sys& s, const float* xs, int M, Smem& sm, int k, float* cost) {
  const int tid = threadIdx.x;
  if (tid < 32 * BASE_WARPS) base_rows(s, xs, sm.b);
  // laser items: a p1 pass and a q1 pass for every match, from the last
  // thread down, so that the base-row warps take none at M <= 64
  for (int item = THREADS - 1 - tid; item < 2 * M; item += THREADS) {
    const int part = item / M, m = item % M;
    DualT<3> r[2];
    laser_rows(s, xs, m, part, r);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int a = 0; a < 3; ++a) sm.LJ[2 * m + e][3 * part + a] = r[e].d[a];
      if (part == 0) sm.Lr[2 * m + e] = r[e].v;
    }
  }
  __syncthreads();
  whiten(sm.b);
  // the laser block's 28 sums over the 2M rows: warp w takes sums w, w + 8,
  // ..., its lanes a stride of rows each
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int q = warp; q < NQ; q += NWARPS) {
      int a = 0, c = 0;
      if (q < 21) upper6_pair(q, a, c);
      float acc = 0.f;
      for (int r = lane; r < 2 * M; r += 32) {
        const float u = q < 21 ? sm.LJ[r][a] : (q < 27 ? sm.LJ[r][q - 21] : sm.Lr[r]);
        const float v = q < 21 ? sm.LJ[r][c] : sm.Lr[r];
        acc += u * v;
      }
      acc = warp_sum(acc);
      if (lane == 0) sm.Lq[q] = acc;
    }
  }
  __syncthreads();
  // H = J^T J (lower triangle, mirrored), g = -J^T r, cost = |r|^2 / 2;
  // one entry a thread
  float* H = sm.H[k];
  float* g = sm.g[k];
  for (int t = tid; t < D * (D + 1) / 2 + D + 1; t += THREADS) {
    if (t < D * (D + 1) / 2) {
      int i, j;
      lower_pair(t, i, j);
      float acc = base_jtj(sm.b, i, j);
      if (j >= 15 && i < 21) acc += sm.Lq[upper6(j - 15, i - 15)];
      H[i * D + j] = acc;
      H[j * D + i] = acc;
    } else if (t < D * (D + 1) / 2 + D) {
      const int i = t - D * (D + 1) / 2;
      float acc = base_jtr(sm.b, i);
      if (i >= 15 && i < 21) acc += sm.Lq[21 + i - 15];
      g[i] = -acc;
    } else {
      *cost = 0.5f * (base_rtr(sm.b) + sm.Lq[27]);
    }
  }
  __syncthreads();
}

// warp 0: the damped, equilibrated step from the accepted linearization
// -> dx, and the trial point xt (SO(3)-wrapped)
__device__ __forceinline__ void lm_step(Smem& sm, int cur, uint32_t frozen) {
  const int lane = threadIdx.x & 31;
  const int i = lane < D ? lane : D - 1;
  const float* H = sm.H[cur];
  const float fi = sm.free[i];
  const bool fb = fi > 0.f;
  const float hd = H[i * D + i] * (fi * fi);
  const float dd = fb ? hd + sm.lam * fmaxf(hd, 1e-12f) : 1.f;
  float a[D];
#pragma unroll
  for (int j = 0; j < D; ++j) a[j] = j == i ? dd : H[i * D + j] * (fi * sm.free[j]);
  float d = equilibrated_solve<D>(a, dd, fb ? sm.g[cur][i] : 0.f, frozen, sm.b.T) * fi;
  if (!__all_sync(FULL, lane >= D || isfinite(d))) d = 0.f;
  const float xt = so3_wrap_lane(sm.x[i] + d, i);
  if (lane < D) {
    sm.dx[lane] = d;
    sm.xt[lane] = xt;
  }
}

// warp 0, after the trial linearization: accept or reject, lambda, exits
__device__ __forceinline__ void accept_step(Smem& sm, float ftol, float xtol) {
  const int lane = threadIdx.x & 31;
  const int i = lane < D ? lane : D - 1;
  const bool done = sm.done != 0;
  const bool acc = (sm.ct < sm.c) && !done;
  const float c_old = sm.c;
  const float xi = acc ? sm.xt[i] : sm.x[i];
  const float mdx = warp_max(lane < D ? fabsf(sm.dx[i]) : 0.f);
  const float mx = warp_max(lane < D ? fabsf(xi) : 0.f);
  __syncwarp();
  if (lane < D) sm.x[lane] = xi;
  if (lane == 0) {
    if (acc) {
      sm.c = sm.ct;
      sm.cur ^= 1;
    }
    float lam = done ? sm.lam : (acc ? sm.lam * 0.33f : sm.lam * 4.f);
    lam = fminf(fmaxf(lam, 1e-10f), 1e8f);
    sm.lam = lam;
    const float rel = fabsf(c_old - sm.ct) / fmaxf(c_old, 1e-20f);
    const bool xtol_hit = mdx < xtol * (mx + xtol);
    const bool stalled = !acc && lam >= 1e8f;
    sm.done = (done || rel < ftol || xtol_hit || stalled) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS, 1) track_solve_kernel(
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
    sm.cur = 0;
  }
  base_init(s, sm.b);
  __syncthreads();
  linearize(s, sm.x, M, sm, 0, &sm.c);

  int it = 0;
  // sm.done, sm.cur and sm.x are written by warp 0 before a barrier
  for (; it < max_iters; ++it) {
    if (early_exit && sm.done) break;
    const int cur = sm.cur;
    if (tid < 32) lm_step(sm, cur, frozen);
    __syncthreads();
    linearize(s, sm.xt, M, sm, cur ^ 1, &sm.ct);
    if (tid < 32) accept_step(sm, ftol, xtol);
    __syncthreads();
  }

  // Schur reduction of frame 0 at the solution (gn.marginalize, keep = 15)
  const int cur = sm.cur;
  schur_frame0(sm.H[cur], sm.g[cur], sm.b, dH_out + b * 225, dg_out + b * 15);
  if (tid < D) x_out[b * D + tid] = sm.x[tid];
  if (tid == 0) {
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

// The kernel's registers a thread and local memory a thread (its stack
// frame, spills included) as the loaded module reports them; returns the
// cudaError_t of the query.
extern "C" int liwslam_track_solve_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, track_solve_kernel);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
  }
  return (int)e;
}
