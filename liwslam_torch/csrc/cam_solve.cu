// Kernel B4: the camera sub-step's joint pose + landmark solve for Hopper.
//
// Replaces the Pallas TPU kernel liwslam/ops/cam_solve.py::lm_solve_cam
// (_kernel :71).  Its plain PyTorch version is
// liwslam_torch/ops/cam_solve.py::lm_solve_cam_plain (which runs
// liwslam_torch/solve/cam_schur.py).
//
// What it computes, for each of B independent systems (one thread block
// each; the camera path launches B = 1): Levenberg-Marquardt over the
// 30-dim [frame 0 frozen pose | camera frame] window and F landmarks.
//   base rows: IMU 15, wheel 3, ground 4, prior 15 (kernel B1's rows, from
//     solve_common.cuh; no laser rows in the camera sub-step);
//   camera rows: whitened reprojections of landmark f in window slot w on
//     the (Wc, F) grid, slot Wc-1 at the free camera pose x[15:21], older
//     slots at the frozen ring poses, masked by `use`; landmark columns
//     masked by `lm_free`;
//   each step: H = J^T J of the base rows with columns masked by `free`,
//     plus the camera rows' 6x6 pose block; damping lam*max(diag,1e-12),
//     identity rows for frozen dims; 3x3 landmark blocks damped the same
//     way (identity for frozen landmarks), inverted by the adjugate with
//     |det| < 1e-30 -> 1e-30; the landmark Schur complement subtracted
//     from the pose block; an equilibrated 30x30 Cholesky that skips the
//     statically frozen dims; a zero pose step when it is non-finite; the
//     landmark back-substitution (a non-finite entry becomes 0, frozen
//     landmarks do not move); SO(3) wrap of x[3:6] and x[18:21];
//   accept when the trial cost is lower; lambda x0.33 / x4 in
//     [1e-10, 1e8]; exit on ftol, on xtol over the pose and landmark steps
//     and states, or on a rejected step with lambda at its maximum;
//   then the Schur reduction of frame 0 out of the base rows' normal
//     equations at the last accepted point: (dH, dg) for the prior.
//
// What bounds it on this card: nothing the card is rated for.  At F = 48,
// Wc = 8 one linearization is ~0.5 MFLOP (base rows as in B1, 384 camera
// cells of two dual-number passes, the landmark blocks) and one step a
// 30x30 factorization, on ~15 KB of inputs: tens of nanoseconds at the
// card's float32 rate.  The time is the dependent chain inside the block:
// linearize, barrier, landmark blocks, barrier, factor on one thread,
// barrier, back-substitute, barrier, up to max_iters times.
//
// What the design does about it: one launch for the whole solve and the
// prior, every intermediate in shared memory.  Warp 0 runs the base rows
// while warps 1-7 run one camera cell per thread (6 pose tangents for the
// current slot, 3 landmark tangents for every slot); one thread per
// landmark forms its 3x3 block, gradient and 6x3 coupling, inverts its
// damped block and forms its share of the Schur terms; per-landmark
// shares are summed by one thread per entry.  The 30x30 factorization and
// solves run on one thread as in B1.  A parallel Cholesky and many systems
// per block are later work.
//
// Limits: F <= 256 landmarks (one thread each), Wc <= 32 window slots, and
// the dynamic shared memory 4 * (FIXED + 8 F Wc + 131 F) bytes <= 227 KB
// (about 54 KB at F = 48, Wc = 8).

#include "solve_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int F_MAX = 256;
constexpr int WC_MAX = 32;
constexpr int FIXED = 4160;  // floats of the fixed part of the shared layout
constexpr int SMEM_MAX = 232448;
constexpr int P0 = 15;  // camera-frame pose block x[15:21]

// per-system camera inputs
struct Cam {
  const float* Tic;     // (4,4)
  const float* si;      // (2,) fx / camera_sigma
  const float* world0;  // (F,3)
  const float* lmf;     // (F,) 1 free / 0 frozen
  const float* obs;     // (F,Wc,2)
  const float* use;     // (F,Wc)
  const float* ring;    // (Wc,6) [p, q]
  int F, Wc;
};

// one linearization's reduced normal equations
struct Lin {
  float* Hb;   // (30,30) base rows, unmasked J^T J
  float* gb;   // (30,)   -J^T r
  float* Hc;   // (6,6)   camera rows' pose block
  float* gc;   // (6,)
  float* Hll;  // (6,F)   landmark blocks 00 01 02 11 12 22
  float* gl;   // (3,F)
  float* Hpl;  // (18,F)  coupling [pose k][landmark a] at k*3+a
  float* cost; // [0] base, [1] camera (halves of the sums of squares)
};

// the shared layout, carved from dynamic shared memory
struct Sm {
  float *x, *xt, *dx, *free;
  float* Jnl;  // (R_NL, D)
  float* rnl;
  float* A;    // (D, D) factorization scratch
  float* scal; // c, lam, done, accept, iteration terms
  float* ES;   // (27,) Schur terms E (21 upper entries) and c6 (6)
  float *cr, *cJw, *cJp;  // cells: r (2,FW), Jw (6,FW), Jp (12,F) for slot Wc-1
  float *wld, *wt, *dxl, *lmf;  // (3,F) x3, (F,)
  float *Hinv, *K, *glA;        // (6,F), (18,F), (3,F)
  float* part;                  // (28,F) per-landmark shares
  Lin acc, trial;
};

__device__ __forceinline__ float* carve(float*& p, int n) {
  float* r = p;
  p += n;
  return r;
}

__device__ Sm layout(float* base, int F, int Wc) {
  Sm s;
  float* p = base;
  s.x = carve(p, D);
  s.xt = carve(p, D);
  s.dx = carve(p, D);
  s.free = carve(p, D);
  s.Jnl = carve(p, R_NL * D);
  s.rnl = carve(p, R_NL);
  s.A = carve(p, D * D);
  s.scal = carve(p, 16);
  s.ES = carve(p, 27);
  Lin* ls[2] = {&s.acc, &s.trial};
  for (Lin* l : ls) {
    l->Hb = carve(p, D * D);
    l->gb = carve(p, D);
    l->Hc = carve(p, 36);
    l->gc = carve(p, 6);
    l->cost = carve(p, 2);
  }
  p = base + FIXED;
  const int FW = F * Wc;
  s.cr = carve(p, 2 * FW);
  s.cJw = carve(p, 6 * FW);
  s.cJp = carve(p, 12 * F);
  s.wld = carve(p, 3 * F);
  s.wt = carve(p, 3 * F);
  s.dxl = carve(p, 3 * F);
  s.lmf = carve(p, F);
  for (Lin* l : ls) {
    l->Hll = carve(p, 6 * F);
    l->gl = carve(p, 3 * F);
    l->Hpl = carve(p, 18 * F);
  }
  s.Hinv = carve(p, 6 * F);
  s.K = carve(p, 18 * F);
  s.glA = carve(p, 3 * F);
  s.part = carve(p, 28 * F);
  return s;
}

// whitened reprojection rows (camera_factor.h:36-67) of world point wp seen
// from the IMU-frame pose (p, q): R_wc = R(q) Ric, t_wc = p + R(q) tic,
// cam = R_wc^T (wp - t_wc), r = si * (obs - cam.xy / z), |z| < 1e-9 -> 1e-9
__device__ void cam_rows(const V3& p, const V3& q, const V3& wp, const F3& Ric, const float* tic,
                         float ox, float oy, float si0, float si1, Dual* r) {
  const M3 R = exp_so3(q);
  const M3 Rwc = mmf(R, Ric);
  const V3 u = wp - (mvf(R, tic) + p);
  const Dual cx = Rwc.a[0][0] * u.x + Rwc.a[1][0] * u.y + Rwc.a[2][0] * u.z;
  const Dual cy = Rwc.a[0][1] * u.x + Rwc.a[1][1] * u.y + Rwc.a[2][1] * u.z;
  Dual z = Rwc.a[0][2] * u.x + Rwc.a[1][2] * u.y + Rwc.a[2][2] * u.z;
  if (fabsf(z.v) < 1e-9f) z = cst(1e-9f);
  r[0] = si0 * (ox - cx / z);
  r[1] = si1 * (oy - cy / z);
}

// linearization at (xs, wl) into `out`; all threads take part
__device__ void linearize(const Sys& s, const Cam& cm, const float* xs, const float* wl, Sm& sm,
                          const Lin& out) {
  const int tid = threadIdx.x;
  const int F = cm.F, Wc = cm.Wc, FW = F * Wc;
  for (int e = tid; e < R_NL * D; e += THREADS) sm.Jnl[e] = 0.f;
  __syncthreads();
  if (tid < 32) {
    base_rows(s, xs, tid, reinterpret_cast<float (*)[D]>(sm.Jnl), sm.rnl);
  } else {
    const F3 Ric = rot_of(cm.Tic);
    const float tic[3] = {cm.Tic[3], cm.Tic[7], cm.Tic[11]};
    const float si0 = cm.si[0], si1 = cm.si[1];
    for (int cell = tid - 32; cell < FW; cell += THREADS - 32) {
      const int w = cell / F, f = cell % F;
      const bool cur = w == Wc - 1;
      const float use = cm.use[f * Wc + w];
      if (use == 0.f) {
        sm.cr[cell] = sm.cr[FW + cell] = 0.f;
        for (int k = 0; k < 6; ++k) sm.cJw[k * FW + cell] = 0.f;
        if (cur)
          for (int k = 0; k < 12; ++k) sm.cJp[k * F + f] = 0.f;
        continue;
      }
      const float ox = cm.obs[(f * Wc + w) * 2], oy = cm.obs[(f * Wc + w) * 2 + 1];
      const float* pq = cur ? xs + P0 : cm.ring + 6 * w;
      // landmark tangents (columns 0..2 of the dual)
      V3 wp = v3(cst(wl[f]), cst(wl[F + f]), cst(wl[2 * F + f]));
      wp.x.d[0] = wp.y.d[1] = wp.z.d[2] = 1.f;
      Dual r[2];
      cam_rows(v3(cst(pq[0]), cst(pq[1]), cst(pq[2])), v3(cst(pq[3]), cst(pq[4]), cst(pq[5])), wp,
               Ric, tic, ox, oy, si0, si1, r);
      const float lf = sm.lmf[f];
      for (int e = 0; e < 2; ++e) {
        sm.cr[e * FW + cell] = r[e].v * use;
        for (int a = 0; a < 3; ++a) sm.cJw[(3 * e + a) * FW + cell] = r[e].d[a] * use * lf;
      }
      if (cur) {
        // pose tangents on x[15:21]
        Dual rp[2];
        cam_rows(X3(xs, P0, P0), X3(xs, P0 + 3, P0),
                 v3(cst(wl[f]), cst(wl[F + f]), cst(wl[2 * F + f])), Ric, tic, ox, oy, si0, si1, rp);
        for (int e = 0; e < 2; ++e)
          for (int k = 0; k < 6; ++k) sm.cJp[(6 * e + k) * F + f] = rp[e].d[k] * use;
      }
    }
  }
  __syncthreads();
  // base normal equations: each thread owns entries of H, g and the cost
  for (int e = tid; e < D * D + D + 1; e += THREADS) {
    if (e < D * D) {
      const int i = e / D, j = e % D;
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.Jnl[r * D + i] * sm.Jnl[r * D + j];
      out.Hb[e] = acc;
    } else if (e < D * D + D) {
      const int i = e - D * D;
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.Jnl[r * D + i] * sm.rnl[r];
      out.gb[i] = -acc;
    } else {
      float acc = 0.f;
      for (int r = 0; r < R_NL; ++r) acc += sm.rnl[r] * sm.rnl[r];
      out.cost[0] = 0.5f * acc;
    }
  }
  // landmark blocks and each landmark's share of the pose block
  if (tid < F) {
    const int f = tid;
    float hll[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gl[3] = {0.f, 0.f, 0.f}, cost = 0.f;
    for (int w = 0; w < Wc; ++w) {
      const int cell = w * F + f;
      const float r0 = sm.cr[cell], r1 = sm.cr[FW + cell];
      float jw[2][3];
      for (int e = 0; e < 2; ++e)
        for (int a = 0; a < 3; ++a) jw[e][a] = sm.cJw[(3 * e + a) * FW + cell];
      cost += r0 * r0 + r1 * r1;
      int q = 0;
      for (int a = 0; a < 3; ++a) {
        for (int b = a; b < 3; ++b) hll[q++] += jw[0][a] * jw[0][b] + jw[1][a] * jw[1][b];
        gl[a] -= jw[0][a] * r0 + jw[1][a] * r1;
      }
    }
    const int cell = (Wc - 1) * F + f;
    const float r0 = sm.cr[cell], r1 = sm.cr[FW + cell];
    float jp[2][6], jw[2][3];
    for (int e = 0; e < 2; ++e) {
      for (int k = 0; k < 6; ++k) jp[e][k] = sm.cJp[(6 * e + k) * F + f];
      for (int a = 0; a < 3; ++a) jw[e][a] = sm.cJw[(3 * e + a) * FW + cell];
    }
    for (int q = 0; q < 6; ++q) out.Hll[q * F + f] = hll[q];
    for (int a = 0; a < 3; ++a) out.gl[a * F + f] = gl[a];
    for (int k = 0; k < 6; ++k)
      for (int a = 0; a < 3; ++a)
        out.Hpl[(3 * k + a) * F + f] = jp[0][k] * jw[0][a] + jp[1][k] * jw[1][a];
    int q = 0;
    for (int k = 0; k < 6; ++k)
      for (int l = k; l < 6; ++l) sm.part[(q++) * F + f] = jp[0][k] * jp[0][l] + jp[1][k] * jp[1][l];
    for (int k = 0; k < 6; ++k) sm.part[(21 + k) * F + f] = -(jp[0][k] * r0 + jp[1][k] * r1);
    sm.part[27 * F + f] = cost;
  }
  __syncthreads();
  if (tid < 28) {
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc += sm.part[tid * F + f];
    if (tid < 21) {
      // upper entry q -> (k, l)
      int k = 0, q = tid;
      while (q >= 6 - k) {
        q -= 6 - k;
        ++k;
      }
      const int l = k + q;
      out.Hc[k * 6 + l] = acc;
      out.Hc[l * 6 + k] = acc;
    } else if (tid < 27) {
      out.gc[tid - 21] = acc;
    } else {
      out.cost[1] = 0.5f * acc;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) cam_solve_kernel(
    const float* __restrict__ x0, const float* __restrict__ free_, const float* __restrict__ imu_J,
    const float* __restrict__ imu_sqrtP, const float* __restrict__ imu_X,
    const float* __restrict__ prior_J, const float* __restrict__ prior_X,
    const float* __restrict__ T_il, const float* __restrict__ T_iw,
    const float* __restrict__ wheel, const float* __restrict__ scal,
    const float* __restrict__ Tic, const float* __restrict__ sqrt_info,
    const float* __restrict__ world0, const float* __restrict__ lm_free,
    const float* __restrict__ obs, const float* __restrict__ use, const float* __restrict__ ring,
    int F, int Wc, int max_iters, uint32_t frozen, float ftol, float xtol,
    float* __restrict__ x_out, float* __restrict__ world_out, float* __restrict__ cost_out,
    float* __restrict__ dH_out, float* __restrict__ dg_out, int* __restrict__ iters_out) {
  extern __shared__ float smem[];
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
  s.laser = nullptr;
  Cam cm;
  cm.Tic = Tic + b * 16;
  cm.si = sqrt_info + b * 2;
  cm.world0 = world0 + (size_t)b * F * 3;
  cm.lmf = lm_free + (size_t)b * F;
  cm.obs = obs + (size_t)b * F * Wc * 2;
  cm.use = use + (size_t)b * F * Wc;
  cm.ring = ring + (size_t)b * Wc * 6;
  cm.F = F;
  cm.Wc = Wc;
  Sm sm = layout(smem, F, Wc);
  float& c = sm.scal[0];
  float& lam = sm.scal[1];
  float& done = sm.scal[2];
  float& accept = sm.scal[3];
  float& rel = sm.scal[4];

  if (tid < D) {
    sm.x[tid] = s.x0[tid];
    sm.free[tid] = s.free[tid];
  }
  for (int e = tid; e < 3 * F; e += THREADS) sm.wld[(e % 3) * F + e / 3] = cm.world0[e];
  for (int f = tid; f < F; f += THREADS) sm.lmf[f] = cm.lmf[f];
  if (tid == 0) {
    lam = 1e-4f;
    done = 0.f;
  }
  __syncthreads();
  linearize(s, cm, sm.x, sm.wld, sm, sm.acc);
  if (tid == 0) c = sm.acc.cost[0] + sm.acc.cost[1];
  __syncthreads();

  int it = 0;
  for (; it < max_iters; ++it) {
    if (done != 0.f) break;
    // landmark blocks: damp, invert, Schur shares
    if (tid < F) {
      const int f = tid;
      const bool lmb = sm.lmf[f] > 0.f;
      const float* h = sm.acc.Hll;
      const float l = lam;
      float dL[3];
      const int dq[3] = {0, 3, 5};
      for (int a = 0; a < 3; ++a) {
        const float v = h[dq[a] * F + f];
        dL[a] = lmb ? v + l * fmaxf(v, 1e-12f) : 1.f;
      }
      const float a_ = dL[0], e_ = dL[1], i_ = dL[2];
      const float b_ = lmb ? h[1 * F + f] : 0.f;
      const float c_ = lmb ? h[2 * F + f] : 0.f;
      const float f_ = lmb ? h[4 * F + f] : 0.f;
      const float cA = e_ * i_ - f_ * f_;
      const float cB = -(b_ * i_ - f_ * c_);
      const float cC = b_ * f_ - e_ * c_;
      float det = a_ * cA + b_ * cB + c_ * cC;
      if (fabsf(det) < 1e-30f) det = 1e-30f;
      float hi[3][3];
      hi[0][0] = cA / det;
      hi[0][1] = hi[1][0] = cB / det;
      hi[0][2] = hi[2][0] = cC / det;
      hi[1][1] = (a_ * i_ - c_ * c_) / det;
      hi[1][2] = hi[2][1] = -(a_ * f_ - c_ * b_) / det;
      hi[2][2] = (a_ * e_ - b_ * b_) / det;
      const int iq[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
      for (int a = 0; a < 3; ++a)
        for (int bb = a; bb < 3; ++bb) sm.Hinv[iq[a][bb] * F + f] = hi[a][bb];
      float glA[3];
      for (int a = 0; a < 3; ++a) {
        glA[a] = lmb ? sm.acc.gl[a * F + f] : 0.f;
        sm.glA[a * F + f] = glA[a];
      }
      float hpl[6][3], K[6][3];
      for (int k = 0; k < 6; ++k)
        for (int a = 0; a < 3; ++a) hpl[k][a] = sm.acc.Hpl[(3 * k + a) * F + f];
      for (int k = 0; k < 6; ++k)
        for (int bb = 0; bb < 3; ++bb) {
          K[k][bb] = hpl[k][0] * hi[0][bb] + hpl[k][1] * hi[1][bb] + hpl[k][2] * hi[2][bb];
          sm.K[(3 * k + bb) * F + f] = K[k][bb];
        }
      int q = 0;
      for (int k = 0; k < 6; ++k)
        for (int g = k; g < 6; ++g)
          sm.part[(q++) * F + f] = K[k][0] * hpl[g][0] + K[k][1] * hpl[g][1] + K[k][2] * hpl[g][2];
      for (int k = 0; k < 6; ++k)
        sm.part[(21 + k) * F + f] = K[k][0] * glA[0] + K[k][1] * glA[1] + K[k][2] * glA[2];
    }
    __syncthreads();
    if (tid < 27) {
      float acc = 0.f;
      for (int f = 0; f < F; ++f) acc += sm.part[tid * F + f];
      sm.ES[tid] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      // damped, Schur-reduced, Jacobi-equilibrated normal equations
      float(*A)[D] = reinterpret_cast<float (*)[D]>(sm.A);
      float sc[D], rhs[D];
      for (int i = 0; i < D; ++i) {
        const bool fi = sm.free[i] > 0.f;
        const bool ci = i >= P0 && i < P0 + 6;
        for (int j = 0; j < D; ++j) {
          const bool cj = j >= P0 && j < P0 + 6;
          const float hc = (ci && cj) ? sm.acc.Hc[(i - P0) * 6 + (j - P0)] : 0.f;
          A[i][j] = (sm.acc.Hb[i * D + j] * (sm.free[i] * sm.free[j]) + hc) * (sm.free[i] * sm.free[j]);
        }
        const float dg = A[i][i];
        A[i][i] = fi ? dg + lam * fmaxf(dg, 1e-12f) : 1.f;
        rhs[i] = fi ? sm.acc.gb[i] * sm.free[i] + (ci ? sm.acc.gc[i - P0] : 0.f) : 0.f;
      }
      int q = 0;
      for (int k = 0; k < 6; ++k)
        for (int g = k; g < 6; ++g) {
          A[P0 + k][P0 + g] -= sm.ES[q];
          if (g != k) A[P0 + g][P0 + k] -= sm.ES[q];
          ++q;
        }
      for (int k = 0; k < 6; ++k) rhs[P0 + k] -= sm.ES[21 + k];
      for (int i = 0; i < D; ++i) sc[i] = 1.f / sqrtf(fmaxf(A[i][i], 1e-20f));
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j <= i; ++j) A[i][j] *= sc[i] * sc[j];
        rhs[i] *= sc[i];
      }
      cholesky(A, D, frozen);
      chol_solve(A, D, frozen, rhs);
      bool finite = true;
      for (int i = 0; i < D; ++i) {
        sm.dx[i] = sc[i] * rhs[i];
        finite = finite && isfinite(sm.dx[i]);
      }
      for (int i = 0; i < D; ++i) {
        sm.dx[i] = finite ? sm.dx[i] * sm.free[i] : 0.f;
        sm.xt[i] = sm.x[i] + sm.dx[i];
      }
      const float s1 = so3_wrap_scale(sm.xt + 3), s2 = so3_wrap_scale(sm.xt + 18);
      for (int k = 0; k < 3; ++k) {
        sm.xt[3 + k] *= s1;
        sm.xt[18 + k] *= s2;
      }
    }
    __syncthreads();
    // landmark back-substitution
    if (tid < F) {
      const int f = tid;
      const float lf = sm.lmf[f];
      float rhs[3];
      for (int a = 0; a < 3; ++a) {
        float acc = sm.glA[a * F + f];
        for (int k = 0; k < 6; ++k) acc -= sm.acc.Hpl[(3 * k + a) * F + f] * sm.dx[P0 + k];
        rhs[a] = acc;
      }
      const int iq[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
      for (int a = 0; a < 3; ++a) {
        float d = 0.f;
        for (int bb = 0; bb < 3; ++bb) d += sm.Hinv[iq[a][bb] * F + f] * rhs[bb];
        d *= lf;
        if (!isfinite(d)) d = 0.f;
        sm.dxl[a * F + f] = d;
        sm.wt[a * F + f] = sm.wld[a * F + f] + d;
      }
    }
    __syncthreads();
    linearize(s, cm, sm.xt, sm.wt, sm, sm.trial);
    if (tid == 0) {
      const float ct = sm.trial.cost[0] + sm.trial.cost[1];
      const bool acc = ct < c;
      rel = fabsf(c - ct) / fmaxf(c, 1e-20f);
      if (acc) c = ct;
      float lam_n = acc ? lam * 0.33f : lam * 4.f;
      lam = fminf(fmaxf(lam_n, 1e-10f), 1e8f);
      accept = acc ? 1.f : 0.f;
    }
    __syncthreads();
    if (accept != 0.f) {
      const Lin& a = sm.acc;
      const Lin& t = sm.trial;
      for (int e = tid; e < D * D; e += THREADS) a.Hb[e] = t.Hb[e];
      if (tid < D) {
        a.gb[tid] = t.gb[tid];
        sm.x[tid] = sm.xt[tid];
      }
      if (tid < 36) a.Hc[tid] = t.Hc[tid];
      if (tid < 6) a.gc[tid] = t.gc[tid];
      if (tid < 2) a.cost[tid] = t.cost[tid];
      for (int e = tid; e < 27 * F; e += THREADS) {
        if (e < 6 * F) a.Hll[e] = t.Hll[e];
        else if (e < 9 * F) a.gl[e - 6 * F] = t.gl[e - 6 * F];
        else a.Hpl[e - 9 * F] = t.Hpl[e - 9 * F];
      }
      for (int e = tid; e < 3 * F; e += THREADS) sm.wld[e] = sm.wt[e];
    }
    __syncthreads();
    if (tid == 0) {
      float mdx = 0.f, mx = 0.f;
      for (int i = 0; i < D; ++i) {
        mdx = fmaxf(mdx, fabsf(sm.dx[i]));
        mx = fmaxf(mx, fabsf(sm.x[i]));
      }
      for (int e = 0; e < 3 * F; ++e) {
        mdx = fmaxf(mdx, fabsf(sm.dxl[e]));
        mx = fmaxf(mx, fabsf(sm.wld[e]));
      }
      const bool xtol_hit = mdx < xtol * (mx + xtol);
      const bool stalled = accept == 0.f && lam >= 1e8f;
      done = (rel < ftol || xtol_hit || stalled) ? 1.f : 0.f;
    }
    __syncthreads();
  }

  // Schur reduction of frame 0 at the last accepted point (base rows only)
  if (tid == 0) {
    schur_frame0(reinterpret_cast<float (*)[D]>(sm.acc.Hb), sm.acc.gb,
                 reinterpret_cast<float (*)[D]>(sm.A), dH_out + b * 225, dg_out + b * 15);
    for (int i = 0; i < D; ++i) x_out[b * D + i] = sm.x[i];
    cost_out[b] = c;
    iters_out[b] = it;
  }
  for (int e = tid; e < 3 * F; e += THREADS)
    world_out[(size_t)b * F * 3 + e] = sm.wld[(e % 3) * F + e / 3];
}

}  // namespace

// C interface (ctypes).  Inputs are contiguous float32 device arrays with a
// leading batch dim B: the base rows' x0 (B,30), free (B,30), imu_J,
// imu_sqrtP (B,15,15), imu_X (B,15), prior_J (B,15,15), prior_X (B,15),
// T_il, T_iw (B,4,4), wheel (B,9), scal (B,6) (ops/track_solve layout), and
// the camera's Tic (B,4,4), sqrt_info (B,2), world0 (B,F,3), lm_free (B,F),
// obs (B,F,Wc,2), use (B,F,Wc), ring (B,Wc,6).  Outputs x (B,30),
// world (B,F,3), cost (B,), dH (B,15,15), dg (B,15), iters (B,) int32.
// Launches B blocks on `stream` and returns the launch's cudaError_t.
extern "C" int liwslam_cam_solve(const float* x0, const float* free_, const float* imu_J,
                                 const float* imu_sqrtP, const float* imu_X, const float* prior_J,
                                 const float* prior_X, const float* T_il, const float* T_iw,
                                 const float* wheel, const float* scal, const float* Tic,
                                 const float* sqrt_info, const float* world0, const float* lm_free,
                                 const float* obs, const float* use, const float* ring, int B,
                                 int F, int Wc, int max_iters, int frozen, float ftol, float xtol,
                                 float* x_out, float* world_out, float* cost_out, float* dH_out,
                                 float* dg_out, int* iters_out, void* stream) {
  const size_t bytes = sizeof(float) * ((size_t)FIXED + 8 * (size_t)F * Wc + 131 * (size_t)F);
  if (B < 1 || F < 1 || F > F_MAX || Wc < 1 || Wc > WC_MAX || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(cam_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  cam_solve_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      x0, free_, imu_J, imu_sqrtP, imu_X, prior_J, prior_X, T_il, T_iw, wheel, scal, Tic,
      sqrt_info, world0, lm_free, obs, use, ring, F, Wc, max_iters, (uint32_t)frozen, ftol, xtol,
      x_out, world_out, cost_out, dH_out, dg_out, iters_out);
  return (int)cudaGetLastError();
}
