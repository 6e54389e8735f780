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
// cells of a dual-number pass each and 96 pose passes, the landmark
// blocks) and one step a 30x30 factorization, on ~15 KB of inputs: tens of
// nanoseconds at the card's float32 rate.  The time is the length of the
// dependent chain inside the block: linearize, landmark blocks, factor,
// back-substitute, up to max_iters times, so what counts is the latency
// of each link.
//
// What the design does about it: one launch for the whole solve and the
// prior, every intermediate in shared memory or registers, and every link
// spread over the block (256 threads) so that no thread runs a long serial
// loop:
//   - linearization: warps 0-4 run the base rows, one factor kind a warp
//     and one tangent column a lane (solve_common.cuh), and warps 3-7 the
//     camera work items, one dual-number pass (width 3) a thread: a
//     landmark pass for every (slot, landmark) cell and a p pass and a q
//     pass for every landmark of the current slot; one thread a landmark then
//     forms its 3x3 block, gradient and 6x3 coupling and its shares of the
//     pose block, summed by warp shuffles and one block step;
//   - each LM step: one thread a landmark damps and inverts its block and
//     forms its shares of the Schur terms (summed the same way); warp 0
//     builds the damped, Schur-reduced, equilibrated 30x30 a row a lane and
//     factors and solves it with the warp-parallel Cholesky of
//     solve_common.cuh; one thread a landmark back-substitutes;
//   - the convergence maxima over the pose and the landmarks are warp
//     reductions and one block step; the accepted linearization and
//     landmarks are kept by flipping between two buffers, not by copying;
//   - the Schur reduction of frame 0 is B1's (schur_frame0).
// Where the time goes now (a camera sub-step of the main path, F = 48,
// Wc = 8; H100, chip_smoke.py's iteration_split over max_iters = 0..8):
// ~0.019 ms fixed (the first linearization and the Schur reduction) and
// ~0.022 ms an LM iteration.
//
// Limits: F <= F_MAX landmarks (one thread each), Wc <= WC_MAX window
// slots, and the dynamic shared memory
// 4 * (FIXED + PER_FW * F * Wc + PER_F * F) bytes <= SMEM_MAX (about 51 KB
// at F = 48, Wc = 8); ops/cam_solve.py holds the same numbers.

#include "solve_common.cuh"

namespace {

constexpr int F_MAX = 256;
constexpr int WC_MAX = 32;
constexpr int FIXED = 5712;  // floats of the fixed part of the shared layout (struct Fixed)
constexpr int PER_FW = 8;    // floats a (slot, landmark) cell: r (2), landmark tangents (6)
constexpr int PER_F = 85;    // floats a landmark (struct Lm)
constexpr int SMEM_MAX = 232448;
constexpr int P0 = 15;  // camera-frame pose block x[15:21]
constexpr int CAM_WARP0 = 3;  // the camera items run on warps 3-7

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

// the fixed part of the shared layout
struct Fixed {
  BaseSm b;
  float Hb[2][D * D], gb[2][D];  // base rows: unmasked J^T J, -J^T r ([cur] accepted, [cur ^ 1] trial)
  float Hc[2][36], gc[2][6];     // camera rows' pose block
  float cost[2][2];              // [k][0] base, [k][1] camera (halves of the sums of squares)
  float x[D], xt[D], dx[D], free[D];
  float ES[27];                  // Schur terms: E (21 upper entries), c6 (6)
  float mred[NWARPS][2];         // per-warp maxima of the steps and the states
  float c, lam;
  int done, cur;
};
static_assert(sizeof(Fixed) <= 4 * FIXED, "FIXED is smaller than struct Fixed");
static_assert(FIXED % 4 == 0, "the per-landmark part must stay 16-byte aligned");

// the per-landmark part of the shared layout, FIXED floats in; landmark
// arrays are (k, F), cell arrays (k, F * Wc), cell = w * F + f
struct Lm {
  float* cr;      // (2, FW) camera residuals
  float* cJw;     // (6, FW) their landmark tangents
  float* cJp;     // (12, F) pose tangents of the current slot's rows
  float* wl[2];   // (3, F) landmark positions [cur] accepted, [cur ^ 1] trial
  float* dxl;     // (3, F) landmark step
  float* lmf;     // (F,)
  float* Hll[2];  // (6, F) landmark blocks 00 01 02 11 12 22
  float* gl[2];   // (3, F)
  float* Hpl[2];  // (18, F) coupling [pose k][landmark a] at k*3+a
  float* Hinv;    // (6, F) damped inverse
  float* glA;     // (3, F) masked gradient
};

__device__ __forceinline__ Lm lm_layout(float* smem, int F, int Wc) {
  Lm l;
  float* p = smem + FIXED;
  const int FW = F * Wc;
  l.cr = p; p += 2 * FW;
  l.cJw = p; p += 6 * FW;
  l.cJp = p; p += 12 * F;
  l.wl[0] = p; p += 3 * F;
  l.wl[1] = p; p += 3 * F;
  l.dxl = p; p += 3 * F;
  l.lmf = p; p += F;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    l.Hll[k] = p; p += 6 * F;
    l.gl[k] = p; p += 3 * F;
    l.Hpl[k] = p; p += 18 * F;
  }
  l.Hinv = p; p += 6 * F;
  l.glA = p;
  return l;
}

// whitened reprojection rows (camera_factor.h:36-67) of world point wp seen
// from the IMU-frame pose (p, q): R_wc = R(q) Ric, t_wc = p + R(q) tic,
// cam = R_wc^T (wp - t_wc), r = si * (obs - cam.xy / z), |z| < 1e-9 -> 1e-9
template <int W>
__device__ __forceinline__ void cam_rows(const V3<W>& p, const V3<W>& q, const V3<W>& wp, const F3& Ric,
                                         const float* tic, float ox, float oy, float si0, float si1,
                                         DualT<W>* r) {
  using Dual = DualT<W>;
  const M3<W> R = exp_so3(q);
  const M3<W> Rwc = mmf(R, Ric);
  const V3<W> u = wp - (mvf(R, tic) + p);
  const Dual cx = Rwc.a[0][0] * u.x + Rwc.a[1][0] * u.y + Rwc.a[2][0] * u.z;
  const Dual cy = Rwc.a[0][1] * u.x + Rwc.a[1][1] * u.y + Rwc.a[2][1] * u.z;
  Dual z = Rwc.a[0][2] * u.x + Rwc.a[1][2] * u.y + Rwc.a[2][2] * u.z;
  if (fabsf(z.v) < 1e-9f) z = cst<W>(1e-9f);
  r[0] = si0 * (ox - cx / z);
  r[1] = si1 * (oy - cy / z);
}

// linearization at (xs, wl) into buffer k; all threads take part
__device__ void linearize(const Sys& s, const Cam& cm, const float* xs, const float* wl, float* smem,
                          int k) {
  Fixed& fx = *reinterpret_cast<Fixed*>(smem);
  const Lm L = lm_layout(smem, cm.F, cm.Wc);
  const int tid = threadIdx.x;
  const int F = cm.F, Wc = cm.Wc, FW = F * Wc;
  if (tid < 32 * BASE_WARPS) base_rows(s, xs, fx.b);
  if (tid >= 32 * CAM_WARP0) {
    const F3 Ric = rot_of(cm.Tic);
    const float tic[3] = {cm.Tic[3], cm.Tic[7], cm.Tic[11]};
    const float si0 = cm.si[0], si1 = cm.si[1];
    // items, dual numbers of width 3: a landmark pass for every cell,
    // then two pose passes (p, q) for every landmark of the current slot,
    // on warps CAM_WARP0.. (the IMU and wheel warps have the longest rows)
    for (int item = THREADS - 1 - tid; item < FW + 2 * F; item += THREADS - 32 * CAM_WARP0) {
      const int part = item < FW ? -1 : (item - FW) / F;  // -1 landmark, 0 p, 1 q
      const int cell = part < 0 ? item : (Wc - 1) * F + (item - FW) % F;
      const int w = cell / F, f = cell % F;
      const float use = cm.use[f * Wc + w];
      if (use == 0.f) {
        if (part >= 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int a = 0; a < 3; ++a) L.cJp[(6 * e + 3 * part + a) * F + f] = 0.f;
        } else {
          L.cr[cell] = L.cr[FW + cell] = 0.f;
#pragma unroll
          for (int q = 0; q < 6; ++q) L.cJw[q * FW + cell] = 0.f;
        }
        continue;
      }
      const float ox = cm.obs[(f * Wc + w) * 2], oy = cm.obs[(f * Wc + w) * 2 + 1];
      const float* pq = w == Wc - 1 ? xs + P0 : cm.ring + 6 * w;
      V3<3> p = v3(cst<3>(pq[0]), cst<3>(pq[1]), cst<3>(pq[2]));
      V3<3> q = v3(cst<3>(pq[3]), cst<3>(pq[4]), cst<3>(pq[5]));
      V3<3> wp = v3(cst<3>(wl[f]), cst<3>(wl[F + f]), cst<3>(wl[2 * F + f]));
      // tangents: on the landmark, or on x[15:18], or on x[18:21]
      wp.x.d[0] = wp.y.d[1] = wp.z.d[2] = part < 0 ? 1.f : 0.f;
      p.x.d[0] = p.y.d[1] = p.z.d[2] = part == 0 ? 1.f : 0.f;
      q.x.d[0] = q.y.d[1] = q.z.d[2] = part == 1 ? 1.f : 0.f;
      DualT<3> r[2];
      cam_rows(p, q, wp, Ric, tic, ox, oy, si0, si1, r);
      if (part >= 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int a = 0; a < 3; ++a) L.cJp[(6 * e + 3 * part + a) * F + f] = r[e].d[a] * use;
      } else {
        const float lf = L.lmf[f];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          L.cr[e * FW + cell] = r[e].v * use;
#pragma unroll
          for (int a = 0; a < 3; ++a) L.cJw[(3 * e + a) * FW + cell] = r[e].d[a] * use * lf;
        }
      }
    }
  }
  __syncthreads();
  whiten(fx.b);
  // landmark blocks and each landmark's shares of the pose block: 21 upper
  // entries, 6 of -J^T r, the camera cost
  float v[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) v[q] = 0.f;
  if (tid < F) {
    const int f = tid;
    float hll[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gl[3] = {0.f, 0.f, 0.f}, cost = 0.f;
    for (int w = 0; w < Wc; ++w) {
      const int cell = w * F + f;
      const float r0 = L.cr[cell], r1 = L.cr[FW + cell];
      float jw[2][3];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int a = 0; a < 3; ++a) jw[e][a] = L.cJw[(3 * e + a) * FW + cell];
      cost += r0 * r0 + r1 * r1;
      int q = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int bb = a; bb < 3; ++bb) hll[q++] += jw[0][a] * jw[0][bb] + jw[1][a] * jw[1][bb];
        gl[a] -= jw[0][a] * r0 + jw[1][a] * r1;
      }
    }
    const int cell = (Wc - 1) * F + f;
    const float r0 = L.cr[cell], r1 = L.cr[FW + cell];
    float jp[2][6], jw[2][3];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int j = 0; j < 6; ++j) jp[e][j] = L.cJp[(6 * e + j) * F + f];
#pragma unroll
      for (int a = 0; a < 3; ++a) jw[e][a] = L.cJw[(3 * e + a) * FW + cell];
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) L.Hll[k][q * F + f] = hll[q];
#pragma unroll
    for (int a = 0; a < 3; ++a) L.gl[k][a * F + f] = gl[a];
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        L.Hpl[k][(3 * j + a) * F + f] = jp[0][j] * jw[0][a] + jp[1][j] * jw[1][a];
    int q = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int l = j; l < 6; ++l) v[q++] = jp[0][j] * jp[0][l] + jp[1][j] * jp[1][l];
#pragma unroll
    for (int j = 0; j < 6; ++j) v[21 + j] = -(jp[0][j] * r0 + jp[1][j] * r1);
    v[27] = cost;
  }
  warp_partials<NQ>(v, fx.b);
  __syncthreads();
  // base normal equations (lower triangle, mirrored), the camera pose
  // block; one entry a thread
  float* Hb = fx.Hb[k];
  constexpr int NT = D * (D + 1) / 2;
  for (int t = tid; t < NT + D + 1 + NQ; t += THREADS) {
    if (t < NT) {
      int i, j;
      lower_pair(t, i, j);
      const float acc = base_jtj(fx.b, i, j);
      Hb[i * D + j] = acc;
      Hb[j * D + i] = acc;
    } else if (t < NT + D) {
      const int i = t - NT;
      fx.gb[k][i] = -base_jtr(fx.b, i);
    } else if (t == NT + D) {
      fx.cost[k][0] = 0.5f * base_rtr(fx.b);
    } else {
      const int q = t - NT - D - 1;
      const float acc = block_total(fx.b, q);
      if (q < 21) {
        int kk, l;
        upper6_pair(q, kk, l);
        fx.Hc[k][kk * 6 + l] = acc;
        fx.Hc[k][l * 6 + kk] = acc;
      } else if (q < 27) {
        fx.gc[k][q - 21] = acc;
      } else {
        fx.cost[k][1] = 0.5f * acc;
      }
    }
  }
  __syncthreads();
}

// landmark f (one thread each): damp and invert its block, and its shares
// of the Schur terms (21 upper entries of K Hpl^T, 6 of K gl) into v
__device__ __forceinline__ void landmark_step(const Lm& L, int F, int f, int cur, float lam, float* v) {
  const bool lmb = L.lmf[f] > 0.f;
  const float* h = L.Hll[cur];
  float dL[3];
  const int dq[3] = {0, 3, 5};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float hv = h[dq[a] * F + f];
    dL[a] = lmb ? hv + lam * fmaxf(hv, 1e-12f) : 1.f;
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
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int bb = a; bb < 3; ++bb) L.Hinv[iq[a][bb] * F + f] = hi[a][bb];
  float glA[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    glA[a] = lmb ? L.gl[cur][a * F + f] : 0.f;
    L.glA[a * F + f] = glA[a];
  }
  float hpl[6][3], K[6][3];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int a = 0; a < 3; ++a) hpl[j][a] = L.Hpl[cur][(3 * j + a) * F + f];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int bb = 0; bb < 3; ++bb)
      K[j][bb] = hpl[j][0] * hi[0][bb] + hpl[j][1] * hi[1][bb] + hpl[j][2] * hi[2][bb];
  int q = 0;
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int g = j; g < 6; ++g) v[q++] = K[j][0] * hpl[g][0] + K[j][1] * hpl[g][1] + K[j][2] * hpl[g][2];
#pragma unroll
  for (int j = 0; j < 6; ++j) v[21 + j] = K[j][0] * glA[0] + K[j][1] * glA[1] + K[j][2] * glA[2];
}

// warp 0: the damped, Schur-reduced, equilibrated pose step -> dx, xt
__device__ __forceinline__ void lm_step(Fixed& fx, int cur, uint32_t frozen) {
  const int lane = threadIdx.x & 31;
  const int i = lane < D ? lane : D - 1;
  const float* Hb = fx.Hb[cur];
  const float* Hc = fx.Hc[cur];
  const float fi = fx.free[i];
  const bool fb = fi > 0.f;
  const bool ci = i >= P0 && i < P0 + 6;
  const int ki = i - P0;
  // (Hb * ff + hc) * ff, ff = free_i free_j, hc the camera pose block
  auto entry = [&](int j) {
    const float ff = fi * fx.free[j];
    const bool cj = j >= P0 && j < P0 + 6;
    const float hc = (ci && cj) ? Hc[ki * 6 + (j - P0)] : 0.f;
    return (Hb[i * D + j] * ff + hc) * ff;
  };
  float dd = entry(i);
  dd = fb ? dd + fx.lam * fmaxf(dd, 1e-12f) : 1.f;
  if (ci) dd -= fx.ES[upper6(ki, ki)];
  float a[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float e = entry(j);
    if (ci && j >= P0 && j < P0 + 6) {
      const int kj = j - P0;
      e -= fx.ES[ki < kj ? upper6(ki, kj) : upper6(kj, ki)];
    }
    a[j] = j == i ? dd : e;
  }
  float rhs = fb ? fx.gb[cur][i] * fi + (ci ? fx.gc[cur][ki] : 0.f) : 0.f;
  if (ci) rhs -= fx.ES[21 + ki];
  float d = equilibrated_solve<D>(a, dd, rhs, frozen, fx.b.T);
  d = __all_sync(FULL, lane >= D || isfinite(d)) ? d * fi : 0.f;
  const float xt = so3_wrap_lane(fx.x[i] + d, i);
  if (lane < D) {
    fx.dx[lane] = d;
    fx.xt[lane] = xt;
  }
}

// landmark f (one thread each): back-substitution into the trial buffer
__device__ __forceinline__ void back_substitute(const Fixed& fx, const Lm& L, int F, int f, int cur) {
  const float lf = L.lmf[f];
  float rhs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = L.glA[a * F + f];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc -= L.Hpl[cur][(3 * j + a) * F + f] * fx.dx[P0 + j];
    rhs[a] = acc;
  }
  const int iq[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float d = 0.f;
#pragma unroll
    for (int bb = 0; bb < 3; ++bb) d += L.Hinv[iq[a][bb] * F + f] * rhs[bb];
    d *= lf;
    if (!isfinite(d)) d = 0.f;
    L.dxl[a * F + f] = d;
    L.wl[cur ^ 1][a * F + f] = L.wl[cur][a * F + f] + d;
  }
}

__global__ void __launch_bounds__(THREADS, 1) cam_solve_kernel(
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
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Fixed& fx = *reinterpret_cast<Fixed*>(smem);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  const Lm L = lm_layout(smem, F, Wc);

  if (tid < D) {
    fx.x[tid] = s.x0[tid];
    fx.free[tid] = s.free[tid];
  }
  for (int e = tid; e < 3 * F; e += THREADS) L.wl[0][(e % 3) * F + e / 3] = cm.world0[e];
  for (int f = tid; f < F; f += THREADS) L.lmf[f] = cm.lmf[f];
  if (tid == 0) {
    fx.lam = 1e-4f;
    fx.done = 0;
    fx.cur = 0;
  }
  base_init(s, fx.b);
  __syncthreads();
  linearize(s, cm, fx.x, L.wl[0], smem, 0);
  if (tid == 0) fx.c = fx.cost[0][0] + fx.cost[0][1];
  __syncthreads();

  int it = 0;
  // fx.done, fx.cur, fx.c and fx.lam are written by thread 0 before a
  // barrier
  for (; it < max_iters; ++it) {
    if (fx.done) break;
    const int cur = fx.cur;
    // landmark blocks: damp, invert, Schur shares
    float v[27];
#pragma unroll
    for (int q = 0; q < 27; ++q) v[q] = 0.f;
    if (tid < F) landmark_step(L, F, tid, cur, fx.lam, v);
    warp_partials<27>(v, fx.b);
    __syncthreads();
    if (warp == 0) {
      if (lane < 27) fx.ES[lane] = block_total(fx.b, lane);
      __syncwarp();
      lm_step(fx, cur, frozen);
    }
    __syncthreads();
    if (tid < F) back_substitute(fx, L, F, tid, cur);
    __syncthreads();
    linearize(s, cm, fx.xt, L.wl[cur ^ 1], smem, cur ^ 1);
    // accept or reject; the maxima of the steps and of the accepted states
    const float ct = fx.cost[cur ^ 1][0] + fx.cost[cur ^ 1][1];
    const bool acc = ct < fx.c;
    float mdx = 0.f, mx = 0.f;
    if (tid < D) {
      mdx = fabsf(fx.dx[tid]);
      mx = fabsf(acc ? fx.xt[tid] : fx.x[tid]);
    }
    if (tid < F) {
      const float* wn = L.wl[acc ? cur ^ 1 : cur];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mdx = fmaxf(mdx, fabsf(L.dxl[a * F + tid]));
        mx = fmaxf(mx, fabsf(wn[a * F + tid]));
      }
    }
    mdx = warp_max(mdx);
    mx = warp_max(mx);
    if (lane == 0) {
      fx.mred[warp][0] = mdx;
      fx.mred[warp][1] = mx;
    }
    if (acc && tid < D) fx.x[tid] = fx.xt[tid];
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NWARPS; ++w) {
        mdx = fmaxf(mdx, fx.mred[w][0]);
        mx = fmaxf(mx, fx.mred[w][1]);
      }
      const float c = fx.c;
      const float rel = fabsf(c - ct) / fmaxf(c, 1e-20f);
      if (acc) {
        fx.c = ct;
        fx.cur = cur ^ 1;
      }
      const float lam = fminf(fmaxf(acc ? fx.lam * 0.33f : fx.lam * 4.f, 1e-10f), 1e8f);
      fx.lam = lam;
      const bool xtol_hit = mdx < xtol * (mx + xtol);
      const bool stalled = !acc && lam >= 1e8f;
      fx.done = (rel < ftol || xtol_hit || stalled) ? 1 : 0;
    }
    __syncthreads();
  }

  // Schur reduction of frame 0 at the last accepted point (base rows only)
  const int cur = fx.cur;
  schur_frame0(fx.Hb[cur], fx.gb[cur], fx.b, dH_out + b * 225, dg_out + b * 15);
  if (tid < D) x_out[b * D + tid] = fx.x[tid];
  if (tid == 0) {
    cost_out[b] = fx.c;
    iters_out[b] = it;
  }
  for (int e = tid; e < 3 * F; e += THREADS)
    world_out[(size_t)b * F * 3 + e] = L.wl[cur][(e % 3) * F + e / 3];
}

}  // namespace

// C interface (ctypes).  Inputs are contiguous float32 device arrays with a
// leading batch dim B: the base rows' x0 (B,30), free (B,30), imu_J,
// imu_sqrtP (B,15,15), imu_X (B,15), prior_J (B,15,15), prior_X (B,15),
// T_il, T_iw (B,4,4), wheel (B,9), scal (B,6) (ops/track_solve layout), and
// the camera's Tic (B,4,4), sqrt_info (B,2), world0 (B,F,3), lm_free (B,F),
// obs (B,F,Wc,2), use (B,F,Wc), ring (B,Wc,6).  Outputs x (B,30),
// world (B,F,3), cost (B,), dH (B,15,15), dg (B,15), iters (B,) int32.
// Launches B blocks on `stream` and returns the launch's cudaError_t.  The
// kernel's dynamic shared-memory limit is raised to SMEM_MAX once per
// process and device.
extern "C" int liwslam_cam_solve(const float* x0, const float* free_, const float* imu_J,
                                 const float* imu_sqrtP, const float* imu_X, const float* prior_J,
                                 const float* prior_X, const float* T_il, const float* T_iw,
                                 const float* wheel, const float* scal, const float* Tic,
                                 const float* sqrt_info, const float* world0, const float* lm_free,
                                 const float* obs, const float* use, const float* ring, int B,
                                 int F, int Wc, int max_iters, int frozen, float ftol, float xtol,
                                 float* x_out, float* world_out, float* cost_out, float* dH_out,
                                 float* dg_out, int* iters_out, void* stream) {
  const size_t bytes =
      sizeof(float) * ((size_t)FIXED + PER_FW * (size_t)F * Wc + PER_F * (size_t)F);
  if (B < 1 || F < 1 || F > F_MAX || Wc < 1 || Wc > WC_MAX || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(cam_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  cam_solve_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      x0, free_, imu_J, imu_sqrtP, imu_X, prior_J, prior_X, T_il, T_iw, wheel, scal, Tic,
      sqrt_info, world0, lm_free, obs, use, ring, F, Wc, max_iters, (uint32_t)frozen, ftol, xtol,
      x_out, world_out, cost_out, dH_out, dg_out, iters_out);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread and local memory a thread (its stack
// frame, spills included) as the loaded module reports them; returns the
// cudaError_t of the query.
extern "C" int liwslam_cam_solve_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, cam_solve_kernel);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
  }
  return (int)e;
}
