// Kernel B3: pyramidal Lucas-Kanade tracking for Hopper.
//
// Replaces the Pallas TPU kernel liwslam/ops/lk.py::lk_track_pallas
// (_kernel :92, _sample_window :70).  Its plain PyTorch version is
// liwslam_torch/camera/tracker.py::lk_descent.
//
// What it computes, for each of T tracks: the whole coarse-to-fine descent
// over the pyramid levels, `iters` Gauss-Newton steps a level on the 2x2
// normal equations of the patch's ±1 px gradients (gxx, gyy + 1e-4, det
// clamped at 1e-12), each level's excursion clipped to ± the level's width
// / height; then the level-0 verification: mean |patch0 - patch1| below the
// gate and the new position at least `radius` inside the image.  A patch is
// (2r+1)^2 bilinear taps at floor(c) + k with fraction c - floor(c); a tap
// outside the image has weight 0 (the one-hot semantics of the reference's
// sampling).  An invalid track keeps its position and is not ok.
//
// What bounds it on this card: nothing the card is rated for.  At T = 48
// tracks, radius 7, 3 levels and 6 iterations the kernel reads ~0.5 MB of
// pyramid windows and does ~10 MFLOP: well under a microsecond at either
// roofline.  The time is each track's dependent chain, 3 x (1 + iters) + 1
// reductions, each waiting on taps whose address depends on the previous
// step.
//
// What the design does about it:
// - four warps a track, two tracks a block (T = 48: 24 blocks): a track's
//   sum is five xor shuffles in each of its warps (every lane ends with the
//   same sum, since IEEE addition commutes), then the four warps' totals
//   through shared memory behind a named barrier over the track's 128
//   threads, added in warp order, and every lane solves the same 2x2 from
//   it.  No barrier spans a block, except where two tracks' shared memory
//   does not fit one (6 levels at r >= 12, 5 at r >= 14: one track a
//   block).  Timed on an H100 against one and two warps a track: with one
//   (shuffles only) each lane carried 8 of the patch's 15 rows, and its
//   serial row work left the kernel slower than a block a track; with
//   four, a lane carries 2;
// - every load of device memory is issued at launch, as 16-byte cp.async
//   copies (4-byte ones where a level's width is not a multiple of 4), in
//   one round trip: for every level, img0's window around the track (patch,
//   ±1 px gradients and the bilinear tap: 2r+4 on a side) and img1's window
//   around the same point with a margin of MARGIN = 8 px each side (2r+2+16
//   on a side), each widened to whole 16-byte columns.  Patch0 and its
//   gradients for every level, with their sums, are then computed from
//   shared memory before the first level starts, and held in registers
//   through a level's iterations;
// - an iteration reads img1's taps from the staged window while the patch
//   stays inside it: while the level's displacement, in that level's pixels,
//   is within ±MARGIN of where the window was staged (the level's starting
//   point for the coarsest level; for the finer ones the motion found so far
//   counts too).  A patch that leaves it reads device memory, tap by tap as
//   the plain version, and gets the same values (the window holds the same
//   taps, zero outside the image), so results do not depend on MARGIN;
// - each tap, weight, difference and the 2x2 solve use the plain version's
//   operations in its order (__fmul_rn / __fadd_rn keep nvcc from fusing
//   them); only the order of the patch sums differs;
// - lanes map to patch columns: for 2r+1 <= 16 a half warp takes a row (a
//   track's 8 half warps take rows g, g + 8: ROWS = 2 a lane at r <= 7),
//   else a warp a row (ROWS = 8 at r <= 15).  At r <= 7 a window's row
//   stride is 16 mod 32 floats so two half warps' rows fall on different
//   banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 6;
constexpr int MAX_RADIUS = 15;
constexpr int WPT = 4;           // warps a track
constexpr int BLOCK_WARPS = 8;   // warps a block, at most: BLOCK_WARPS / WPT tracks
constexpr int SMALL_RADIUS = 7;  // radii up to this run lk_track_kernel<ROWS_SMALL>
// patch rows a lane: a track's 8 half warps take a row each at 2r+1 <= 16,
// its 4 warps a row each at 2r+1 <= 31
constexpr int ROWS_SMALL = 2;
constexpr int ROWS_LARGE = 8;
static_assert(ROWS_SMALL * 2 * WPT >= 2 * SMALL_RADIUS + 1 && 2 * SMALL_RADIUS + 1 <= 16, "ROWS_SMALL");
static_assert(ROWS_LARGE * WPT >= 2 * MAX_RADIUS + 1, "ROWS_LARGE");
constexpr int MARGIN = 8;        // img1 window margin, px each side
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have (227 KB)
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// The two pyramids, passed by value: level l of image k is a contiguous
// (H[l], W[l]) float32 array at img[k][l].
struct LkPyramids {
  const float* img0[MAX_LEVELS];
  const float* img1[MAX_LEVELS];
  int H[MAX_LEVELS];
  int W[MAX_LEVELS];
};

namespace {

// Shared-memory layout of one track, in floats, every region a multiple of
// 4: the warps' totals of a cross-warp sum (two halves, XB), then per
// level: img0's window (Q rows of C0 columns, stride S0), img1's window (WS
// rows of C1 columns, stride S1), patch0, gx and gy (P x P each), the
// track's lanes' partial sums of gx gx, gx gy, gy gy (3 x 32 WPT) and their
// warps' totals (3 x WPT).  A window's columns start at a multiple of 4.
constexpr int XB = 16;  // two halves of (a, b) for each warp
static_assert(XB >= 4 * WPT && (3 * WPT) % 4 == 0, "XB and the warps' totals: whole 16-byte regions");
struct Geo {
  int r, P, Q, C0, S0, WS, C1, S1, w1, pd, part, sums, per_level;
  __host__ __device__ explicit Geo(int radius) : r(radius) {
    P = 2 * r + 1;
    Q = P + 3;
    // rows 16 mod 32 floats apart where half warps take a row (P <= 16)
    const int pad = 1 - P / 17;
    C0 = (Q + 3 + 3) / 4 * 4;
    S0 = C0 + pad * ((48 - C0 % 32) % 32);
    WS = P + 1 + 2 * MARGIN;
    C1 = (WS + 3 + 3) / 4 * 4;
    S1 = C1 + pad * ((48 - C1 % 32) % 32);
    w1 = Q * S0;
    pd = w1 + WS * S1;
    part = pd + (3 * P * P + 3) / 4 * 4;
    sums = part + 3 * 32 * WPT;
    per_level = sums + 3 * WPT;
  }
};

__host__ __device__ inline size_t track_bytes(int levels, int radius) {
  return sizeof(float) * ((size_t)XB + (size_t)Geo(radius).per_level * (size_t)levels);
}

__device__ __forceinline__ int floor4(int v) { return v & ~3; }  // toward -inf

// Stage rows [y0, y0 + nrows) x columns [x0, x0 + ncols) of `img` into dst
// (row stride `stride`), zero outside the image; asynchronous.  x0, ncols
// and stride are multiples of 4: with the level's width a multiple of 4
// (and the level 16-byte aligned) a 16-byte chunk is wholly inside or
// wholly outside the image, and is copied or zero-filled as one; else the
// copies are 4-byte ones.
__device__ void stage(float* dst, const float* __restrict__ img, int H, int W, int x0, int y0,
                      int ncols, int nrows, int stride, int tl) {
  constexpr int NT = 32 * WPT;  // the track's lanes
  const bool wide = (W & 3) == 0 && ((uintptr_t)img & 15) == 0;
  const int unit = wide ? 4 : 1, nu = ncols / unit;
  auto copy = [&](int row, int c) {
    const int x = x0 + c, y = y0 + row;
    const bool in = x >= 0 && x < W && y >= 0 && y < H;
    const float* src = in ? img + (size_t)y * W + x : img;
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + row * stride + c);
    if (wide)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in ? 16 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(in ? 4 : 0));
  };
  if (nu <= NT) {
    // lane -> column unit (tl % nu) of rows tl / nu + k * rpp: no division
    // in the loop
    const int rpp = NT / nu, r0 = tl / nu, c = unit * (tl - r0 * nu);
    if (r0 < rpp)
      for (int row = r0; row < nrows; row += rpp) copy(row, c);
  } else {
    for (int row = 0; row < nrows; ++row)
      for (int u = tl; u < nu; u += NT) copy(row, unit * u);
  }
}

// One level of one image: its staged window and the level in device memory.
struct Win {
  const float* s;
  const float* img;
  int H, W, x0, y0, ncols, nrows, stride;
};

// A sample point: integer corner, fractions, and whether every tap of the
// (2r+1)^2 patch around it (plus the bilinear +1) lies in the window.
struct Pt {
  int x, y;
  float fx, fy;
  bool inside;
};

// floor of a level coordinate, clamped far outside any image (the window
// test then fails and the taps read 0, as the plain version's)
__device__ __forceinline__ int ifloor(float c) {
  return (int)fminf(fmaxf(floorf(c), -1048576.f), 1048576.f);
}

__device__ __forceinline__ Pt point(const Win& w, float cx, float cy, int r) {
  Pt p;
  p.fx = __fsub_rn(cx, floorf(cx));
  p.fy = __fsub_rn(cy, floorf(cy));
  p.x = ifloor(cx);
  p.y = ifloor(cy);
  p.inside = p.x - r >= w.x0 && p.x + r + 1 < w.x0 + w.ncols && p.y - r >= w.y0 &&
             p.y + r + 1 < w.y0 + w.nrows;
  return p;
}

// img0's and img1's windows of a level, placed around the track's point
// at that level (img1's with MARGIN more on every side)
__device__ __forceinline__ Win window0(const Geo& g, const float* lb, const LkPyramids& pyr, int lvl,
                                       int ix, int iy) {
  return Win{lb, pyr.img0[lvl], pyr.H[lvl], pyr.W[lvl], floor4(ix - g.r - 1), iy - g.r - 1, g.C0, g.Q, g.S0};
}
__device__ __forceinline__ Win window1(const Geo& g, const float* lb, const LkPyramids& pyr, int lvl,
                                       int ix, int iy) {
  return Win{lb + g.w1, pyr.img1[lvl], pyr.H[lvl], pyr.W[lvl], floor4(ix - g.r - MARGIN),
             iy - g.r - MARGIN, g.C1, g.WS, g.S1};
}

__device__ __forceinline__ float tap(const Win& w, int x, int y) {
  return (x >= 0 && x < w.W && y >= 0 && y < w.H) ? __ldg(w.img + (size_t)y * w.W + x) : 0.f;
}

// bilinear tap at p + (ox, oy): sum over the four corners of v * (wy * wx),
// in the plain version's order (tracker.sample_patches)
__device__ __forceinline__ float blend(const Pt& p, float v00, float v01, float v10, float v11) {
  const float wx0 = __fsub_rn(1.f, p.fx), wy0 = __fsub_rn(1.f, p.fy);
  float out = __fmul_rn(v00, __fmul_rn(wy0, wx0));
  out = __fadd_rn(out, __fmul_rn(v01, __fmul_rn(wy0, p.fx)));
  out = __fadd_rn(out, __fmul_rn(v10, __fmul_rn(p.fy, wx0)));
  return __fadd_rn(out, __fmul_rn(v11, __fmul_rn(p.fy, p.fx)));
}

// the tap from the staged window (the caller checked p.inside)
__device__ __forceinline__ float sample_s(const Win& w, const Pt& p, int ox, int oy) {
  const float* s = w.s + (p.y + oy - w.y0) * w.stride + (p.x + ox - w.x0);
  return blend(p, s[0], s[1], s[w.stride], s[w.stride + 1]);
}

// the tap from device memory, zero outside the image
__device__ __forceinline__ float sample_g(const Win& w, const Pt& p, int ox, int oy) {
  const int x = p.x + ox, y = p.y + oy;
  return blend(p, tap(w, x, y), tap(w, x + 1, y), tap(w, x, y + 1), tap(w, x + 1, y + 1));
}

// sum of v[0..N) as a balanced tree: a short dependency chain
template <int N>
__device__ __forceinline__ float pairwise(float (&v)[N]) {
#pragma unroll
  for (int w = 1; w < N; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < N; k += 2 * w) v[k] = __fadd_rn(v[k], v[k + w]);
  }
  return v[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The track's warps wait for each other (a named barrier over the track's
// 32 WPT threads; a block holds BLOCK_WARPS / WPT tracks, each with its
// own barrier id)
__device__ __forceinline__ void track_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * WPT) : "memory");
}

// (a, b) summed over the track's lanes, the same in every lane: each warp's
// five xor shuffles, then the WPT warps' totals in warp order through xb,
// whose two halves alternate (so one barrier a sum: a half is written
// again only after every warp has passed the next sum's barrier)
__device__ __forceinline__ void track_sum(float& a, float& b, float* xb, int& half, int wt, int bar) {
  a = warp_sum(a);
  b = warp_sum(b);
  float* q = xb + half * 2 * WPT;
  half ^= 1;
  if ((threadIdx.x & 31) == 0) {
    q[wt] = a;
    q[WPT + wt] = b;
  }
  track_sync(bar);
  a = q[0];
  b = q[WPT];
#pragma unroll
  for (int w = 1; w < WPT; ++w) {
    a = __fadd_rn(a, q[w]);
    b = __fadd_rn(b, q[WPT + w]);
  }
}

// Patch0, gx and gy of one level into pd (P x P each), and the lane's
// partial sums of gx gx, gx gy, gy gy into part (strides 32 WPT).  The
// window and the outputs do not overlap: every window read can be issued
// first.
template <int ROWS>
__device__ __forceinline__ void patch0(const Win& w0, float bx, float by, int r, int P, int col,
                                       int row0, int RS, int ox, bool act,
                                       float* __restrict__ pd, float* __restrict__ part, int tl) {
  const Pt c = point(w0, bx, by, r);
  const Pt xp = point(w0, __fadd_rn(bx, 1.f), by, r), xm = point(w0, __fsub_rn(bx, 1.f), by, r);
  const Pt yp = point(w0, bx, __fadd_rn(by, 1.f), r), ym = point(w0, bx, __fsub_rn(by, 1.f), r);
  float v[ROWS], gx[ROWS], gy[ROWS];
  auto rows = [&](auto smp) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int oy = min(row0 + k * RS, P - 1) - r;
      v[k] = smp(c, oy);
      gx[k] = __fmul_rn(0.5f, __fsub_rn(smp(xp, oy), smp(xm, oy)));
      gy[k] = __fmul_rn(0.5f, __fsub_rn(smp(yp, oy), smp(ym, oy)));
    }
  };
  if (c.inside && xp.inside && xm.inside && yp.inside && ym.inside)
    rows([&](const Pt& q, int oy) { return sample_s(w0, q, ox, oy); });
  else
    rows([&](const Pt& q, int oy) { return sample_g(w0, q, ox, oy); });
  float a = 0.f, b = 0.f, d = 0.f;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int row = row0 + k * RS;
    if (act && row < P) {
      pd[row * P + col] = v[k];
      pd[P * P + row * P + col] = gx[k];
      pd[2 * P * P + row * P + col] = gy[k];
      a = __fadd_rn(a, __fmul_rn(gx[k], gx[k]));
      b = __fadd_rn(b, __fmul_rn(gx[k], gy[k]));
      d = __fadd_rn(d, __fmul_rn(gy[k], gy[k]));
    }
  }
  part[tl] = a;
  part[32 * WPT + tl] = b;
  part[64 * WPT + tl] = d;
}

template <int ROWS>
__global__ void __launch_bounds__(32 * BLOCK_WARPS) lk_track_kernel(
    LkPyramids pyr, int levels, const float* __restrict__ pts, const bool* __restrict__ valid,
    const float* __restrict__ gate, int T, int radius, int iters, float* __restrict__ new_pts,
    bool* __restrict__ ok_out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tb = warp / WPT, wt = warp - tb * WPT, tl = 32 * wt + lane;  // track in block, warp and lane in track
  const int t = blockIdx.x * (blockDim.x / (32 * WPT)) + tb;
  if (t >= T) return;
  const float px = pts[2 * t], py = pts[2 * t + 1];
  if (!valid[t]) {
    if (tl == 0) {
      new_pts[2 * t] = px;
      new_pts[2 * t + 1] = py;
      ok_out[t] = false;
    }
    return;
  }
  const int bar = 1 + tb;
  const Geo g(radius);
  const int r = radius, P = g.P;
  float* xb = (float*)smem4 + (size_t)tb * (XB + g.per_level * levels);
  float* base = xb + XB;
  int half = 0;
  // lane -> patch column `col` of row group `row0`; rows row0 + k * RS
  const int HWL = P <= 16 ? 16 : 32;
  const int RS = WPT * (32 / HWL), col = lane & (HWL - 1), row0 = wt * (32 / HWL) + lane / HWL;
  const bool act = col < P;
  // a lane's slots off the patch (col or row >= P) sample a pixel clamped
  // into the patch: their values are not stored (step 2), weigh 0 (step 3:
  // p0 = gx = gy = 0 there, e * 0 = 0) or are not added (step 4)
  const int ox = min(col, P - 1) - r;

  // --- 1. stage every level's windows of img0 and img1 (one round trip) --
  for (int lvl = 0; lvl < levels; ++lvl) {
    const float scale = (float)(1 << lvl);
    const int ix = ifloor(px / scale), iy = ifloor(py / scale);
    float* lb = base + (size_t)lvl * g.per_level;
    const Win w0 = window0(g, lb, pyr, lvl, ix, iy), w1 = window1(g, lb, pyr, lvl, ix, iy);
    stage(lb, w0.img, w0.H, w0.W, w0.x0, w0.y0, w0.ncols, w0.nrows, w0.stride, tl);
    stage(lb + g.w1, w1.img, w1.H, w1.W, w1.x0, w1.y0, w1.ncols, w1.nrows, w1.stride, tl);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  track_sync(bar);

  // --- 2. patch0 and gradients of every level, with their sums ------------
  for (int lvl = 0; lvl < levels; ++lvl) {
    const float scale = (float)(1 << lvl);
    const float bx = px / scale, by = py / scale;
    float* lb = base + (size_t)lvl * g.per_level;
    const Win w0 = window0(g, lb, pyr, lvl, ifloor(bx), ifloor(by));
    patch0<ROWS>(w0, bx, by, r, P, col, row0, RS, ox, act, lb + g.pd, lb + g.part, tl);
  }
  track_sync(bar);
  // lane j < 3 levels of each warp adds up sum j % 3 of level j / 3 over
  // the warp's 32 lanes (every level's sums at once, each in one fixed
  // order); the warps' totals are added in warp order at the level
  if (lane < 3 * levels) {
    float* lb = base + (size_t)(lane / 3) * g.per_level;
    const float* pp = lb + g.part + 32 * WPT * (lane % 3) + 32 * wt;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) v = __fadd_rn(v, pp[j]);
    lb[g.sums + WPT * (lane % 3) + wt] = v;
  }
  track_sync(bar);

  // --- 3. coarse to fine: in an iteration, no branch but the window test
  // and one barrier over the track's warps ---------------------------------
  float dx = 0.f, dy = 0.f;  // displacement in level-0 pixels
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const float scale = (float)(1 << lvl);
    const float bx = px / scale, by = py / scale;
    const float* lb = base + (size_t)lvl * g.per_level;
    const Win w1 = window1(g, lb, pyr, lvl, ifloor(bx), ifloor(by));
    const float* pd = lb + g.pd;
    float sxx = lb[g.sums], sxy = lb[g.sums + WPT], syy = lb[g.sums + 2 * WPT];
#pragma unroll
    for (int w = 1; w < WPT; ++w) {
      sxx = __fadd_rn(sxx, lb[g.sums + w]);
      sxy = __fadd_rn(sxy, lb[g.sums + WPT + w]);
      syy = __fadd_rn(syy, lb[g.sums + 2 * WPT + w]);
    }
    const float gxx = __fadd_rn(sxx, 1e-4f), gxy = sxy, gyy = __fadd_rn(syy, 1e-4f);
    const float det = fmaxf(__fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy)), 1e-12f);
    const float Wl = (float)pyr.W[lvl], Hl = (float)pyr.H[lvl];
    // the lane's patch0 and gradients, in registers
    float rp0[ROWS], rgx[ROWS], rgy[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int row = row0 + k * RS, i = min(row, P - 1) * P + ox + r;
      const bool on = act && row < P;
      rp0[k] = on ? pd[i] : 0.f;
      rgx[k] = on ? pd[P * P + i] : 0.f;
      rgy[k] = on ? pd[2 * P * P + i] : 0.f;
    }
    float dlx = dx / scale, dly = dy / scale;
    for (int it = 0; it < iters; ++it) {
      const Pt c = point(w1, __fadd_rn(bx, dlx), __fadd_rn(by, dly), r);
      float sx, sy;
      // the rows' e gx and e gy, summed as a tree; the window test is taken
      // once for the whole patch
      auto rows = [&](auto tap_at) {
        float ex[ROWS], ey[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const float e = __fsub_rn(rp0[k], tap_at(min(row0 + k * RS, P - 1) - r));
          ex[k] = __fmul_rn(e, rgx[k]);
          ey[k] = __fmul_rn(e, rgy[k]);
        }
        sx = pairwise<ROWS>(ex);
        sy = pairwise<ROWS>(ey);
      };
      if (c.inside)
        rows([&](int oy) { return sample_s(w1, c, ox, oy); });
      else
        rows([&](int oy) { return sample_g(w1, c, ox, oy); });
      track_sum(sx, sy, xb, half, wt, bar);
      const float ux = __fdiv_rn(__fsub_rn(__fmul_rn(gyy, sx), __fmul_rn(gxy, sy)), det);
      const float uy = __fdiv_rn(__fsub_rn(__fmul_rn(gxx, sy), __fmul_rn(gxy, sx)), det);
      dlx = fminf(fmaxf(__fadd_rn(dlx, ux), -Wl), Wl);
      dly = fminf(fmaxf(__fadd_rn(dly, uy), -Hl), Hl);
    }
    dx = dlx * scale;
    dy = dly * scale;
  }

  // --- 4. verification at level 0 (patch0 of level 0 is in shared) -------
  const float nx = __fadd_rn(px, dx), ny = __fadd_rn(py, dy);
  const int H0 = pyr.H[0], W0 = pyr.W[0];
  const Win w1 = window1(g, base, pyr, 0, ifloor(px), ifloor(py));
  const float* pd = base + g.pd;
  const Pt c = point(w1, nx, ny, r);
  float s = 0.f, unused = 0.f;
  auto err_rows = [&](auto tap_at) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int row = row0 + k * RS;
      const float v = tap_at(min(row, P - 1) - r);
      if (act && row < P) s = __fadd_rn(s, fabsf(__fsub_rn(pd[row * P + col], v)));
    }
  };
  if (c.inside)
    err_rows([&](int oy) { return sample_s(w1, c, ox, oy); });
  else
    err_rows([&](int oy) { return sample_g(w1, c, ox, oy); });
  track_sum(s, unused, xb, half, wt, bar);
  if (tl == 0) {
    const float rf = (float)r;
    const float err = __fdiv_rn(s, (float)(P * P));
    const bool inb = nx >= rf && nx < (float)(W0 - r) && ny >= rf && ny < (float)(H0 - r);
    new_pts[2 * t] = nx;
    new_pts[2 * t + 1] = ny;
    ok_out[t] = inb && err < gate[0];
  }
}

}  // namespace

// C interface (ctypes).  pts (T,2) float32, valid (T,) bool, gate (1,)
// float32 on the device; outputs new_pts (T,2) float32 and ok (T,) bool.
// Launches ceil(T / k) blocks of k tracks (WPT warps each) on `stream`, k
// = the tracks whose shared memory fits a block, at most BLOCK_WARPS / WPT,
// and returns the launch's cudaError_t.  The kernels' dynamic
// shared-memory limit is raised to SMEM_MAX once per process and device.
extern "C" int liwslam_lk_track(LkPyramids pyr, int levels, const float* pts, const bool* valid,
                                const float* gate, int T, int radius, int iters, float* new_pts,
                                bool* ok, void* stream) {
  if (T < 1 || levels < 1 || levels > MAX_LEVELS || radius < 0 || radius > MAX_RADIUS || iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t tb = track_bytes(levels, radius);
  if (tb > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(lk_track_kernel<ROWS_SMALL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lk_track_kernel<ROWS_LARGE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  constexpr int TPB = BLOCK_WARPS / WPT;
  const int k = (int)(SMEM_MAX / tb < (size_t)TPB ? SMEM_MAX / tb : TPB);
  const int blocks = (T + k - 1) / k;
  const cudaStream_t st = (cudaStream_t)stream;
  if (radius <= SMALL_RADIUS)
    lk_track_kernel<ROWS_SMALL><<<blocks, 32 * WPT * k, k * tb, st>>>(pyr, levels, pts, valid, gate,
                                                                       T, radius, iters, new_pts, ok);
  else
    lk_track_kernel<ROWS_LARGE><<<blocks, 32 * WPT * k, k * tb, st>>>(pyr, levels, pts, valid, gate,
                                                                       T, radius, iters, new_pts, ok);
  return (int)cudaGetLastError();
}

// Registers and local memory a thread (its stack frame, spills included) of
// the kernel that radii up to SMALL_RADIUS launch (the camera path's), as
// the loaded module reports them; returns the cudaError_t of the query.
extern "C" int liwslam_lk_track_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, lk_track_kernel<ROWS_SMALL>);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
  }
  return (int)e;
}
