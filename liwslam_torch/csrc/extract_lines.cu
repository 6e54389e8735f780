// Kernel B2: laser line extraction for one scan per thread block (Hopper).
//
// Replaces the Pallas TPU kernel liwslam/ops/extract.py::extract_lines_pallas
// (_kernel :108).  Its plain PyTorch version is
// liwslam_torch/ops/extract.py::extract_lines_plain, the line stages of the
// reference's spawn_scan (laser_manager.cpp:350-422):
//   1. segmentation by the continuity gap,
//   2. corner response over a clamped +-3 window, strict NMS per segment,
//   3. merge of near-collinear joints,
//   4. TLS line fits over the spans between kept breakpoints, from prefix
//      moments centred on the scan centroid (without the centring, f32
//      cancellation costs millimetres at 1080 beams), max point-to-line
//      distance per span, min_len / max_dis gates,
//   5. compaction of the first L winners in scan order.
//
// What bounds it on this card: latency, not bytes or operations.  One scan
// is N = 1152 points (15 KB in, 1.1 KB out) and a few hundred operations
// per point: nanoseconds of either roofline.  The time is the chain of
// block-wide scans and barriers, and the single block that runs it.
//
// What the design does about it: one blocked ownership for every stage.
// Thread t owns the points [t*P, t*P + P), P = ceil(N / THREADS) (3 at N =
// 1152), and keeps their state in registers from stage to stage.  Shared
// memory holds only what other threads read: x, y, the continuity gap and
// the segment id (±3 neighbours, payloads at found indices), the NMS votes
// (±3 neighbours), the float64 prefix moments (read at span ends), each
// kept breakpoint's line and span distance (read by the span's points)
// and the kept breakpoints' slots.  On one SM the block's time is its
// instruction count: the few kept breakpoints' line fits run one a thread,
// not in every warp that owns one, and a span's distance takes one atomic
// a warp, not one a point.
// Every scan of a stage runs in one pass: the thread's own points in order
// (or in reverse), a warp-shuffle scan of the thread totals, the warp
// totals through shared memory and one barrier, then each thread folds the
// totals of the warps before it (after it, for a reverse scan).  The
// barrier phases of a scan, counted:
//   1 centroid: the 3-tuple (sum x, sum y, count) of the valid points;
//   2 segment scan: segment id (+), the six float64 moments (+), segment
//     start at or before i (max) and next segment start after i (reverse
//     min) together;
//   3 corner votes, segment ids and prefix moments visible to all;
//   4 breakpoints: last before i (max) and next after i (reverse min);
//   5 kept breakpoints: the span of i (max), next kept after i (reverse
//     min) and the kept count before i (+), the kept breakpoint's slot;
//   6 the kept breakpoints written to their slots, in scan order;
//   7 each kept breakpoint's line (normal, offset), fitted by one thread a
//     slot, and a zeroed distance;
//   8 span distances: each thread's run of one span folded, each warp's
//     lanes of one span folded (segmented shuffle scan), one atomicMax a
//     warp into the span's slot of the non-negative float bits (exact in
//     any order);
//   9 winners' rank (+) and count over the slots.
// Nine barriers a scan; winner r is written to row r.  The sums differ from
// the plain version's only in order.  B scans run as B blocks.  Timed on
// an H100 against other block sizes: 384 threads beat 256 and 512, and one
// warp a scan (36 points a lane, its registers spilled) took nine times as
// long.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 384;
constexpr int NWARP = THREADS / 32;
constexpr int N_MAX = 1600;                            // points a scan, at most
constexpr int MAXP = (N_MAX + THREADS - 1) / THREADS;  // points a thread, at most
constexpr int STEP = 3;                                // corner-response half window
constexpr float EPS = 1e-8f;
constexpr float BIG = 1e9f;
// dynamic shared memory a point: 6 float64 prefix moments, 14 float arrays
// (x, y, gap, vote, nx, ny, cc, maxd and a kept slot's line: x1, y1, x2,
// y2, length, end gap) and 4 int arrays (segment id; a kept slot's point,
// next kept breakpoint and flags)
constexpr int POINT_BYTES = 6 * 8 + 14 * 4 + 4 * 4;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have (227 KB)
static_assert(THREADS % 32 == 0 && NWARP <= 32, "THREADS: whole warps, at most 32");
static_assert(MAXP <= 32, "a thread's winners are bits of one 32-bit word");
static_assert(POINT_BYTES * N_MAX <= SMEM_MAX, "N_MAX points must fit a block's shared memory");

constexpr unsigned FULL = 0xffffffffu;

// A warp's inclusive scan (forward: lanes below; reverse: lanes above).
template <class T, class Op>
__device__ __forceinline__ T warp_scan(T v, Op op, bool rev) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = rev ? __shfl_down_sync(FULL, v, off) : __shfl_up_sync(FULL, v, off);
    if (rev ? lane + off < 32 : lane >= off) v = rev ? op(v, o) : op(o, v);
  }
  return v;
}

// Exclusive block prefix of the thread totals `v` (ident for the first
// thread; for a reverse scan, the last).  Before the phase's barrier:
// `post` scans the warp and publishes the warp's total in slot[warp];
// after it, `fold` combines the other warps' totals with the warp prefix.
template <class T, class Op>
struct Scan {
  T incl;
  bool rev;
  __device__ __forceinline__ void post(T v, Op op, bool reverse, T* slot) {
    rev = reverse;
    incl = warp_scan(v, op, rev);
    const int lane = threadIdx.x & 31;
    if (lane == (rev ? 0 : 31)) slot[threadIdx.x >> 5] = incl;
  }
  // the warps' totals are read at once (unrolled, predicated), then folded
  // in warp order: every thread of a warp folds the same values the same way
  __device__ __forceinline__ T fold(Op op, T ident, const T* slot) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T w = rev ? __shfl_down_sync(FULL, incl, 1) : __shfl_up_sync(FULL, incl, 1);
    if (lane == (rev ? 31 : 0)) w = ident;
    T acc = ident;
    if (rev) {
#pragma unroll
      for (int k = NWARP - 1; k > 0; --k)
        if (k > warp) acc = op(slot[k], acc);
      return op(w, acc);
    }
#pragma unroll
    for (int k = 0; k < NWARP - 1; ++k)
      if (k < warp) acc = op(acc, slot[k]);
    return op(acc, w);
  }
};

struct SumI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct SumD {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct MaxI {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// flag bits of a point
enum : int {
  F_VALID = 1, F_START = 2, F_INTERIOR = 4, F_BP = 8, F_ENDPT = 16, F_KEEP = 32, F_CAND = 64
};

// the warp totals each phase publishes (one array each: no slot is reused)
struct Slots {
  float cen[3][NWARP];
  int seg[NWARP], sstart[NWARP], snext[NWARP];
  double mom[6][NWARP];
  int bprev[NWARP], bnext[NWARP];
  int span[NWARP], knext[NWARP], kcnt[NWARP];
  int rank[NWARP];
};

__global__ void __launch_bounds__(THREADS) extract_lines_kernel(
    const float* __restrict__ points, const unsigned char* __restrict__ valid_in, int N, int L,
    float cont_thr, float min_len, float max_dis, float tol_angle, float* __restrict__ e1_out,
    float* __restrict__ e2_out, unsigned char* __restrict__ lv_out,
    float* __restrict__ gap_out) {
  extern __shared__ double smem[];
  __shared__ Slots sl;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  points += (size_t)b * N * 3;
  valid_in += (size_t)b * N;
  e1_out += (size_t)b * L * 2;
  e2_out += (size_t)b * L * 2;
  lv_out += (size_t)b * L;
  gap_out += (size_t)b * L;

  double* cs = smem;  // cs[k * N + i]: inclusive prefix of moment k
  float* xs = (float*)(cs + 6 * N);
  float* ys = xs + N;
  float* gaps = ys + N;
  float* vote = gaps + N;
  float* nxs = vote + N;
  float* nys = nxs + N;
  float* ccs = nys + N;
  float* maxd = ccs + N;
  // the kept breakpoints in scan order, one slot each: point, next kept
  // breakpoint, flags, and the fitted line's endpoints, length and end gap
  float* kx1 = maxd + N;
  float* ky1 = kx1 + N;
  float* kx2 = ky1 + N;
  float* ky2 = kx2 + N;
  float* klen = ky2 + N;
  float* kgap = klen + N;
  int* segs = (int*)(kgap + N);
  int* klist = segs + N;
  int* knext = klist + N;
  int* kflag = knext + N;

  const int P = (N + THREADS - 1) / THREADS;
  const int lo = tid * P;
  // own point k is i = lo + k, present when i < N (k < MAXP always)
#define OWN(k) (k < P && lo + k < N)

  // --- 1. load, continuity gaps, segmentation flags, centroid ------------
  float x[MAXP], y[MAXP];
  int fl[MAXP];
  float sx = 0.f, sy = 0.f, sm = 0.f;
  {
    float qx = 0.f, qy = 0.f;
    bool qv = false;
    if (lo > 0 && lo < N) {
      qx = points[3 * (lo - 1)];
      qy = points[3 * (lo - 1) + 1];
      qv = valid_in[lo - 1] != 0;
    }
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      x[k] = y[k] = 0.f;
      fl[k] = 0;
      if (!OWN(k)) continue;
      const int i = lo + k;
      x[k] = points[3 * i];
      y[k] = points[3 * i + 1];
      const bool v = valid_in[i] != 0;
      float g = 0.f;
      bool cont = false;
      if (i > 0) {
        const float dx = x[k] - qx, dy = y[k] - qy;
        g = sqrtf(dx * dx + dy * dy);
        cont = g <= cont_thr && v && qv;
      }
      xs[i] = x[k];
      ys[i] = y[k];
      gaps[i] = g;
      fl[k] = (v ? F_VALID : 0) | (cont ? 0 : F_START);
      if (v) {
        sx += x[k];
        sy += y[k];
        sm += 1.f;
      }
      qx = x[k];
      qy = y[k];
      qv = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, o);
    sy += __shfl_xor_sync(FULL, sy, o);
    sm += __shfl_xor_sync(FULL, sm, o);
  }
  if (lane == 0) {
    sl.cen[0][warp] = sx;
    sl.cen[1][warp] = sy;
    sl.cen[2][warp] = sm;
  }
  __syncthreads();  // (1)
  float refx, refy;
  {
    float tx = 0.f, ty = 0.f, tm = 0.f;
    for (int w = 0; w < NWARP; ++w) {
      tx += sl.cen[0][w];
      ty += sl.cen[1][w];
      tm += sl.cen[2][w];
    }
    const float n_all = fmaxf(tm, 1.f);
    refx = tx / n_all;
    refy = ty / n_all;
  }

  // --- segment ids, prefix moments, segment bounds: one scan phase -------
  // moments of the centred, masked point: [x y xx xy yy m], products in f32
  // (as the plain version), sums in float64: a span's sums are differences
  // of prefixes that grow to ~1e4 over a scan, and f32 rounding there moves
  // the TLS direction of short spans by millimetres
  Scan<int, SumI> s_seg;
  Scan<int, MaxI> s_start;
  Scan<int, MinI> s_next;
  Scan<double, SumD> s_mom[6];
  {
    int cnt = 0, last = -1, first = 2 * N;
    double tm[6] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (!OWN(k)) continue;
      const int i = lo + k;
      const float m = (fl[k] & F_VALID) ? 1.f : 0.f;
      const float xm = (x[k] - refx) * m, ym = (y[k] - refy) * m;
      tm[0] += xm;
      tm[1] += ym;
      tm[2] += xm * xm;
      tm[3] += xm * ym;
      tm[4] += ym * ym;
      tm[5] += m;
      if (fl[k] & F_START) {
        cnt += 1;
        last = i;
        first = min(first, i);
      }
    }
    s_seg.post(cnt, SumI(), false, sl.seg);
    s_start.post(last, MaxI(), false, sl.sstart);
    s_next.post(first, MinI(), true, sl.snext);
#pragma unroll
    for (int c = 0; c < 6; ++c) s_mom[c].post(tm[c], SumD(), false, sl.mom[c]);
  }
  __syncthreads();  // (2)
  int seg[MAXP], sstart[MAXP], send[MAXP];
  {
    int cnt = s_seg.fold(SumI(), 0, sl.seg);
    int last = s_start.fold(MaxI(), -1, sl.sstart);
    double run[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) run[c] = s_mom[c].fold(SumD(), 0.0, sl.mom[c]);
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      seg[k] = sstart[k] = 0;
      if (!OWN(k)) continue;
      const int i = lo + k;
      const float m = (fl[k] & F_VALID) ? 1.f : 0.f;
      const float xm = (x[k] - refx) * m, ym = (y[k] - refy) * m;
      run[0] += xm;
      run[1] += ym;
      run[2] += xm * xm;
      run[3] += xm * ym;
      run[4] += ym * ym;
      run[5] += m;
#pragma unroll
      for (int c = 0; c < 6; ++c) cs[c * N + i] = run[c];
      if (fl[k] & F_START) {
        cnt += 1;
        last = i;
      }
      seg[k] = cnt;  // segment id, starting at 1
      sstart[k] = last;
      segs[i] = cnt;
    }
    // next segment start after i (2N when none): reverse over own points
    int nxt = s_next.fold(MinI(), 2 * N, sl.snext);
#pragma unroll
    for (int k = MAXP - 1; k >= 0; --k) {
      send[k] = 0;
      if (!OWN(k)) continue;
      send[k] = min(nxt - 1, N - 1);
      if (fl[k] & F_START) nxt = lo + k;
    }
  }

  // --- 2. corner response over the clamped +-STEP window -----------------
  float resp[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    resp[k] = -1.f;
    if (!OWN(k)) continue;
    const int i = lo + k;
    const int j = max(i - STEP, sstart[k]);
    const int q = min(i + STEP, send[k]);
    const float v1x = xs[j] - x[k], v1y = ys[j] - y[k];
    const float v2x = xs[q] - x[k], v2y = ys[q] - y[k];
    const float n1 = sqrtf(v1x * v1x + v1y * v1y), n2 = sqrtf(v2x * v2x + v2y * v2y);
    float r = (v1x * v2x + v1y * v2y) / fmaxf(n1 * n2, EPS);
    const bool interior = i > sstart[k] && i < send[k] && (fl[k] & F_VALID);
    if (!(interior && n1 > EPS && n2 > EPS)) r = -1.f;
    resp[k] = r;
    vote[i] = interior ? r : -BIG;
    if (interior) fl[k] |= F_INTERIOR;
  }
  __syncthreads();  // (3)

  // --- 3. strict NMS within +-STEP (same segment), breakpoints -----------
  Scan<int, MaxI> s_bprev;
  Scan<int, MinI> s_bnext;
  {
    int last = -1, first = N + 1;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (!OWN(k)) continue;
      const int i = lo + k;
      float nb = -BIG;
      for (int d = 1; d <= STEP; ++d) {
        if (i - d >= 0 && segs[i - d] == seg[k]) nb = fmaxf(nb, vote[i - d]);
        if (i + d < N && segs[i + d] == seg[k]) nb = fmaxf(nb, vote[i + d]);
      }
      const bool is_max = (fl[k] & F_INTERIOR) && resp[k] > nb;
      const bool endpt = i == sstart[k] || i == send[k];
      const bool bp = is_max || (endpt && (fl[k] & F_VALID));
      fl[k] |= (bp ? F_BP : 0) | (endpt ? F_ENDPT : 0);
      if (bp) {
        last = i;
        first = min(first, i);
      }
    }
    s_bprev.post(last, MaxI(), false, sl.bprev);
    s_bnext.post(first, MinI(), true, sl.bnext);
  }
  __syncthreads();  // (4)

  // --- 3b. merge near-collinear joints -----------------------------------
  Scan<int, MaxI> s_span;
  Scan<int, MinI> s_knext;
  Scan<int, SumI> s_kcnt;
  {
    int pvs[MAXP], nvs[MAXP];
    int pv = s_bprev.fold(MaxI(), -1, sl.bprev);
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      pvs[k] = pv;  // last breakpoint before i
      if (OWN(k) && (fl[k] & F_BP)) pv = lo + k;
    }
    int nv = s_bnext.fold(MinI(), N + 1, sl.bnext);
#pragma unroll
    for (int k = MAXP - 1; k >= 0; --k) {
      nvs[k] = nv;  // next breakpoint after i
      if (OWN(k) && (fl[k] & F_BP)) nv = lo + k;
    }
    int last = -1, first = N + 1, cnt = 0;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (!OWN(k)) continue;
      const int i = lo + k;
      const int f = fl[k];
      if (!(f & F_BP)) continue;
      const int p = pvs[k], q = nvs[k];
      const bool in_p = p >= 0 && p < N, in_n = q >= 0 && q < N;
      const float px = in_p ? xs[p] : 0.f, py = in_p ? ys[p] : 0.f;
      const float qx = in_n ? xs[q] : 0.f, qy = in_n ? ys[q] : 0.f;
      const bool has_p = in_p && segs[p] == seg[k];
      const bool has_n = in_n && segs[q] == seg[k];
      const float u1x = px - x[k], u1y = py - y[k], u2x = qx - x[k], u2y = qy - y[k];
      const float jc = (u1x * u2x + u1y * u2y) /
                       fmaxf(sqrtf(u1x * u1x + u1y * u1y) * sqrtf(u2x * u2x + u2y * u2y), EPS);
      const float ang = acosf(fminf(fmaxf(jc, -1.f), 1.f));
      const bool survives = fabsf(ang) < tol_angle;
      if ((f & F_ENDPT) || survives || !(has_p && has_n)) {
        fl[k] = f | F_KEEP;
        last = i;
        first = min(first, i);
        cnt += 1;
      }
    }
    s_span.post(last, MaxI(), false, sl.span);
    s_knext.post(first, MinI(), true, sl.knext);
    s_kcnt.post(cnt, SumI(), false, sl.kcnt);
  }
  __syncthreads();  // (5)

  // the kept breakpoints into their slots (scan order), with the span of
  // every point
  int span[MAXP];
  int n_kept = 0;
  {
    int sp = s_span.fold(MaxI(), -1, sl.span);
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (OWN(k) && (fl[k] & F_KEEP)) sp = lo + k;
      span[k] = sp;  // the span a point belongs to: last kept at or before i
    }
    int se = s_knext.fold(MinI(), N + 1, sl.knext), sek[MAXP];
#pragma unroll
    for (int k = MAXP - 1; k >= 0; --k) {
      sek[k] = se;  // next kept breakpoint after i
      if (OWN(k) && (fl[k] & F_KEEP)) se = lo + k;
    }
    int slot = s_kcnt.fold(SumI(), 0, sl.kcnt);
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      if (!OWN(k) || !(fl[k] & F_KEEP)) continue;
      klist[slot] = lo + k;
      knext[slot] = sek[k];
      kflag[slot] = fl[k];
      slot += 1;
    }
    for (int w = 0; w < NWARP; ++w) n_kept += sl.kcnt[w];
  }
  __syncthreads();  // (6)

  // --- 4. TLS line fit over [i, i2] for every kept breakpoint i, one slot
  // a thread (kept breakpoints are few: the fit's divisions and square
  // roots run once a slot, not once a point in every warp) ---------------
  for (int j = tid; j < n_kept; j += THREADS) {
    const int i = klist[j], se_i = knext[j], f = kflag[j];
    const int i2 = min(max(se_i, 0), N - 1);
    const bool cand = se_i <= N - 1 && se_i - i >= 2 && segs[i2] == segs[i] && (f & F_VALID);
    float S[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) S[c] = (float)(cs[c * N + i2] - (i > 0 ? cs[c * N + i - 1] : 0.0));
    const float n = fmaxf(S[5], 1.f);
    const float mx = S[0] / n, my = S[1] / n;
    const float cxx = S[2] / n - mx * mx;
    const float cxy = S[3] / n - mx * my;
    const float cyy = S[4] / n - my * my;
    const float tr = cxx + cyy;
    const float det = cxx * cyy - cxy * cxy;
    const float disc = sqrtf(fmaxf(tr * tr / 4.f - det, 0.f));
    const float lmin = tr / 2.f - disc;
    const float a1x = cxy, a1y = lmin - cxx, a2x = lmin - cyy, a2y = cxy;
    const bool use1 = sqrtf(a1x * a1x + a1y * a1y) > sqrtf(a2x * a2x + a2y * a2y);
    float vx = use1 ? a1x : a2x, vy = use1 ? a1y : a2y;
    const float vn = fmaxf(sqrtf(vx * vx + vy * vy), EPS);
    vx /= vn;
    vy /= vn;
    const float c = -(vx * mx + vy * my);
    const float ax = xs[i] - refx, ay = ys[i] - refy;
    const float bx = xs[i2] - refx, by = ys[i2] - refy;
    const float d1 = vx * ax + vy * ay + c;
    const float d2 = vx * bx + vy * by + c;
    const float p1x = ax - d1 * vx + refx, p1y = ay - d1 * vy + refy;
    const float p2x = bx - d2 * vx + refx, p2y = by - d2 * vy + refy;
    const float lx = p2x - p1x, ly = p2y - p1y;
    nxs[i] = vx;
    nys[i] = vy;
    ccs[i] = c;
    maxd[i] = 0.f;
    kx1[j] = p1x;
    ky1[j] = p1y;
    kx2[j] = p2x;
    ky2[j] = p2y;
    klen[j] = sqrtf(lx * lx + ly * ly);
    kgap[j] = fmaxf(i + 1 < N ? gaps[i + 1] : gaps[N - 1], gaps[i2]);
    if (cand) kflag[j] = f | F_CAND;
  }
  __syncthreads();  // (7)

  // max |point-to-line distance| over each span [i1, i2): the points whose
  // last kept breakpoint is i1.  A thread folds its run of points of one
  // span, the warp's lanes holding that span fold theirs (a segmented
  // shuffle scan of the distance's bits: non-negative floats order as their
  // bits, and a NaN's bits above all, so a NaN wins as in the plain
  // version's amax), and one atomicMax a warp goes to the span's slot
  // (exact in any order).
  {
    int sid[MAXP + 1];
    unsigned bits[MAXP + 1];
    int cur = -1;
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
      sid[k] = -1;
      bits[k] = 0;
      const int s = OWN(k) && (fl[k] & F_VALID) ? span[k] : -1;
      if (s < 0) continue;
      if (s != cur) {
        sid[k] = cur;  // the run before, flushed into slot k
        bits[k] = m;
        cur = s;
        m = 0;
      }
      const float d = fabsf(nxs[s] * (x[k] - refx) + nys[s] * (y[k] - refy) + ccs[s]);
      m = max(m, __float_as_uint(d));
    }
    sid[MAXP] = cur;
    bits[MAXP] = m;
#pragma unroll
    for (int k = 0; k <= MAXP; ++k) {
      if (!__any_sync(FULL, sid[k] >= 0)) continue;
      // lanes of one span hold neighbouring runs: a segmented max scan,
      // and the last lane of each run of lanes takes the atomic
      const int sk = sid[k];
      unsigned v = bits[k];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int os = __shfl_up_sync(FULL, sk, off);
        const unsigned ov = __shfl_up_sync(FULL, v, off);
        if (lane >= off && os == sk) v = max(v, ov);
      }
      const int ns = __shfl_down_sync(FULL, sk, 1);
      if (sk >= 0 && (lane == 31 || ns != sk)) atomicMax((unsigned*)&maxd[sk], v);
    }
  }
  __syncthreads();  // (8)

  // --- 5. gates and rank over the kept slots (thread t owns slots [t*Q,
  // t*Q + Q)), compaction of the first L winners -------------------------
  const int Q = (n_kept + THREADS - 1) / THREADS;
  Scan<int, SumI> s_rank;
  unsigned okb = 0;  // bit q: slot t*Q + q wins
  {
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < MAXP; ++q) {
      const int j = tid * Q + q;
      if (q >= Q || j >= n_kept) continue;
      const float l = klen[j];
      if ((kflag[j] & F_CAND) && maxd[klist[j]] <= max_dis && l >= min_len && isfinite(l)) {
        okb |= 1u << q;
        cnt += 1;
      }
    }
    s_rank.post(cnt, SumI(), false, sl.rank);
  }
  __syncthreads();  // (9)
  int r = s_rank.fold(SumI(), 0, sl.rank);
#pragma unroll
  for (int q = 0; q < MAXP; ++q) {
    if (!(okb >> q & 1u)) continue;
    const int j = tid * Q + q;
    if (r < L) {
      e1_out[2 * r] = kx1[j];
      e1_out[2 * r + 1] = ky1[j];
      e2_out[2 * r] = kx2[j];
      e2_out[2 * r + 1] = ky2[j];
      gap_out[r] = kgap[j];
      lv_out[r] = 1;
    }
    r += 1;
  }
  int n_win = 0;
  for (int w = 0; w < NWARP; ++w) n_win += sl.rank[w];
  for (int l = n_win + tid; l < L; l += THREADS) {
    e1_out[2 * l] = 0.f;
    e1_out[2 * l + 1] = 0.f;
    e2_out[2 * l] = 0.f;
    e2_out[2 * l + 1] = 0.f;
    gap_out[l] = 0.f;
    lv_out[l] = 0;
  }
#undef OWN
}

}  // namespace

// C interface (ctypes): points (B,N,3) float32, valid (B,N) bool, outputs
// e1, e2 (B,L,2) float32, line_valid (B,L) bool, end_gap (B,L) float32, all
// contiguous device arrays.  Launches B blocks on `stream`; returns the
// launch's cudaError_t.  The kernel's dynamic shared-memory limit is raised
// to what N_MAX points take once per process and device.
extern "C" int liwslam_extract_lines(const float* points, const unsigned char* valid, int B, int N,
                                     int L, float cont_thr, float min_len, float max_dis,
                                     float tol_angle, float* e1, float* e2, unsigned char* lv,
                                     float* end_gap, void* stream) {
  if (B < 1 || N < 1 || N > N_MAX || L < 1) return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(extract_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             POINT_BYTES * N_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  extract_lines_kernel<<<B, THREADS, POINT_BYTES * N, (cudaStream_t)stream>>>(
      points, valid, N, L, cont_thr, min_len, max_dis, tol_angle, e1, e2, lv, end_gap);
  return (int)cudaGetLastError();
}

// Registers and local memory a thread (its stack frame, spills included) of
// the kernel, as the loaded module reports them; returns the cudaError_t of
// the query.
extern "C" int liwslam_extract_lines_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, extract_lines_kernel);
  if (e == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
  }
  return (int)e;
}
