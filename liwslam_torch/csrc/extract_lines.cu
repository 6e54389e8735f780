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
// What the design does about it: one launch per scan with every stage in
// shared memory (144 B per point, dynamic shared memory).  Each of
// the 512 threads owns a run of consecutive points; block-wide prefix
// sums, forward cummax ("last breakpoint at or before i") and reverse
// cummin ("next breakpoint after i") are a sequential pass over each
// thread's run plus a warp-shuffle scan of the run totals.  Where the TPU
// kernel carried payloads through its scans, this one reads the payload
// from shared memory at the found index.  The per-span maximum distance is
// an atomicMax of the non-negative float bits into the span's slot
// (exact: max does not depend on order).  Compaction writes winner r to
// row r, r = exclusive prefix count of winners.  B scans run as B blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARP = THREADS / 32;
constexpr int STEP = 3;  // corner-response half window
constexpr float EPS = 1e-8f;
constexpr float BIG = 1e9f;
constexpr int ND = 6;   // double arrays per point (prefix moments)
constexpr int NF = 16;  // float arrays per point
constexpr int NI = 8;   // int arrays per point

// flag bits
constexpr int F_VALID = 1, F_START = 2, F_INTERIOR = 4, F_BP = 8, F_ENDPT = 16, F_KEEP = 32,
              F_CAND = 64, F_OK = 128;

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

// Inclusive block-wide scan of a[0..n) in place (reverse: from the end).
// Thread t owns logical positions [t*P, t*P + P), P = ceil(n / THREADS).
template <class T, class Op>
__device__ void block_scan(T* a, int n, Op op, T ident, bool rev, T* wtmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = (n + THREADS - 1) / THREADS;
  const int lo = tid * P, hi = min(n, lo + P);
  T run = ident;
  for (int q = lo; q < hi; ++q) {
    const int i = rev ? n - 1 - q : q;
    run = op(run, a[i]);
    a[i] = run;
  }
  // exclusive prefix of the run totals: warp shuffle scan, then the warps
  T incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = op(o, incl);
  }
  if (lane == 31) wtmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NWARP ? wtmp[lane] : ident;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = op(o, w);
    }
    const T wex = __shfl_up_sync(0xffffffffu, w, 1);
    if (lane < NWARP) wtmp[32 + lane] = lane == 0 ? ident : wex;
  }
  __syncthreads();
  T lex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) lex = ident;
  const T pre = op(wtmp[32 + warp], lex);
  for (int q = lo; q < hi; ++q) {
    const int i = rev ? n - 1 - q : q;
    a[i] = op(pre, a[i]);
  }
  __syncthreads();
}

__device__ float block_sum(float v, float* wtmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) wtmp[warp] = v;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < NWARP; ++w) tot += wtmp[w];
  __syncthreads();
  return tot;
}

__global__ void __launch_bounds__(THREADS) extract_lines_kernel(
    const float* __restrict__ points, const unsigned char* __restrict__ valid_in, int N, int L,
    float cont_thr, float min_len, float max_dis, float tol_angle, float* __restrict__ e1_out,
    float* __restrict__ e2_out, unsigned char* __restrict__ lv_out,
    float* __restrict__ gap_out) {
  extern __shared__ double smem[];
  __shared__ float wf[64];
  __shared__ int wi[64];
  __shared__ double wd[64];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  points += (size_t)b * N * 3;
  valid_in += (size_t)b * N;
  e1_out += (size_t)b * L * 2;
  e2_out += (size_t)b * L * 2;
  lv_out += (size_t)b * L;
  gap_out += (size_t)b * L;

  // inclusive prefix sums of [x y xx xy yy m] in float64: a span's sums
  // are differences of prefixes that grow to ~1e4 over a scan, and f32
  // rounding there moves the TLS direction of short spans by millimetres
  double* cs = smem;
  float* x = (float*)(cs + 6 * N);
  float* y = x + N;
  float* xc = y + N;
  float* yc = xc + N;
  float* gapf = yc + N;
  float* resp = gapf + N;
  float* nx = resp + N;
  float* ny = nx + N;
  float* cc = ny + N;
  float* maxd = cc + N;
  float* e1x = maxd + N;
  float* e1y = e1x + N;
  float* e2x = e1y + N;
  float* e2y = e2x + N;
  float* len = e2y + N;
  float* egap = len + N;
  int* seg = (int*)(egap + N);
  int* sstart = seg + N;
  int* send = sstart + N;
  int* ka = send + N;   // scan scratch
  int* kb = ka + N;     // scan scratch
  int* span = kb + N;
  int* rank = span + N;
  int* flag = rank + N;

  // --- 1. load, continuity gaps, segmentation flags, centroid ------------
  for (int i = tid; i < N; i += THREADS) {
    x[i] = points[3 * i];
    y[i] = points[3 * i + 1];
  }
  __syncthreads();
  float sx = 0.f, sy = 0.f, sm = 0.f;
  for (int i = tid; i < N; i += THREADS) {
    const bool v = valid_in[i] != 0;
    float g = 0.f;
    bool cont = false;
    if (i > 0) {
      const float dx = x[i] - x[i - 1], dy = y[i] - y[i - 1];
      g = sqrtf(dx * dx + dy * dy);
      cont = g <= cont_thr && v && valid_in[i - 1] != 0;
    }
    gapf[i] = g;
    flag[i] = (v ? F_VALID : 0) | (cont ? 0 : F_START);
    seg[i] = cont ? 0 : 1;
    if (v) {
      sx += x[i];
      sy += y[i];
      sm += 1.f;
    }
  }
  const float n_all = fmaxf(block_sum(sm, wf), 1.f);
  const float refx = block_sum(sx, wf) / n_all;
  const float refy = block_sum(sy, wf) / n_all;
  for (int i = tid; i < N; i += THREADS) {
    const float m = (flag[i] & F_VALID) ? 1.f : 0.f;
    const float a = x[i] - refx, c = y[i] - refy;
    xc[i] = a;
    yc[i] = c;
    const float xm = a * m, ym = c * m;
    cs[0 * N + i] = xm;
    cs[1 * N + i] = ym;
    cs[2 * N + i] = xm * xm;
    cs[3 * N + i] = xm * ym;
    cs[4 * N + i] = ym * ym;
    cs[5 * N + i] = m;
    ka[i] = (flag[i] & F_START) ? i : -1;
    kb[i] = (flag[i] & F_START) ? i : 2 * N;
  }
  __syncthreads();
  block_scan(seg, N, SumI(), 0, false, wi);  // segment id, starting at 1
  for (int k = 0; k < 6; ++k) block_scan(cs + k * N, N, SumD(), 0.0, false, wd);
  block_scan(ka, N, MaxI(), -1, false, wi);     // segment start at or before i
  block_scan(kb, N, MinI(), 2 * N, true, wi);   // next segment start at or after i
  for (int i = tid; i < N; i += THREADS) {
    sstart[i] = ka[i];
    const int ns = i + 1 < N ? kb[i + 1] : N;
    send[i] = min(ns - 1, N - 1);
  }
  __syncthreads();

  // --- 2. corner response over the clamped +-STEP window -----------------
  for (int i = tid; i < N; i += THREADS) {
    const int j = max(i - STEP, sstart[i]);
    const int k = min(i + STEP, send[i]);
    const float v1x = x[j] - x[i], v1y = y[j] - y[i];
    const float v2x = x[k] - x[i], v2y = y[k] - y[i];
    const float n1 = sqrtf(v1x * v1x + v1y * v1y), n2 = sqrtf(v2x * v2x + v2y * v2y);
    float r = (v1x * v2x + v1y * v2y) / fmaxf(n1 * n2, EPS);
    const bool interior = i > sstart[i] && i < send[i] && (flag[i] & F_VALID);
    if (!(interior && n1 > EPS && n2 > EPS)) r = -1.f;
    // resp[] holds the vote (interior only); the point's own response
    // goes to `len` until the NMS below has read every vote
    resp[i] = interior ? r : -BIG;
    len[i] = r;
    if (interior) flag[i] |= F_INTERIOR;
  }
  __syncthreads();

  // --- 3. strict NMS within +-STEP (same segment), breakpoints -----------
  for (int i = tid; i < N; i += THREADS) {
    float nb = -BIG;
    for (int d = 1; d <= STEP; ++d) {
      if (i - d >= 0 && seg[i - d] == seg[i]) nb = fmaxf(nb, resp[i - d]);
      if (i + d < N && seg[i + d] == seg[i]) nb = fmaxf(nb, resp[i + d]);
    }
    const int f = flag[i];
    const bool is_max = (f & F_INTERIOR) && len[i] > nb;
    const bool endpt = i == sstart[i] || i == send[i];
    const bool bp = is_max || (endpt && (f & F_VALID));
    flag[i] = f | (bp ? F_BP : 0) | (endpt ? F_ENDPT : 0);
    ka[i] = bp ? i : -1;
    kb[i] = bp ? i : N + 1;
  }
  __syncthreads();
  block_scan(ka, N, MaxI(), -1, false, wi);    // last breakpoint at or before i
  block_scan(kb, N, MinI(), N + 1, true, wi);  // next breakpoint at or after i

  // --- 3b. merge near-collinear joints -----------------------------------
  for (int i = tid; i < N; i += THREADS) {
    const int f = flag[i];
    const int pv = i > 0 ? ka[i - 1] : -1;
    const int nv = i + 1 < N ? kb[i + 1] : N + 1;
    const bool in_p = pv >= 0 && pv < N, in_n = nv >= 0 && nv < N;
    const float px = in_p ? x[pv] : 0.f, py = in_p ? y[pv] : 0.f;
    const float qx = in_n ? x[nv] : 0.f, qy = in_n ? y[nv] : 0.f;
    const bool has_p = pv >= 0 && in_p && seg[pv] == seg[i];
    const bool has_n = nv <= N - 1 && in_n && seg[nv] == seg[i];
    const float u1x = px - x[i], u1y = py - y[i], u2x = qx - x[i], u2y = qy - y[i];
    const float jc = (u1x * u2x + u1y * u2y) /
                     fmaxf(sqrtf(u1x * u1x + u1y * u1y) * sqrtf(u2x * u2x + u2y * u2y), EPS);
    const float ang = acosf(fminf(fmaxf(jc, -1.f), 1.f));
    const bool survives = fabsf(ang) < tol_angle;
    const bool keep = (f & F_BP) && ((f & F_ENDPT) || survives || !(has_p && has_n));
    if (keep) flag[i] = f | F_KEEP;
  }
  __syncthreads();
  for (int i = tid; i < N; i += THREADS) {
    const bool keep = flag[i] & F_KEEP;
    span[i] = keep ? i : -1;
    kb[i] = keep ? i : N + 1;
  }
  __syncthreads();
  block_scan(span, N, MaxI(), -1, false, wi);  // the span a point belongs to
  block_scan(kb, N, MinI(), N + 1, true, wi);  // next kept breakpoint at or after i

  // --- 4. TLS line fit over [i, i2] for every kept breakpoint i ----------
  for (int i = tid; i < N; i += THREADS) {
    const int f = flag[i];
    const int se = i + 1 < N ? kb[i + 1] : N + 1;
    const int i2 = min(max(se, 0), N - 1);
    bool cand = (f & F_KEEP) && se <= N - 1 && se - i >= 2 && seg[i2] == seg[i] && (f & F_VALID);
    float S[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) S[k] = (float)(cs[k * N + i2] - (i > 0 ? cs[k * N + i - 1] : 0.0));
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
    const float d1 = vx * xc[i] + vy * yc[i] + c;
    const float d2 = vx * xc[i2] + vy * yc[i2] + c;
    const float p1x = xc[i] - d1 * vx + refx, p1y = yc[i] - d1 * vy + refy;
    const float p2x = xc[i2] - d2 * vx + refx, p2y = yc[i2] - d2 * vy + refy;
    const float lx = p2x - p1x, ly = p2y - p1y;
    nx[i] = vx;
    ny[i] = vy;
    cc[i] = c;
    e1x[i] = p1x;
    e1y[i] = p1y;
    e2x[i] = p2x;
    e2y[i] = p2y;
    len[i] = sqrtf(lx * lx + ly * ly);
    egap[i] = fmaxf(i + 1 < N ? gapf[i + 1] : gapf[N - 1], gapf[i2]);
    maxd[i] = 0.f;
    if (cand) flag[i] = f | F_CAND;
  }
  __syncthreads();
  // max |point-to-line distance| over each span [i1, i2): the points whose
  // last kept breakpoint is i1
  for (int p = tid; p < N; p += THREADS) {
    const int s = span[p];
    if (s >= 0 && (flag[p] & F_VALID)) {
      const float d = fabsf(nx[s] * xc[p] + ny[s] * yc[p] + cc[s]);
      atomicMax((int*)&maxd[s], __float_as_int(d));
    }
  }
  __syncthreads();

  // --- 5. gates and compaction of the first L winners --------------------
  for (int i = tid; i < N; i += THREADS) {
    const bool ok = (flag[i] & F_CAND) && maxd[i] <= max_dis && len[i] >= min_len &&
                    isfinite(len[i]);
    rank[i] = ok ? 1 : 0;
    if (ok) flag[i] |= F_OK;
  }
  __syncthreads();
  block_scan(rank, N, SumI(), 0, false, wi);
  const int n_win = rank[N - 1];
  for (int i = tid; i < N; i += THREADS) {
    const int r = rank[i] - 1;  // exclusive rank of a winner
    if ((flag[i] & F_OK) && r < L) {
      e1_out[2 * r] = e1x[i];
      e1_out[2 * r + 1] = e1y[i];
      e2_out[2 * r] = e2x[i];
      e2_out[2 * r + 1] = e2y[i];
      gap_out[r] = egap[i];
      lv_out[r] = 1;
    }
  }
  for (int l = n_win + tid; l < L; l += THREADS) {
    e1_out[2 * l] = 0.f;
    e1_out[2 * l + 1] = 0.f;
    e2_out[2 * l] = 0.f;
    e2_out[2 * l + 1] = 0.f;
    gap_out[l] = 0.f;
    lv_out[l] = 0;
  }
}

}  // namespace

// Dynamic shared memory for a scan of n points.
extern "C" int liwslam_extract_lines_smem_bytes(int n) {
  return (ND * 8 + (NF + NI) * 4) * n;
}

// C interface (ctypes): points (B,N,3) float32, valid (B,N) bool, outputs
// e1, e2 (B,L,2) float32, line_valid (B,L) bool, end_gap (B,L) float32, all
// contiguous device arrays.  Launches B blocks on `stream`; returns the
// launch's cudaError_t.
extern "C" int liwslam_extract_lines(const float* points, const unsigned char* valid, int B, int N,
                                     int L, float cont_thr, float min_len, float max_dis,
                                     float tol_angle, float* e1, float* e2, unsigned char* lv,
                                     float* end_gap, void* stream) {
  if (B < 1 || N < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int bytes = liwslam_extract_lines_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      extract_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  extract_lines_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      points, valid, N, L, cont_thr, min_len, max_dis, tol_angle, e1, e2, lv, end_gap);
  return (int)cudaGetLastError();
}
