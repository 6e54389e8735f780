// Kernel B3: pyramidal Lucas-Kanade tracking for Hopper.
//
// Replaces the Pallas TPU kernel liwslam/ops/lk.py::lk_track_pallas
// (_kernel :92, _sample_window :70).  Its plain PyTorch version is
// liwslam_torch/camera/tracker.py::lk_descent.
//
// What it computes, for each of T tracks (one thread block each): the
// whole coarse-to-fine descent over the pyramid levels, `iters`
// Gauss-Newton steps a level on the 2x2 normal equations of the patch's
// ±1 px gradients (gxx, gyy + 1e-4, det clamped at 1e-12), each level's
// excursion clipped to ± the level's width / height; then the level-0
// verification: mean |patch0 - patch1| below the gate and the new position
// at least `radius` inside the image.  A patch is (2r+1)^2 bilinear taps
// at floor(c) + k with fraction c - floor(c); a tap outside the image has
// weight 0 (the one-hot semantics of the reference's sampling).  An
// invalid track keeps its position and is not ok.
//
// What bounds it on this card: nothing the card is rated for.  At T = 48
// tracks, radius 7, 3 levels and 6 iterations the kernel reads a few
// hundred KB of pyramid (the patches' taps) and does ~10 MFLOP: a few
// hundred nanoseconds at the memory rate, less at the float32 rate.  The
// time is the dependent chain inside each block: sample, block-reduce,
// solve the 2x2 on one thread, broadcast, sample again, 3 x (1 + iters)
// times.
//
// What the design does about it: one launch for all tracks and levels, so
// the chain never returns to the host; the pyramids stay in device memory
// and are read through the read-only cache (at 848x480 they fit in L2);
// one thread per patch pixel keeps its patch0 and gradient values in
// registers across the iterations, and the reductions are warp shuffles
// plus one small shared array.  Many tracks per block or one warp per
// track would shorten the chain; that is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 6;
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int PIX_PER_THREAD = 4;  // patch pixels a thread owns: radius <= 15
constexpr int MAX_RADIUS = 15;

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

// bilinear tap of `img` at (c0x + ox, c0y + oy) with fractions (fx, fy);
// taps outside the image read 0
__device__ __forceinline__ float tap(const float* __restrict__ img, int H, int W, int x, int y) {
  return (x >= 0 && x < W && y >= 0 && y < H) ? __ldg(img + (size_t)y * W + x) : 0.f;
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int H, int W, float cx,
                                        float cy, int ox, int oy) {
  const float c0x = floorf(cx), c0y = floorf(cy);
  const float fx = cx - c0x, fy = cy - c0y;
  const int x = (int)c0x + ox, y = (int)c0y + oy;
  const float v00 = tap(img, H, W, x, y), v01 = tap(img, H, W, x + 1, y);
  const float v10 = tap(img, H, W, x, y + 1), v11 = tap(img, H, W, x + 1, y + 1);
  return (v00 * (1.f - fx) + v01 * fx) * (1.f - fy) + (v10 * (1.f - fx) + v11 * fx) * fy;
}

// block-wide sum of NV values per thread; every thread gets the sums
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[NWARP]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) red[k][warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += red[k][w];
    v[k] = s;
  }
}

__global__ void __launch_bounds__(THREADS) lk_track_kernel(
    LkPyramids pyr, int levels, const float* __restrict__ pts, const bool* __restrict__ valid,
    const float* __restrict__ gate, int radius, int iters, float* __restrict__ new_pts,
    bool* __restrict__ ok_out) {
  __shared__ float red[3][NWARP];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = pts[2 * t], py = pts[2 * t + 1];
  if (!valid[t]) {
    if (tid == 0) {
      new_pts[2 * t] = px;
      new_pts[2 * t + 1] = py;
      ok_out[t] = false;
    }
    return;
  }
  const int P = 2 * radius + 1;
  const int NP = P * P;
  float dx = 0.f, dy = 0.f;  // displacement in level-0 pixels
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const float* i0 = pyr.img0[lvl];
    const float* i1 = pyr.img1[lvl];
    const int H = pyr.H[lvl], W = pyr.W[lvl];
    const float scale = (float)(1 << lvl);
    const float bx = px / scale, by = py / scale;
    float p0[PIX_PER_THREAD], gx[PIX_PER_THREAD], gy[PIX_PER_THREAD];
    float s3[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < PIX_PER_THREAD; ++k) {
      const int pix = tid + k * THREADS;
      p0[k] = gx[k] = gy[k] = 0.f;
      if (pix < NP) {
        const int oy = pix / P - radius, ox = pix % P - radius;
        p0[k] = sample(i0, H, W, bx, by, ox, oy);
        gx[k] = 0.5f * (sample(i0, H, W, bx + 1.f, by, ox, oy) - sample(i0, H, W, bx - 1.f, by, ox, oy));
        gy[k] = 0.5f * (sample(i0, H, W, bx, by + 1.f, ox, oy) - sample(i0, H, W, bx, by - 1.f, ox, oy));
        s3[0] += gx[k] * gx[k];
        s3[1] += gx[k] * gy[k];
        s3[2] += gy[k] * gy[k];
      }
    }
    block_sum<3>(s3, red);
    const float gxx = s3[0] + 1e-4f, gxy = s3[1], gyy = s3[2] + 1e-4f;
    const float det = fmaxf(gxx * gyy - gxy * gxy, 1e-12f);
    float dlx = dx / scale, dly = dy / scale;
    for (int it = 0; it < iters; ++it) {
      float s2[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < PIX_PER_THREAD; ++k) {
        const int pix = tid + k * THREADS;
        if (pix < NP) {
          const int oy = pix / P - radius, ox = pix % P - radius;
          const float e = p0[k] - sample(i1, H, W, bx + dlx, by + dly, ox, oy);
          s2[0] += e * gx[k];
          s2[1] += e * gy[k];
        }
      }
      block_sum<2>(s2, red);
      // every thread solves the same 2x2 from the same sums: no broadcast
      const float ux = (gyy * s2[0] - gxy * s2[1]) / det;
      const float uy = (gxx * s2[1] - gxy * s2[0]) / det;
      dlx = fminf(fmaxf(dlx + ux, -(float)W), (float)W);
      dly = fminf(fmaxf(dly + uy, -(float)H), (float)H);
    }
    dx = dlx * scale;
    dy = dly * scale;
  }

  // verification at level 0
  const float nx = px + dx, ny = py + dy;
  const int H0 = pyr.H[0], W0 = pyr.W[0];
  float s1[1] = {0.f};
#pragma unroll
  for (int k = 0; k < PIX_PER_THREAD; ++k) {
    const int pix = tid + k * THREADS;
    if (pix < NP) {
      const int oy = pix / P - radius, ox = pix % P - radius;
      s1[0] += fabsf(sample(pyr.img0[0], H0, W0, px, py, ox, oy) -
                     sample(pyr.img1[0], H0, W0, nx, ny, ox, oy));
    }
  }
  block_sum<1>(s1, red);
  if (tid == 0) {
    const float r = (float)radius;
    const float err = s1[0] / (float)NP;
    const bool inb = nx >= r && nx < (float)W0 - r && ny >= r && ny < (float)H0 - r;
    new_pts[2 * t] = nx;
    new_pts[2 * t + 1] = ny;
    ok_out[t] = inb && err < gate[0];
  }
}

}  // namespace

// C interface (ctypes).  pts (T,2) float32, valid (T,) bool, gate (1,)
// float32 on the device; outputs new_pts (T,2) float32 and ok (T,) bool.
// Launches T blocks on `stream` and returns the launch's cudaError_t.
extern "C" int liwslam_lk_track(LkPyramids pyr, int levels, const float* pts, const bool* valid,
                                const float* gate, int T, int radius, int iters, float* new_pts,
                                bool* ok, void* stream) {
  if (T < 1 || levels < 1 || levels > MAX_LEVELS || radius < 0 || radius > MAX_RADIUS || iters < 0)
    return (int)cudaErrorInvalidValue;
  lk_track_kernel<<<T, THREADS, 0, (cudaStream_t)stream>>>(pyr, levels, pts, valid, gate, radius,
                                                           iters, new_pts, ok);
  return (int)cudaGetLastError();
}
