"""Pyramidal Lucas-Kanade: kernel B3 and its wrapper.

Port of ``liwslam/ops/lk.py`` (``lk_track_pallas``, one Pallas launch for
the whole coarse-to-fine descent of every track).  The pyramids are built
outside the kernel (``camera.tracker.build_pyramid``, as the reference
package does); :func:`lk_track` launches the hand-written CUDA kernel
(``csrc/lk_track.cu``, four warps a track, every level's image windows
staged in shared memory at launch) for CUDA tensors and runs the plain
version ``camera.tracker.lk_descent`` for CPU tensors.

The TPU layout of the reference kernel (zero aprons, aligned windows and
rolls, tracks padded to multiples of 8, ``MAX_RADIUS`` = 10) is not carried
over; the kernel's own limits are ``radius <= 15`` and ``levels <= 6``.
``MARGIN`` is the kernel's margin, in each level's pixels, around the
staged window of the second image: a level whose displacement leaves it
reads device memory for its taps, with the same results.
"""

from __future__ import annotations

import ctypes

import torch

from liwslam_torch.camera import tracker as trk

MAX_LEVELS = 6
MAX_RADIUS = 15
MARGIN = 8


class _Pyramids(ctypes.Structure):
    _fields_ = [
        ("img0", ctypes.c_void_p * MAX_LEVELS),
        ("img1", ctypes.c_void_p * MAX_LEVELS),
        ("H", ctypes.c_int * MAX_LEVELS),
        ("W", ctypes.c_int * MAX_LEVELS),
    ]


def _lib():
    from liwslam_torch.ops import _build

    fn = _build.load()["lk_track"].liwslam_lk_track
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [_Pyramids, i, p, p, p, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{name}: expected a {dtype} CUDA tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {tuple(shape)}, got {tuple(t.shape)}")


def lk_descent(pyr0, pyr1, pts, valid, gate, *, radius, iters):
    """LK of ``pts`` (T,2) between two pyramids (lists of (H_l, W_l)
    float32 levels, finest first) with the verification gate ``gate`` (1,)
    on the device.  CPU tensors run ``tracker.lk_descent``; CUDA tensors
    launch kernel B3 (or raise).  Returns (new_pts (T,2), ok (T,) bool)."""
    if pts.device.type == "cpu":
        return trk.lk_descent(pyr0, pyr1, pts, valid, gate, radius=radius, iters=iters)
    T, levels = pts.shape[0], len(pyr0)
    if not (1 <= levels <= MAX_LEVELS and len(pyr1) == levels and 0 <= radius <= MAX_RADIUS and iters >= 0):
        raise ValueError(
            f"lk_track: need 1 <= levels <= {MAX_LEVELS} and 0 <= radius <= {MAX_RADIUS}, "
            f"got levels={levels}, radius={radius}"
        )
    _check(pts, "pts", torch.float32, (T, 2))
    _check(valid, "valid", torch.bool, (T,))
    _check(gate, "gate", torch.float32, (1,))
    pyr = _Pyramids()
    for lvl in range(levels):
        H, W = pyr0[lvl].shape
        _check(pyr0[lvl], f"pyr0[{lvl}]", torch.float32, (H, W))
        _check(pyr1[lvl], f"pyr1[{lvl}]", torch.float32, (H, W))
        pyr.img0[lvl], pyr.img1[lvl] = pyr0[lvl].data_ptr(), pyr1[lvl].data_ptr()
        pyr.H[lvl], pyr.W[lvl] = H, W
    new_pts = torch.empty((T, 2), dtype=torch.float32, device=pts.device)
    ok = torch.empty((T,), dtype=torch.bool, device=pts.device)
    if T == 0:
        return new_pts, ok
    with torch.cuda.device(pts.device):  # the launch goes to the calling thread's current device
        err = _lib()(
            pyr, levels, pts.data_ptr(), valid.data_ptr(), gate.data_ptr(), T, int(radius), int(iters),
            new_pts.data_ptr(), ok.data_ptr(), torch.cuda.current_stream(pts.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"lk_track kernel launch failed: cudaError_t {err}")
    lk_descent.launches += 1
    return new_pts, ok


lk_descent.launches = 0


def lk_track(img0, img1, pts, valid, *, radius=7, iters=10, levels=3, max_err=0.1):
    """Track ``pts`` (T,2) from ``img0`` to ``img1`` (H,W): the pyramids,
    the gate ``max_err * max(max(img0), 1)`` computed on the device (no
    host read), then :func:`lk_descent`.  Returns (new_pts, ok)."""
    gate = (max_err * torch.clamp(torch.amax(img0), min=1.0)).reshape(1).to(torch.float32)
    return lk_descent(
        trk.build_pyramid(img0, levels), trk.build_pyramid(img1, levels), pts, valid, gate,
        radius=radius, iters=iters,
    )
