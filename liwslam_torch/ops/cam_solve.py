"""The camera sub-step's joint solve: kernel B4 and its plain version.

Port of ``liwslam/ops/cam_solve.py`` (``lm_solve_cam``, one Pallas launch
on the TPU).  One solve = the landmark-Schur LM of ``solve/cam_schur`` over
the 30-dim [previous frozen, camera free] pose window and F landmarks:

- base rows: the tracking solve's IMU, wheel, ground and prior rows (kernel
  B1's residual, ``ops/track_solve.residual``) with no laser rows;
- camera rows: whitened reprojections on the (F, Wc) observation grid,
  slot Wc-1 at the free camera pose, older slots at the frozen ring poses;
- damping ``lam*max(diag,1e-12)``, identity rows for frozen pose dims and
  frozen landmarks, the 6x6 landmark Schur complement into the pose block,
  an equilibrated 30x30 Cholesky, the landmark back-substitution, a zero
  pose step when it is non-finite and a zero landmark entry when that is,
  early exit on ftol / xtol (over pose and landmark steps and states) /
  stalled lambda, SO(3) wrap of both rotations;
- then the base-only Schur reduction of frame 0 at the last accepted point
  into the (dH, dg) that ``gn.sqrt_prior`` turns into the prior.

:func:`lm_solve_cam_batched` launches the hand-written CUDA kernel
(``csrc/cam_solve.cu``, one thread block per system, a batch grid of B
systems) for CUDA tensors and runs :func:`lm_solve_cam_plain` for CPU
tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from liwslam_torch.ops import track_solve as ts
from liwslam_torch.solve import cam_schur
from liwslam_torch.solve import gn

# the kernel's limits: landmarks and window slots per system, and the
# shared memory one block may hold (H100: 227 KB); its shared layout in
# floats: a fixed part, PER_FW a (slot, landmark) cell, PER_F a landmark
# (csrc/cam_solve.cu; tests/test_torch_kernel_limits.py holds the two equal)
F_MAX = 256
WC_MAX = 32
SMEM_MAX = 232448
FIXED, PER_FW, PER_F = 5712, 8, 85


class CamSolveInputs(NamedTuple):
    """Kernel B4's inputs for B systems (leading dim), all float32."""

    base: ts.TrackSolveInputs  # laser (B,0,11): no laser rows here
    Tic: torch.Tensor  # (B,4,4) imu -> camera extrinsic
    sqrt_info: torch.Tensor  # (B,2) fx / camera_sigma
    world0: torch.Tensor  # (B,F,3)
    lm_free: torch.Tensor  # (B,F) 1 free / 0 frozen
    obs: torch.Tensor  # (B,F,Wc,2) normalized observations
    use: torch.Tensor  # (B,F,Wc) 1 row used / 0 not
    ring: torch.Tensor  # (B,Wc,6) [p, q] frozen camera-frame poses


def smem_bytes(F: int, Wc: int) -> int:
    """Shared memory of one block of the kernel (see csrc/cam_solve.cu)."""
    return 4 * (FIXED + PER_FW * F * Wc + PER_F * F)


def pack_inputs(x0, free, world0, lm_free, obs, use, ring_p, ring_q, data, consts, Tic, sqrt_info):
    """Kernel inputs (B=1) from the camera sub-step's tensors and its W=2
    ``solve.factors.FactorData`` (no laser rows)."""
    base = ts.pack_inputs(x0, free, data, consts)
    base = base._replace(laser=base.laser[:, :0].contiguous())
    f32 = x0.dtype
    one = lambda t: t.to(f32)[None].contiguous()
    return CamSolveInputs(
        base=base,
        Tic=one(Tic),
        sqrt_info=one(sqrt_info),
        world0=one(world0),
        lm_free=one(lm_free),
        obs=one(obs),
        use=one(use),
        ring=one(torch.cat([ring_p, ring_q], -1)),
    )


# --------------------------------------------------------------------------
# plain version


def _solve_one(inp: CamSolveInputs, b, max_iters, ftol, xtol):
    x0 = inp.base.x0[b]
    res30 = lambda y: ts.residual(y, inp.base, b)
    x, wld, cost, it = cam_schur.lm_solve_cam_schur(
        res30,
        x0,
        inp.base.free[b],
        inp.world0[b],
        inp.lm_free[b] > 0,
        inp.obs[b],
        inp.use[b] > 0,
        inp.ring[b, :, 0:3],
        inp.ring[b, :, 3:6],
        inp.Tic[b],
        inp.sqrt_info[b],
        gn.LMConfig(max_iters=max_iters, ftol=ftol, xtol=xtol),
        wrap30=ts._wrap,
    )
    r, J = gn.linearize(res30, x)
    dH, dg = ts.schur_frame0(J, r)
    return x, wld, cost, dH, dg, torch.full((), it, dtype=torch.int32, device=x.device)


def lm_solve_cam_plain(inp: CamSolveInputs, *, max_iters=10, ftol=3e-4, xtol=1e-7):
    """Eager-PyTorch twin of kernel B4 over B systems (Jacobians by
    ``torch.func.jacfwd``).  Returns (x (B,30), world (B,F,3), cost (B,),
    dH (B,15,15), dg (B,15), iters (B,) int32)."""
    outs = [_solve_one(inp, b, max_iters, ftol, xtol) for b in range(inp.world0.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


# --------------------------------------------------------------------------
# kernel wrapper


def _lib():
    from liwslam_torch.ops import _build

    fn = _build.load()["cam_solve"].liwslam_cam_solve
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 11 + [p] * 7 + [i, i, i, i, i, f, f] + [p] * 7
        fn.restype = ctypes.c_int
    return fn


def lm_solve_cam_batched(inp: CamSolveInputs, *, max_iters=10, ftol=3e-4, xtol=1e-7,
                         frozen_dims=ts.FROZEN_POSE):
    """B systems: kernel B4 (one block each) for CUDA tensors, the plain
    version for CPU tensors.  Returns (x (B,30), world (B,F,3), cost (B,),
    dH (B,15,15), dg (B,15), iters (B,) int32).  The caller guarantees
    ``frozen_dims`` are not free (``track_solve.check_frozen``)."""
    if inp.world0.device.type == "cpu":
        return lm_solve_cam_plain(inp, max_iters=max_iters, ftol=ftol, xtol=xtol)
    B, F = inp.world0.shape[:2]
    Wc = inp.obs.shape[2]
    base = inp.base
    shapes = dict(
        x0=(B, 30), free=(B, 30), imu_J=(B, 15, 15), imu_sqrtP=(B, 15, 15), imu_X=(B, 15),
        prior_J=(B, 15, 15), prior_X=(B, 15), T_il=(B, 4, 4), T_iw=(B, 4, 4), wheel=(B, 9),
        scal=(B, 6), Tic=(B, 4, 4), sqrt_info=(B, 2), world0=(B, F, 3), lm_free=(B, F),
        obs=(B, F, Wc, 2), use=(B, F, Wc), ring=(B, Wc, 6),
    )
    tensors = {**{k: getattr(base, k) for k in shapes if k in base._fields}, **inp._asdict()}
    for name, shape in shapes.items():
        t = tensors[name]
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got {tuple(t.shape)}")
    if B < 1 or not 1 <= F <= F_MAX or not 1 <= Wc <= WC_MAX or smem_bytes(F, Wc) > SMEM_MAX:
        raise ValueError(
            f"lm_solve_cam: need B >= 1, 1 <= F <= {F_MAX}, 1 <= Wc <= {WC_MAX} and "
            f"{smem_bytes(F, Wc)} bytes of shared memory <= {SMEM_MAX}; got B={B}, F={F}, Wc={Wc}"
        )
    mask = 0
    for k in frozen_dims:
        mask |= 1 << int(k)
    dev = inp.world0.device
    x = torch.empty((B, 30), dtype=torch.float32, device=dev)
    world = torch.empty((B, F, 3), dtype=torch.float32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    dH = torch.empty((B, 15, 15), dtype=torch.float32, device=dev)
    dg = torch.empty((B, 15), dtype=torch.float32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the calling thread's current device
        err = _lib()(
            *[tensors[k].data_ptr() for k in shapes],
            B, F, Wc, int(max_iters), mask, float(ftol), float(xtol),
            x.data_ptr(), world.data_ptr(), cost.data_ptr(), dH.data_ptr(), dg.data_ptr(),
            iters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cam_solve kernel launch failed: cudaError_t {err}")
    lm_solve_cam_batched.launches += 1
    return x, world, cost, dH, dg, iters


lm_solve_cam_batched.launches = 0


def lm_solve_cam(x0, free, world0, lm_free, obs, use, ring_p, ring_q, data, consts, Tic, sqrt_info,
                 *, max_iters=10, ftol=3e-4, xtol=1e-7, frozen_dims=ts.FROZEN_POSE):
    """One camera joint solve.  Returns (x30_opt, world_opt (F,3), cost,
    dH (15,15), dg (15,)); feed dH/dg to ``solve/gn.sqrt_prior``."""
    inp = pack_inputs(x0, free, world0, lm_free, obs, use, ring_p, ring_q, data, consts, Tic, sqrt_info)
    x, world, cost, dH, dg, _ = lm_solve_cam_batched(
        inp, max_iters=max_iters, ftol=ftol, xtol=xtol, frozen_dims=frozen_dims
    )
    return x[0], world[0], cost[0], dH[0], dg[0]
