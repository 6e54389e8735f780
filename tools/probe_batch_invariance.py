"""Which products and decompositions of the tracking step give a sequence
the same bits under ``torch.func.vmap`` as alone, on the GPU.

    python3 tools/probe_batch_invariance.py [--device cuda] [--draws 3]

``parallel/multiseq`` steps B sequences with ``torch.func.vmap`` of
``frontend.pipeline.tracking_step``; a batched run equals each sequence's
single-stream run bit for bit only if every op of the step computes a
sequence's values the same way whatever the batch.  For each product and
decomposition of the step, at the shapes the bench configuration gives it
(the operands the step shares across sequences, such as the IMU-to-laser
transform, left unbatched as under vmap), this runs the op on each of 32
random systems alone and vmapped over the first B of them, B = 1..32, in
two forms: the library call (``@``, ``torch.sum`` over dim 0, a
decomposition of one matrix) and the step's form (``geo.matmul`` /
``geo.matvec``, a cumsum's last row, ``gn.beside_identity``).  It prints a
line a site and form: the batch sizes at which some system's result
differs from its single call, and the largest difference; then one JSON
object of the same.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from liwslam_torch.core import geometry as geo  # noqa: E402
from liwslam_torch.solve import gn  # noqa: E402

NSYS = 32
BATCHES = tuple(range(1, NSYS + 1))


def _spd(g, n, dev):
    A = torch.randn(n, n, generator=g, dtype=torch.float64)
    return (A @ A.T / n + 0.1 * torch.eye(n, dtype=torch.float64)).float().to(dev)


def _eigh_flat(a, first_only=False):
    """Eigenvalues and eigenvectors of ``a`` in one tensor (of the first
    matrix of each pair with ``first_only``)."""
    S, V = torch.linalg.eigh(a)
    if first_only:
        S, V = S[..., 0, :], V[..., 0, :, :]
    return torch.cat([S, V.flatten(-2)], -1)


def sites(g, dev):
    """(name, library form, step form, per-system operand makers, shared
    operands).  A maker draws one system's operand."""
    r = lambda *s: (lambda: torch.randn(*s, generator=g).to(dev))
    tf = lambda: geo.make_tf(torch.randn(3, generator=g), 0.5 * torch.randn(3, generator=g)).to(dev)
    til = tf()
    Q12 = _spd(g, 12, dev)
    first = lambda t: t[..., 0, :, :]
    mm, mv = (lambda a, b: a @ b), (lambda a, v: (a @ v[..., None])[..., 0])
    return [
        ("4x4 @ 4x4 (tf_compose)", mm, geo.matmul, [tf, tf], []),
        ("4x4 @ shared 4x4 (pose @ T_imu_to_laser)", mm, geo.matmul, [tf], [til]),
        ("shared 4x4 @ 4x4 (T_imu_to_world @ delta)", lambda a, s: s @ a, lambda a, s: geo.matmul(s, a), [tf], [til]),
        ("3x3 @ 3 (tf_inv, de-skew velocity)", mv, geo.matvec, [r(3, 3), r(3)], []),
        ("shared 3x3 @ 3x3 @ shared 3x3 (de-skew rotation)",
         lambda a, s: s.T @ a @ s, lambda a, s: geo.matmul(geo.matmul(s.T, a), s), [r(3, 3)], [til[:3, :3]]),
        ("(33,3,3) @ (33,3,3) (IMU prefix products)", mm, geo.matmul, [r(33, 3, 3), r(33, 3, 3)], []),
        ("(33,3,3) @ (33,3) (IMU rotated accelerations)", mv, geo.matvec, [r(33, 3, 3), r(33, 3)], []),
        ("(17,15,15) @ (17,15,15) (IMU transition tree)", mm, geo.matmul, [r(17, 15, 15), r(17, 15, 15)], []),
        ("(33,15,12) @ shared 12x12 @ (33,12,15) (IMU noise)",
         lambda a, s: a @ s @ a.transpose(-1, -2),
         lambda a, s: geo.matmul(geo.matmul(a, s), a.transpose(-1, -2)), [r(33, 15, 12)], [Q12]),
        ("15x15 @ 15x15 (IMU Jacobian, covariance)", mm, geo.matmul, [r(15, 15), r(15, 15)], []),
        ("(8,4,4) @ (8,4,4) (wheel products)", mm, geo.matmul, [r(8, 4, 4), r(8, 4, 4)], []),
        ("(64,2) @ (2,64) (corner angles)", lambda a: a @ a.T, lambda a: geo.matmul(a, a.T), [r(64, 2)], []),
        ("(64,2) @ (2,1024) (line match angles)", lambda a, b: a @ b.T, lambda a, b: geo.matmul(a, b.T),
         [r(64, 2), r(1024, 2)], []),
        ("15x15 @ 15 (sqrt prior residual)", mv, lambda a, v: torch.sum(a * v, -1), [r(15, 15), r(15)], []),
        ("sum over 33 samples (IMU velocity, position)", lambda a: torch.sum(a, 0),
         lambda a: torch.cumsum(a, 0)[-1], [r(33, 3)], []),
        ("cholesky_ex 15x15 (IMU whitener)", lambda a: torch.linalg.cholesky_ex(a)[0],
         lambda a: first(torch.linalg.cholesky_ex(gn.beside_identity(a))[0]), [lambda: _spd(g, 15, dev)], []),
        ("eigh 15x15 (sqrt prior)", _eigh_flat, lambda a: _eigh_flat(gn.beside_identity(a), first_only=True),
         [lambda: _spd(g, 15, dev)], []),
    ]


def probe(form, makers, shared, draws_of):
    """Batch sizes at which some system's vmapped result differs from its
    single call, and the largest |difference|."""
    bad, worst = set(), 0.0
    for per in draws_of:
        single = torch.stack([form(*[p[b] for p in per], *shared) for b in range(NSYS)])
        in_dims = (0,) * len(per) + (None,) * len(shared)
        for B in BATCHES:
            out = torch.func.vmap(form, in_dims=in_dims)(*[p[:B] for p in per], *shared)
            d = (out - single[:B]).abs().max().item()
            if d > 0 or not torch.equal(out, single[:B]):
                bad.add(B)
                worst = max(worst, d)
    return sorted(bad), worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--draws", type=int, default=3, help="random draws of the 32 systems a site")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("probe_batch_invariance: CUDA is not available", file=sys.stderr)
        return 1
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"{torch.cuda.get_device_name(0)} (torch {torch.__version__}, CUDA {torch.version.cuda}); {smi}")
    g = torch.Generator().manual_seed(0)
    table = sites(g, dev)
    result = {}
    for name, lib, step, makers, shared in table:
        draws_of = [[torch.stack([m() for _ in range(NSYS)]) for m in makers] for _ in range(args.draws)]
        row = {}
        for form_name, form in (("library", lib), ("step", step)):
            bad, worst = probe(form, makers, shared, draws_of)
            row[form_name] = dict(differs_at_B=bad, max_abs_diff=worst)
            print(f"{name} [{form_name}]: differs at B={bad or 'none'} (max |diff| {worst:.3e})", flush=True)
        result[name] = row
    print(json.dumps({"batch_invariance": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
