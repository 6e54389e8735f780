"""The yardstick of the kernels' rooflines: the H100's published peaks and
the bytes and operations of one launch of kernels B1 and B2, counted from
its shapes (frozen copies of the counts in the port's ``chip_smoke.py``,
``check_extract`` and ``check_track_solve``).

A launch's least time is the larger of its bytes over the HBM bandwidth
and its float32 operations over the float32 rate outside the tensor cores;
its roofline share is that least time over its measured device time."""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def extract_lines(B: int, N: int, L: int):
    """(bytes, operations) of one launch of B2 on B scans of N points."""
    # bytes: points + valid in, e1 + e2 + line_valid + end_gap out
    nbytes = N * 3 * 4 + N + L * (2 * 2 * 4 + 1 + 4)
    # operations: ~230 f32 ops a point (7 prefix-sum columns, gaps and
    # centroid ~20, corner response ~25, NMS ~15, joint test ~30 with acos,
    # TLS fit and projections ~80, span distance ~6, gates ~10)
    nops = 230 * N
    return B * nbytes, B * nops


def track_solve(in_bytes: int, M: int, iters):
    """(bytes, operations) of one launch of B1: its input bytes, the
    systems' laser-match capacity M and each system's LM iterations."""
    B = len(iters)
    nbytes = in_bytes + B * (30 + 1 + 225 + 15 + 1) * 4
    # operations per linearization: dual-number residuals with 6 tangents
    # (~7 ops per scalar op): M laser matches x ~450 scalar ops, IMU 5
    # passes x ~1500, wheel 2 x ~1200, ground 2 x ~400, whitening 5 x 1260;
    # H (900 entries x 37 rows + the 6x6 laser block x 2M rows), g and the
    # cost, 2 ops per multiply-add
    lin_ops = 7 * (M * 450 + 5 * 1500 + 2 * 1200 + 2 * 400) + 5 * 1260 + 2 * (
        900 * 37 + 36 * 2 * M + 30 * 37 + 6 * 2 * M + 37 + 2 * M
    )
    nops = 0
    for it in iters:
        n_lin = int(it) + 1
        # per LM step: 30x30 Cholesky (~9000 ops) + two triangular solves
        # (~1800) + scaling (~2000); Schur: 15x15 Cholesky, 16 solves,
        # 15x15x15 product
        nops += n_lin * lin_ops + (n_lin - 1) * 12800 + (2300 + 16 * 450 + 2 * 3375)
    return nbytes, nops


def least_s(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_S, nops / F32_FLOP_S)
