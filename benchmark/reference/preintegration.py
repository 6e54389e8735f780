"""IMU and wheel-odometry preintegration on torch tensors: the benchmark's
frozen reference copy of the port's ``frontend/preintegration``.

Originally a port of ``liwslam/frontend/preintegration.py`` and
``liwslam/ops/preint_parallel.py`` (reference preintegrators:
``imu_preintegraption.h:105-209`` and
``wheel_odom_preintegration.h:44-153``).

- IMU: the 15-state ``X = [alpha, beta, gamma, ba, bw]`` with bias Jacobian
  ``J`` and covariance ``P``.  One inter-frame interval is integrated by
  :func:`imu_interval_parallel`: the rotation prefix is a log-depth product
  and the ``(F, Q)`` covariance pairs compose in a log-depth tree (the same
  associative forms as the reference package's XLA scan; it is not a Pallas
  kernel there, so it stays eager here).  Semantics equal the per-sample
  Euler recursion (zero-order hold of each sample, final hold to the frame
  stamp) up to float reassociation, for valid-prefix masks.
- Wheel: consecutive absolute odometry poses become a body twist (pairs
  closer than 50 ms are skipped) that integrates ``delta_T``.

Timestamps are int32 microseconds relative to a rolling origin; carries are
rebased with :func:`imu_rebase` / :func:`wheel_rebase`.

Known reference deviation (kept): ``F[gamma,gamma] = -skew(gyro - bw)``
where the reference writes ``ba`` (imu_preintegraption.h:192, a typo).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import geometry as geo

N_STATE = 15
US = 1e-6  # microseconds -> seconds
TIME_DTYPE = torch.int32


def time_us(t_us, device) -> torch.Tensor:
    """A 0-d int32 microsecond time on ``device``.  A Python int becomes a
    fill on the device: ``torch.as_tensor`` would copy it from the host,
    and a host-to-device copy synchronises the stream."""
    if isinstance(t_us, torch.Tensor):
        return t_us.to(device=device, dtype=TIME_DTYPE)
    return torch.full((), int(t_us), dtype=TIME_DTYPE, device=device)


def imu_noise_Q(params, device="cpu") -> torch.Tensor:
    """Diagonal 12x12 noise covariance (imu_preintegraption.h:24-43)."""
    import numpy as np

    q = np.zeros((12, 12))
    q[0:3, 0:3] = np.diag(np.square(params.imu_noise_acc_sigma))
    q[3:6, 3:6] = np.diag(np.square(params.imu_noise_gyro_sigma))
    q[6:9, 6:9] = np.diag(np.square(params.imu_bias_acc_sigma))
    q[9:12, 9:12] = np.diag(np.square(params.imu_bias_gyro_sigma))
    return torch.as_tensor(q, dtype=torch.float32, device=device)


class ImuCarry(NamedTuple):
    X: torch.Tensor  # (15,)
    J: torch.Tensor  # (15,15)
    P: torch.Tensor  # (15,15)
    last_acc: torch.Tensor  # (3,) zero-order-hold sample
    last_gyro: torch.Tensor  # (3,)
    last_t_us: torch.Tensor  # () int32
    Dt: torch.Tensor  # () accumulated interval, seconds
    has_sample: torch.Tensor  # () bool


class ImuPreintResult(NamedTuple):
    X: torch.Tensor  # (15,)
    J: torch.Tensor  # (15,15)
    sqrt_inverse_P: torch.Tensor  # (15,15) whitener W: |W r|^2 == r' P^-1 r
    Dt: torch.Tensor  # ()
    linearized_ba: torch.Tensor  # (3,)
    linearized_bw: torch.Tensor  # (3,)


def imu_reset(t_us, ba, bw) -> ImuCarry:
    """reset_imu_measure (imu_preintegraption.h:113-124) with biases
    ``ba``, ``bw`` (tensors; their device and dtype carry over)."""
    dev, dt = ba.device, ba.dtype
    X = torch.cat([torch.zeros(9, dtype=dt, device=dev), ba, bw])
    eye = torch.eye(N_STATE, dtype=dt, device=dev)
    return ImuCarry(
        X=X,
        J=eye,
        P=eye * 1e-5,
        last_acc=torch.zeros(3, dtype=dt, device=dev),
        last_gyro=torch.zeros(3, dtype=dt, device=dev),
        last_t_us=time_us(t_us, dev),
        Dt=torch.zeros((), dtype=dt, device=dev),
        has_sample=torch.zeros((), dtype=torch.bool, device=dev),
    )


def imu_rebase(carry: ImuCarry, shift_us) -> ImuCarry:
    """Shift the carry's time origin forward by ``shift_us`` (exact)."""
    return carry._replace(last_t_us=carry.last_t_us - shift_us)


def whitener_from_cov(P):
    """Lower-triangular W with W^T W == P^{-1}: triangular solve of chol(P)."""
    L, _ = torch.linalg.cholesky_ex(P)
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def imu_result(carry: ImuCarry) -> ImuPreintResult:
    """get_preintegraption_result (imu_preintegraption.h:147-152)."""
    return ImuPreintResult(
        X=carry.X,
        J=carry.J,
        sqrt_inverse_P=whitener_from_cov(carry.P),
        Dt=carry.Dt,
        linearized_ba=carry.X[9:12],
        linearized_bw=carry.X[12:15],
    )


def _row(a, i):
    """``a[i]`` for a 0-d index tensor ``i`` as a gather: indexing with a
    0-d tensor reads the index on the host, which synchronises."""
    return a.index_select(0, i.reshape(1))[0]


def _prefix_products(seq):
    """Inclusive ordered prefix products seq[0] @ ... @ seq[j] (log depth)."""
    n = seq.shape[0]
    d = 1
    while d < n:
        seq = torch.cat([seq[:d], geo.matmul(seq[:-d], seq[d:])], 0)
        d *= 2
    return seq


def _compose_fq(F, Q):
    """Fold the ordered (F, Q) step list into one pair with
    (F1,Q1) o (F2,Q2) = (F2 F1, F2 Q1 F2' + Q2), as a log-depth tree."""
    while F.shape[0] > 1:
        if F.shape[0] % 2:
            eye = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
            F = torch.cat([F, eye[None]], 0)
            Q = torch.cat([Q, torch.zeros_like(Q[:1])], 0)
        F1, F2 = F[0::2], F[1::2]
        Q1, Q2 = Q[0::2], Q[1::2]
        F = geo.matmul(F2, F1)
        Q = geo.matmul(geo.matmul(F2, Q1), F2.transpose(-1, -2)) + Q2
    return F[0], Q[0]


def imu_interval_parallel(carry: ImuCarry, acc, gyro, t_us, mask, t_end_us, Q) -> ImuCarry:
    """Integrate one interval's samples (valid-prefix ``mask``) plus the
    final hold to ``t_end_us``; returns the carry the sequential
    add-samples + update-only-t pair would."""
    dtype, dev = carry.X.dtype, carry.X.device
    N = acc.shape[0]
    t_end = time_us(t_end_us, dev)
    ba = carry.X[9:12]
    bw = carry.X[12:15]

    # step j ends at event j (sample j, or t_end for padding/final) and
    # integrates the value of event j-1 (event -1 = the held carry sample)
    e_t = torch.where(mask, t_us, t_end)
    ends = torch.cat([e_t, t_end[None]])
    starts = torch.cat([carry.last_t_us[None], e_t])
    dts = torch.clamp((ends - starts).to(dtype) * US, min=0.0)
    # empty carry: the first sample only primes (no integration before it)
    dts = torch.cat([torch.where(carry.has_sample, dts[0], 0.0)[None], dts[1:]])
    a_unb = torch.cat([carry.last_acc[None], acc], 0) - ba
    w_unb = torch.cat([carry.last_gyro[None], gyro], 0) - bw

    dR = geo.exp_so3(w_unb * dts[:, None])  # (N+1,3,3)
    R0 = geo.exp_so3(carry.X[6:9])
    prefix = _prefix_products(torch.cat([R0[None], dR], 0))  # (N+2,3,3)
    R_start = prefix[:-1]
    R_final = prefix[-1]

    Ra = geo.matvec(R_start, a_unb)
    db = Ra * dts[:, None]
    # sums over the samples as the last row of a cumsum: a scan along dim 0
    # adds in sample order whatever the batch (a sum over a leading dim
    # splits its adds by the batch count on the card; geo.matmul)
    cs_db = torch.cumsum(db, 0)
    beta_start = carry.X[3:6] + cs_db - db  # exclusive prefix
    da = beta_start * dts[:, None] + 0.5 * Ra * (dts * dts)[:, None]
    X = torch.cat(
        [
            carry.X[0:3] + torch.cumsum(da, 0)[-1],
            carry.X[3:6] + cs_db[-1],
            geo.log_SO3(R_final),
            carry.X[9:15],
        ]
    )

    # F/G per step (imu_preintegraption.h:170-208)
    n1 = N + 1
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(n1, 3, 3)
    z3 = torch.zeros(n1, 3, 3, dtype=dtype, device=dev)
    Fc = torch.cat(
        [
            torch.cat([z3, eye3, z3, z3, z3], -1),
            torch.cat([z3, z3, -geo.matmul(R_start, geo.skew(a_unb)), -R_start, z3], -1),
            torch.cat([z3, z3, -geo.skew(w_unb), z3, -eye3], -1),
            torch.zeros(n1, 6, 15, dtype=dtype, device=dev),
        ],
        -2,
    )
    F = torch.eye(N_STATE, dtype=dtype, device=dev) + Fc * dts[:, None, None]
    G = torch.cat(
        [
            torch.zeros(n1, 3, 12, dtype=dtype, device=dev),
            torch.cat([-R_start, z3, z3, z3], -1),
            torch.cat([z3, -eye3, z3, z3], -1),
            torch.cat([z3, z3, eye3, z3], -1),
            torch.cat([z3, z3, z3, eye3], -1),
        ],
        -2,
    )
    Gdt = G * dts[:, None, None]
    Qd = geo.matmul(geo.matmul(Gdt, Q), Gdt.transpose(-1, -2))
    F_tot, Q_tot = _compose_fq(F, Qd)

    n_valid = torch.sum(mask.to(torch.int32))
    last_idx = torch.clamp(n_valid - 1, min=0)
    has_any = n_valid > 0
    return carry._replace(
        X=X,
        J=geo.matmul(F_tot, carry.J),
        P=geo.matmul(geo.matmul(F_tot, carry.P), F_tot.T) + Q_tot,
        Dt=carry.Dt + torch.sum(dts),
        last_t_us=t_end,
        last_acc=torch.where(has_any, _row(acc, last_idx), carry.last_acc),
        last_gyro=torch.where(has_any, _row(gyro, last_idx), carry.last_gyro),
        has_sample=carry.has_sample | has_any,
    )


def _imu_update(carry: ImuCarry, dt, Q) -> ImuCarry:
    """One Euler propagation step over ``dt`` seconds with the held sample
    (imu_preintegraption.h:170-208)."""
    X, dtype, dev = carry.X, carry.X.dtype, carry.X.device
    gamma, ba, bw = X[6:9], X[9:12], X[12:15]
    Rz = geo.exp_so3(gamma)
    a_unb = carry.last_acc - ba
    w_unb = carry.last_gyro - bw
    Ra = Rz @ a_unb
    X_n = torch.cat(
        [
            X[0:3] + X[3:6] * dt + 0.5 * Ra * dt * dt,
            X[3:6] + Ra * dt,
            geo.log_SO3(Rz @ geo.exp_so3(w_unb * dt)),
            X[9:15],
        ]
    )
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.zeros((N_STATE, N_STATE), dtype=dtype, device=dev)
    F[0:3, 3:6] = eye3
    F[3:6, 6:9] = -Rz @ geo.skew(a_unb)
    F[3:6, 9:12] = -Rz
    F[6:9, 6:9] = -geo.skew(w_unb)  # the reference's (gyro - ba): a typo
    F[6:9, 12:15] = -eye3
    F = torch.eye(N_STATE, dtype=dtype, device=dev) + F * dt
    G = torch.zeros((N_STATE, 12), dtype=dtype, device=dev)
    G[3:6, 0:3] = -Rz
    G[6:9, 3:6] = -eye3
    G[9:12, 6:9] = eye3
    G[12:15, 9:12] = eye3
    Gdt = G * dt
    return carry._replace(X=X_n, J=F @ carry.J, P=F @ carry.P @ F.T + Gdt @ Q @ Gdt.T, Dt=carry.Dt + dt)


def _where(cond, new: ImuCarry, old: ImuCarry) -> ImuCarry:
    return ImuCarry(*[torch.where(cond, a, b) for a, b in zip(new, old)])


def imu_add_samples(carry: ImuCarry, acc, gyro, t_us, mask, Q) -> ImuCarry:
    """Feed a padded batch of time-ordered IMU samples, one Euler step a
    sample (add_imu_measure): acc / gyro (N,3), t_us (N,) int32, mask (N,)
    bool; masked entries are skipped.  The first sample ever only primes
    the held sample."""
    for a, w, t, m in zip(acc, gyro, t_us, mask):
        dt = (t - carry.last_t_us).to(carry.X.dtype) * US
        c = _where(m & carry.has_sample, _imu_update(carry, dt, Q), carry)
        carry = c._replace(
            last_acc=torch.where(m, a, c.last_acc),
            last_gyro=torch.where(m, w, c.last_gyro),
            last_t_us=torch.where(m, t.to(TIME_DTYPE), c.last_t_us),
            has_sample=c.has_sample | m,
        )
    return carry


def imu_update_only_t(carry: ImuCarry, t_us, Q) -> ImuCarry:
    """Extend the integral to the frame stamp ``t_us`` with the held sample
    (imu_preintegraption.h:139-146)."""
    t = time_us(t_us, carry.X.device)
    dt = (t - carry.last_t_us).to(carry.X.dtype) * US
    return _where(carry.has_sample, _imu_update(carry, dt, Q)._replace(last_t_us=t), carry)


def imu_result_update_bias(res: ImuPreintResult, ba_new, bw_new) -> ImuPreintResult:
    """First-order bias repair (imu_preint_result::update_value_with_bias,
    imu_preintegraption.h:68-102)."""
    dba = ba_new - res.linearized_ba
    dbw = bw_new - res.linearized_bw
    J, X = res.J, res.X
    X = torch.cat(
        [
            X[0:3] + J[0:3, 9:12] @ dba + J[0:3, 12:15] @ dbw,
            X[3:6] + J[3:6, 9:12] @ dba + J[3:6, 12:15] @ dbw,
            X[6:9] + J[6:9, 12:15] @ dbw,
            ba_new,
            bw_new,
        ]
    )
    return res._replace(X=X, linearized_ba=ba_new, linearized_bw=bw_new)


# ---------------------------------------------------------------------------
# Wheel odometry


class WheelCarry(NamedTuple):
    delta_T: torch.Tensor  # (4,4)
    v: torch.Tensor  # (3,) body linear velocity estimate
    omega: torch.Tensor  # (3,)
    last_pose: torch.Tensor  # (4,4) last accepted absolute odom pose
    last_pose_t_us: torch.Tensor  # () int32
    last_update_t_us: torch.Tensor  # () int32
    Dt: torch.Tensor  # ()
    has_sample: torch.Tensor  # () bool


class WheelPreintResult(NamedTuple):
    delta_T: torch.Tensor  # (4,4)
    sqrt_inverse_P: torch.Tensor  # (3,3) diag whitener (len, dir, yaw)
    Dt: torch.Tensor


def wheel_reset(carry_or_t_us, device="cpu", dtype=torch.float32) -> WheelCarry:
    """reset_wheel_odom_measure: zero the integral, keep the last pose.

    Accepts an existing carry (frame-boundary reset) or a scalar start time
    (fresh session on ``device``)."""
    if isinstance(carry_or_t_us, WheelCarry):
        c = carry_or_t_us
        return c._replace(
            delta_T=torch.eye(4, dtype=c.delta_T.dtype, device=c.delta_T.device),
            Dt=torch.zeros_like(c.Dt),
        )
    t = time_us(carry_or_t_us, device)
    eye4 = torch.eye(4, dtype=dtype, device=device)
    return WheelCarry(
        delta_T=eye4,
        v=torch.zeros(3, dtype=dtype, device=device),
        omega=torch.zeros(3, dtype=dtype, device=device),
        last_pose=eye4,
        last_pose_t_us=t,
        last_update_t_us=t.clone(),
        Dt=torch.zeros((), dtype=dtype, device=device),
        has_sample=torch.zeros((), dtype=torch.bool, device=device),
    )


def wheel_rebase(c: WheelCarry, shift_us) -> WheelCarry:
    return c._replace(
        last_pose_t_us=c.last_pose_t_us - shift_us,
        last_update_t_us=c.last_update_t_us - shift_us,
    )


def _ordered_product(mats):
    """mats[0] @ mats[1] @ ... (log-depth tree, order kept)."""
    while mats.shape[0] > 1:
        if mats.shape[0] % 2:
            eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
            mats = torch.cat([mats, eye[None]], 0)
        mats = geo.matmul(mats[0::2], mats[1::2])
    return mats[0]


def wheel_add_samples(c: WheelCarry, poses, t_us, mask) -> WheelCarry:
    """Feed padded absolute odometry poses (add_wheel_odom_measure each,
    wheel_odom_preintegration.h:62-97).  poses (N,4,4), t_us (N,) int32,
    mask (N,) bool.

    The 50 ms acceptance thinning is the only sequential part (each
    decision depends on the previously accepted stamp): a short loop of
    scalar tensor ops, no host sync.  The SE3 work is batched."""
    dtype, dev = c.delta_T.dtype, c.delta_T.device
    N = poses.shape[0]
    lp_t, lu_t, has = c.last_pose_t_us, c.last_update_t_us, c.has_sample
    setter = torch.full((), -1, dtype=torch.int32, device=dev)
    acc_l, prev_l, dtp_l, upd_l = [], [], [], []
    for k in range(N):
        t, m = t_us[k], mask[k]
        dt_pose = (t - lp_t).to(dtype) * US
        accept = m & has & (dt_pose >= 0.05)
        set_now = accept | (m & ~has)
        acc_l.append(accept)
        prev_l.append(setter)
        dtp_l.append(dt_pose)
        upd_l.append((t - lu_t).to(dtype) * US)
        lp_t = torch.where(set_now, t, lp_t)
        lu_t = torch.where(set_now, t, lu_t)
        setter = torch.where(set_now, k, setter)
        has = has | m
    accept = torch.stack(acc_l)
    prev_idx = torch.stack(prev_l)
    dt_pose = torch.stack(dtp_l)
    update_dt = torch.stack(upd_l)

    prev_pose = torch.where(
        (prev_idx >= 0)[:, None, None],
        poses[torch.clamp(prev_idx, 0, N - 1)],
        c.last_pose[None],
    )
    dp, dth = geo.log_SE3(geo.tf_compose(geo.tf_inv(prev_pose), poses))
    safe_dt = torch.clamp(dt_pose, min=1e-6)[:, None]
    v = dp / safe_dt
    w = dth / safe_dt
    ok = accept & (update_dt > 0.0) & (update_dt < 10.0)
    delta = geo.make_tf(v * update_dt[:, None], w * update_dt[:, None])
    eye = torch.eye(4, dtype=dtype, device=dev)
    delta = torch.where(ok[:, None, None], delta, eye)
    total = _ordered_product(delta)

    idx = torch.arange(N, dtype=torch.int32, device=dev)
    last_acc = torch.max(torch.where(accept, idx, -1))
    any_acc = last_acc >= 0
    la = torch.clamp(last_acc, 0, N - 1)
    sf = torch.clamp(setter, 0, N - 1)
    return WheelCarry(
        delta_T=geo.tf_compose(c.delta_T, total),
        v=torch.where(any_acc, _row(v, la), c.v),
        omega=torch.where(any_acc, _row(w, la), c.omega),
        last_pose=torch.where(setter >= 0, _row(poses, sf), c.last_pose),
        last_pose_t_us=lp_t,
        last_update_t_us=lu_t,
        Dt=c.Dt + torch.sum(torch.where(ok, update_dt, 0.0)),
        has_sample=has,
    )


def wheel_update_only_t(c: WheelCarry, t_us) -> WheelCarry:
    """Extend the integral to the frame stamp (update_by_v with the dt
    sanity clamp, wheel_odom_preintegration.h:141-152)."""
    t = time_us(t_us, c.Dt.device)
    dt = (t - c.last_update_t_us).to(c.delta_T.dtype) * US
    ok = (dt > 0.0) & (dt < 10.0) & c.has_sample
    delta = geo.make_tf(c.v * dt, c.omega * dt)
    return c._replace(
        delta_T=torch.where(ok, geo.tf_compose(c.delta_T, delta), c.delta_T),
        Dt=torch.where(ok, c.Dt + dt, c.Dt),
        last_update_t_us=torch.where(c.has_sample, t, c.last_update_t_us),
    )


def wheel_result(c: WheelCarry, wheel_sigma) -> WheelPreintResult:
    """get_preintegraption_result (wheel_odom_preintegration.h:111-125):
    diag([len, len, yaw] scaled) covariance -> diagonal whitener."""
    dp, dq = geo.log_SE3(c.delta_T)
    len2 = torch.clamp(torch.sum(dp * dp), min=0.005**2)
    yaw2 = torch.clamp(torch.sum(dq * dq), min=0.005**2)
    cov_diag = wheel_sigma**2 * torch.stack([len2, len2, yaw2])
    return WheelPreintResult(
        delta_T=c.delta_T,
        sqrt_inverse_P=torch.diag(1.0 / torch.sqrt(cov_diag)),
        Dt=c.Dt,
    )
