"""Carry parameters and state across from the JAX reference package.

Takes plain Python / numpy values (a ``dataclasses.asdict`` of the
reference ``Params``; nested NamedTuples or dicts of numpy arrays for
state) and builds the port's objects, so both packages compute the same
thing from the same inputs.  Imports nothing of the reference package: the
caller does the ``np.asarray`` on the JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

from liwslam_torch.camera import features as ft
from liwslam_torch.config import Params
from liwslam_torch.frontend import camera_pipeline as cpl
from liwslam_torch.frontend import matching as mm
from liwslam_torch.frontend import pipeline as pl
from liwslam_torch.frontend import preintegration as pre
from liwslam_torch.solve import factors as fac

# NamedTuple fields that are themselves NamedTuples
_NESTED = {
    pl.TrackState: {
        "win": fac.WindowState,
        "imu": pre.ImuCarry,
        "wheel": pre.WheelCarry,
        "pair": mm.SubmapPair,
    },
    mm.SubmapPair: {"ref": mm.RefSubmap, "spawning": mm.RefSubmap},
    cpl.CamTrackState: {"fw": ft.FeatureWindow},
}


def params_from_reference(d: dict) -> Params:
    """The port's Params from ``dataclasses.asdict`` of a reference Params
    (unknown keys are ignored; lists become tuples)."""
    return Params.from_dict(d)


def _fields(tree):
    return tree._asdict() if hasattr(tree, "_asdict") else dict(tree)


def _build(cls, tree, device):
    src = _fields(tree)
    nested = _NESTED.get(cls, {})
    kw = {}
    for name in cls._fields:
        v = src[name]
        if name in nested:
            kw[name] = _build(nested[name], v, device)
        else:
            kw[name] = torch.as_tensor(np.array(v)).to(device)  # dtype kept
    return cls(**kw)


def track_state_from_numpy(tree, device) -> pl.TrackState:
    """TrackState from a nested NamedTuple / dict of numpy arrays; int32
    timestamps and bool masks keep their dtypes."""
    return _build(pl.TrackState, tree, device)


def frame_input_from_numpy(tree, device) -> pl.FrameInput:
    """FrameInput from a NamedTuple / dict of numpy arrays."""
    return _build(pl.FrameInput, tree, device)


def cam_state_from_numpy(tree, device) -> cpl.CamTrackState:
    """CamTrackState (with its FeatureWindow) from a nested NamedTuple / dict
    of numpy arrays."""
    return _build(cpl.CamTrackState, tree, device)


def frame_input_cam_from_numpy(tree, device) -> cpl.FrameInputCam:
    """The port's FrameInputCam from the reference package's (numpy leaves:
    base, cam_img, cam_t_us, cam_valid, cam_extra_imgs (NE,H,W),
    cam_extra_mask (NE,)).  The branch flags stay on the host."""
    src = _fields(tree)
    mask = np.asarray(src["cam_extra_mask"], bool)
    extra = np.asarray(src["cam_extra_imgs"], np.float32)
    dev_img = lambda a: torch.as_tensor(np.array(a, np.float32)).to(device)
    return cpl.FrameInputCam(
        base=frame_input_from_numpy(src["base"], device),
        cam_img=dev_img(src["cam_img"]),
        cam_t_us=torch.as_tensor(np.int32(src["cam_t_us"])).to(device),
        cam_valid=bool(src["cam_valid"]),
        cam_extra_imgs=tuple(dev_img(extra[j]) for j in np.flatnonzero(mask)),
        cam_extra_mask=mask,
    )
