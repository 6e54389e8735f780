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

from liwslam_torch.config import Params
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
