"""The configuration as the reference reads it: the ``params`` object of a
configuration file (``benchmark/configs/<name>.json``), every field named
as the reference YAML keys are, with the derived values the step needs."""

from __future__ import annotations

import math

import numpy as np


class RefParams:
    """Read-only view of a configuration's ``params``: attribute access to
    every key, lists as tuples."""

    def __init__(self, params: dict):
        self._p = {k: tuple(v) if isinstance(v, list) else v for k, v in params.items()}

    def __getattr__(self, name):
        try:
            return self.__dict__["_p"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def min_delta_t(self) -> float:
        return 1.0 / self.FPS

    @property
    def line_max_tolerance_angle_rad(self) -> float:
        return math.radians(self.line_max_tolerance_angle)

    def mat_T_imu_to_wheel(self) -> np.ndarray:
        return np.asarray(self.T_imu_to_wheel, np.float64).reshape(4, 4)

    def mat_T_imu_to_laser(self) -> np.ndarray:
        return np.asarray(self.T_imu_to_laser, np.float64).reshape(4, 4)
