"""liwslam_torch — the PyTorch/CUDA port of liwslam for one NVIDIA H100.

A second package beside ``liwslam`` (the JAX reference, which stays as it
is).  The port imports ``torch`` and numpy, never JAX and nothing of
``liwslam``; where it needs a numpy-only module of the reference it keeps
its own copy (``config``, ``sim.world``, ``eval.metrics``, ``eval.occupancy``,
``eval.debug_viz``, ``io.dispatch``, ``io.tum``, ``io.openloris``,
``io.rosbag``, ``utils.record``, ``utils.asyncwriter``).

Numeric rules carried over from the reference: float32 throughout, no TF32
anywhere (set below: rotation algebra and the Gauss-Newton normal
equations need true f32 products), int32 microsecond timestamps on a
rolling origin, and ``core.geometry.safe_norm`` wherever a norm is
differentiated.

Entry points (``frontend.driver.Frontend``, ``frontend.pipeline.
tracking_step``, ``parallel.multiseq.batched_chunk_fn`` on a Frontend's
constants, the kernel wrappers in ``ops``, ``backend.manager.
KeyframeManager``, ``online.OnlineRunner``, ``utils.checkpoint.
load_manager``, ``python -m liwslam_torch.run``) run on the card by default
(``device="cuda"``) and on the CPU only when the caller asks.
"""

import torch

__version__ = "0.1.0"

# float32 matmuls and convolutions in full float32 (TF32 keeps ~3 decimal
# digits, which breaks 3x3 rotation algebra and the LM normal equations)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; raises when CUDA is asked for and missing (no fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "liwslam_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
