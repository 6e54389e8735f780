"""The benchmark's plain reference of the port's laser front end.

Plain PyTorch, run on the CPU after a run's measured window: a frozen copy
of the port's plain modules (geometry, preintegration, line extraction,
matching, factors, the LM solves, the tracking step, the init window),
with library matrix products where the port keeps batch-invariant forms
and no kernel, operator or batching.  It imports neither JAX, nor the JAX
package, nor anything of ``liwslam_torch``."""
