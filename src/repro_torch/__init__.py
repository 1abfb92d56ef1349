"""repro_torch — the PyTorch and CUDA port of :mod:`repro`.

The same paper system (the Academic Torrents distribution fabric,
simulated), with the fleet engine's device tick running as hand-written
CUDA kernels for Hopper (``sm_90a``) instead of Pallas kernels for a TPU.
The JAX package stays the reference; this package imports neither it nor
JAX. Ported so far: the framework-free core (:mod:`repro_torch.core`) and
the swarm kernels (:mod:`repro_torch.kernels.swarm`).

Device rule: entry points that run on a device take ``device=None``,
which means CUDA and raises when CUDA is missing; ``device="cpu"`` runs
each kernel's plain PyTorch version instead (the CPU tests do this).
"""
