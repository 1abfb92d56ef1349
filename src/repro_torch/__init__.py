"""repro_torch — the PyTorch and CUDA port of :mod:`repro`.

The same paper system (the Academic Torrents distribution fabric,
simulated), with its device work running as hand-written CUDA kernels for
Hopper (``sm_90a``) instead of Pallas kernels for a TPU. The JAX package
stays the reference; this package imports neither it nor JAX. Ported so
far: the framework-free core and the collective fabric
(:mod:`repro_torch.core`), all six kernels (:mod:`repro_torch.kernels`:
swarm, checksum, flash attention, chunked SSD, RG-LRU scan), the data
ingest modules (:mod:`repro_torch.data`), the checkpoint broadcast
walkthrough (:mod:`repro_torch.examples.checkpoint_broadcast`), and the
serving path: :mod:`repro_torch.configs`, the dense, Mamba-2 and
RecurrentGemma models (:mod:`repro_torch.models`), :mod:`repro_torch.serve`
and ``python -m repro_torch.launch.serve``; and the training path:
:mod:`repro_torch.train` (optimizer, train step, Trainer, checkpoints in
the JAX package's format, fault tolerance) and ``python -m
repro_torch.launch.train``, with the flash-attention backward as a CUDA
kernel of its own.

Device rule: entry points that run on a device take ``device=None``,
which means CUDA and raises when CUDA is missing; ``device="cpu"`` runs
each kernel's plain PyTorch version instead (the CPU tests do this).
"""
