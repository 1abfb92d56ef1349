"""repro_torch.kernels — hand-written Hopper kernels for the hot spots.

Each subpackage keeps the JAX package's layout: ``ref.py`` (the plain
PyTorch version, which runs on any device), ``kernel.py`` (the CUDA
kernel's build, binding and launch wrapper) with its sources under
``csrc/``, and ``ops.py`` (dispatch by the device of the tensors: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises).

  swarm/  masked rarest-argmin + max-min water-filling (the fleet tick)
"""
