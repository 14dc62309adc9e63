"""PyTorch + CUDA port of ``transformer_transducer_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; every module here mirrors
its counterpart at the same relative path.  This package imports no JAX and
nothing of the JAX package.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see :func:`utils.device.resolve_device`).
"""
