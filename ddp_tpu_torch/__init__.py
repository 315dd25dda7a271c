"""ddp_tpu_torch — the PyTorch/CUDA port of ``ddp_tpu`` for one NVIDIA H100.

It imports ``torch``, numpy and the standard library, never ``jax`` and never
``ddp_tpu``.  Public layouts match ``ddp_tpu``: uint8 NHWC images, and
parameters that convert from its HWIO / ``[in, out]`` layouts
(:mod:`ddp_tpu_torch.interop`).  Entry points run on ``cuda`` unless the
caller asks for the CPU.
"""
