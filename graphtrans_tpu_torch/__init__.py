"""PyTorch/CUDA port of graphtrans_tpu for NVIDIA Hopper.

The JAX package ``graphtrans_tpu`` is the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of the numpy host code.
Slice 1 covers the molpcba GraphTrans serving forward: strided-layout GIN
with a virtual node, a packed-row transformer stage with CLS readout, and
two hand-written CUDA kernels (``ops/kernels``). Importing the package never
compiles anything; kernels build on first use with a CUDA tensor.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU: a
    CUDA request on a machine without CUDA raises instead of falling back."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU")
    return dev
