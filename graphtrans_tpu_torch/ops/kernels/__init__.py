"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built at first use by ``_build``) or
raises, and counts the launch in its ``launches`` attribute."""

from __future__ import annotations

from torch import nn

from .attention_packed import attention_seg, attention_seg_plain
from .gin_agg import gin_agg, gin_agg_plain

WRAPPERS = (gin_agg, attention_seg)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0


def set_kernels(model: nn.Module, enabled: bool) -> nn.Module:
    """Route every kernel call of ``model`` through the wrappers (True, the
    default) or through the plain versions on any device (False: the
    reference a check on the card compares the kernels with)."""
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = enabled
    return model


__all__ = ["attention_seg", "attention_seg_plain", "gin_agg", "gin_agg_plain",
           "reset_launches", "set_kernels", "WRAPPERS"]
