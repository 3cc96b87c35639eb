"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built at first use by ``_build``) or
raises, and counts the launch in its ``launches`` attribute. The forward
wrappers are ``torch.autograd.Function``s on CUDA tensors whose backward
is the matching ``*_bwd`` kernel wrapper (K11's backward is its own kernel
on the cotangent, counted as ``byte_dropout``; K10's forward and backward
are chains of launches, counted once a chain; K8's backward is two
kernels, d_emb and dx, each counted by its own wrapper; K12 has no
gradient)."""

from __future__ import annotations

from torch import nn

from .attention_packed import (attention_dense, attention_dense_bwd,
                               attention_dense_bwd_plain,
                               attention_dense_plain, attention_seg,
                               attention_seg_bwd, attention_seg_bwd_plain,
                               attention_seg_plain)
from .attention_smalls import (attention_smalls, attention_smalls_bwd,
                               attention_smalls_bwd_plain,
                               attention_smalls_plain)
from .block_spmm import (SlotOrder, blocked_gather_message_scatter,
                         blocked_gather_message_scatter_bwd_plain,
                         blocked_gather_message_scatter_demb,
                         blocked_gather_message_scatter_demb_plain,
                         blocked_gather_message_scatter_dx,
                         blocked_gather_message_scatter_dx_plain,
                         blocked_gather_message_scatter_plain, slot_order,
                         src_slot_order)
from .dense_agg import (dense_agg, dense_agg_bwd, dense_agg_bwd_plain,
                        dense_agg_plain)
from .dropout import byte_dropout, byte_dropout_plain
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_plain, key_padding_segs)
from .flash_hil import (flash_hil_seg, flash_hil_seg_bwd,
                        flash_hil_seg_bwd_plain, flash_hil_seg_plain)
from .gin_agg import gin_agg, gin_agg_bwd, gin_agg_bwd_plain, gin_agg_plain
from .scatter_mxu import segment_sum_mxu, segment_sum_mxu_plain
from .spmm import (DstOrder, SrcOrder, dst_order, spmm, spmm_bwd,
                   spmm_bwd_plain, spmm_plain, src_order)
from .transformer_layer import (transformer_layer, transformer_layer_bwd,
                                transformer_layer_bwd_plain,
                                transformer_layer_plain)

WRAPPERS = (gin_agg, gin_agg_bwd, attention_seg, attention_seg_bwd,
            flash_hil_seg, flash_hil_seg_bwd, spmm, spmm_bwd,
            attention_dense, attention_dense_bwd, flash_attention,
            flash_attention_bwd, byte_dropout, attention_smalls,
            attention_smalls_bwd, transformer_layer, transformer_layer_bwd,
            dense_agg, dense_agg_bwd, blocked_gather_message_scatter,
            blocked_gather_message_scatter_demb,
            blocked_gather_message_scatter_dx, segment_sum_mxu)


def reset_launches():
    for fn in WRAPPERS:
        fn.launches = 0
        for name in getattr(fn, "instances", ()):
            fn.instances[name] = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def set_kernels(model: nn.Module, enabled: bool) -> nn.Module:
    """Route every kernel call of ``model`` through the wrappers (True, the
    default) or through the plain versions on any device (False: the
    reference a check on the card compares the kernels with)."""
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = enabled
    return model


__all__ = ["attention_dense", "attention_dense_bwd",
           "attention_dense_bwd_plain", "attention_dense_plain",
           "attention_seg", "attention_seg_bwd", "attention_seg_bwd_plain",
           "attention_seg_plain", "attention_smalls", "attention_smalls_bwd",
           "attention_smalls_bwd_plain", "attention_smalls_plain",
           "blocked_gather_message_scatter",
           "blocked_gather_message_scatter_bwd_plain",
           "blocked_gather_message_scatter_demb",
           "blocked_gather_message_scatter_demb_plain",
           "blocked_gather_message_scatter_dx",
           "blocked_gather_message_scatter_dx_plain",
           "blocked_gather_message_scatter_plain",
           "byte_dropout", "byte_dropout_plain", "dense_agg",
           "dense_agg_bwd", "dense_agg_bwd_plain", "dense_agg_plain",
           "dst_order", "DstOrder",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_hil_seg", "flash_hil_seg_bwd", "flash_hil_seg_bwd_plain",
           "flash_hil_seg_plain", "gin_agg", "gin_agg_bwd",
           "gin_agg_bwd_plain", "gin_agg_plain", "key_padding_segs",
           "launch_counts", "reset_launches", "segment_sum_mxu",
           "segment_sum_mxu_plain", "set_kernels", "slot_order", "SlotOrder",
           "spmm",
           "spmm_bwd", "spmm_bwd_plain", "spmm_plain", "src_order",
           "src_slot_order",
           "SrcOrder", "transformer_layer", "transformer_layer_bwd",
           "transformer_layer_bwd_plain", "transformer_layer_plain",
           "WRAPPERS"]
