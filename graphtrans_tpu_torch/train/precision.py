"""``--precision bf16``: the JAX trainer's mixed precision
(``graphtrans_tpu/trainers/base_trainer.py:make_param_cast`` and the cast
inside ``loss_fn``).

The master parameters stay float32, and so do the AdamW state, the
gradients that clipping and AdamW read, BatchNorm's running statistics
(buffers, never cast) and the loss. The forward runs on a bfloat16 copy of
every float32 parameter, fed to the model with its own buffers through
``torch.func.functional_call``; autograd through the copy gives float32
gradients on the masters. Each module rounds where its JAX counterpart
rounds (``nn/norm.py``, ``nn/dropout.py``, ``nn/conv.py``, the kernels'
plain versions): ``torch.autocast`` is not used, since it casts op by op
and keeps other ops in float32 than the JAX package does.

The bf16 step runs on the paths of slice 10's parts 1 and 2, the
GraphTrans model under ``--attn_backend auto``: molpcba (GIN with its bond
tables on the strided layout: K1 and K2) and code2 (GCN on the flat
layout: K7, K2 on rows of up to 384, K3 above). Every other path raises
NotImplementedError naming slice 10 (``later_slice``, through
``refuse_bf16`` in ``nn/conv.py``: the strided GCN and the blocked route,
part 4; ``nn/transformer.py``: the routes of K4, K5, K9 and K10, and
``models/transformer.py``: the Transformer-only model, part 3;
``nn/dropout.py``: K11)."""

from __future__ import annotations

import torch


def later_slice(what: str) -> NotImplementedError:
    """The refusal of a bf16 path that the port does not run yet."""
    return NotImplementedError(f"{what} in bf16 arrives with slice 10")


def refuse_bf16(t: torch.Tensor, what: str):
    """Raise ``later_slice(what)`` where ``t`` is bf16: the path does not
    run in bf16 yet."""
    if t.dtype == torch.bfloat16:
        raise later_slice(what)


def cast_params(model: torch.nn.Module, dtype: torch.dtype) -> dict:
    """``make_param_cast``: a copy in ``dtype`` of every float32 parameter
    of ``model`` by name, differentiable (the copy's gradient reaches the
    master in float32), with the module's buffers as they are (BatchNorm's
    running statistics stay float32 and are updated in place)."""
    out = {n: p.to(dtype) if p.dtype == torch.float32 else p
           for n, p in model.named_parameters()}
    out.update(model.named_buffers())
    return out
