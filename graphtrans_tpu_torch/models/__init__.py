"""The port's models by ``model_type`` (``graphtrans_tpu/models/__init__.py``
lists the JAX package's): "gnn-transformer" (GraphTrans) and "transformer"
(the Transformer-only ablation)."""

from __future__ import annotations

from .gnn_transformer import build_gnn_transformer
from .transformer import build_transformer


def build_model(args, num_tasks: int, device=None, data=None):
    """The model of a parsed config (``utils/config.py``); ``data`` (a
    ``data.code.CodeData`` or ``data.tu.TUData``) sizes code2's node
    encoder and heads or TU's node encoder. A composition outside the
    ported slices raises NotImplementedError."""
    if getattr(args, "model_type", "gnn-transformer") == "transformer":
        return build_transformer(args, num_tasks, device, data)
    return build_gnn_transformer(args, num_tasks, device, data)
