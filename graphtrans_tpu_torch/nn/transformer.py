"""Transformer encoder over variable-length packed rows (the seg branch of
``graphtrans_tpu/nn/transformer.py``): post-norm layers
(attn -> add -> LN -> FF -> add -> LN), an optional input LayerNorm, a
final LayerNorm, and a learnable CLS embedding added at each graph's CLS
slot. Attention is segment-masked and runs in kernel K2."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import attention_seg, attention_seg_plain
from ..ops.kernels.attention_packed import W_MAX
from .init import normal_, xavier_uniform_


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's self-attention with a combined
    ``in_proj`` (q|k|v) and ``out_proj``, over packed rows."""

    def __init__(self, d_model: int, nhead: int, device=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.nhead = nhead
        self.in_proj = nn.Linear(d_model, 3 * d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        self.use_kernel = True

    def init_from(self, gen):
        xavier_uniform_(self.in_proj.weight, gen)
        nn.init.zeros_(self.in_proj.bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """x [R, W, d], seg [R, W] -> [R, W, d]."""
        if x.shape[1] > W_MAX:
            raise NotImplementedError(
                f"packed rows wider than {W_MAX} need flash_hil_seg_qkv (K3), "
                "which arrives with slice 3 (code2)")
        qkv = self.in_proj(x)
        fn = attention_seg if self.use_kernel else attention_seg_plain
        return self.out_proj(fn(qkv, seg, self.nhead))


class TransformerEncoderLayer(nn.Module):
    """Post-norm: x = LN1(x + attn(x)); x = LN2(x + lin2(relu(lin1(x))))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 device=None):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead, device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x, seg))
        return self.norm2(x + self.linear2(torch.relu(self.linear1(x))))


class TransformerNodeEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 512, num_layers: int = 4,
                 norm_input: bool = False, device=None):
        super().__init__()
        self.cls_embedding = nn.Parameter(torch.zeros(d_model, device=device))
        self.norm_input = (nn.LayerNorm(d_model, eps=1e-5, device=device)
                           if norm_input else None)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward,
                                    device=device)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def init_from(self, gen):
        normal_(self.cls_embedding, 1.0, gen)

    def forward(self, dense: torch.Tensor, seg: torch.Tensor,
                cls_mask: torch.Tensor) -> torch.Tensor:
        """dense [R, W, d] packed rows (CLS slots arrive zero), seg [R, W]
        graph id per slot (-1 = pad), cls_mask [R, W] marks CLS slots."""
        dense = dense + self.cls_embedding * cls_mask[:, :, None].to(dense.dtype)
        if self.norm_input is not None:
            dense = self.norm_input(dense)
        for layer in self.layers:
            dense = layer(dense, seg)
        return self.final_norm(dense)
