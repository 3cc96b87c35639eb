"""Transformer encoder over variable-length packed rows (the seg branch of
``graphtrans_tpu/nn/transformer.py``): post-norm layers
(attn -> add -> LN -> FF -> add -> LN), an optional input LayerNorm, a
final LayerNorm, and a learnable CLS embedding added at each graph's CLS
slot. Attention is segment-masked and runs in kernel K2 for rows of up to
384 tokens and in kernel K3 (``flash_hil_seg``) for wider rows, as
``graphtrans_tpu/nn/transformer.py:189-234`` routes them. In training mode
attention dropout runs inside K2 or K3 from one seed per layer per step, and
``ByteDropout`` acts on the attention output, the FF activation and the FF
output (``graphtrans_tpu/nn/transformer.py:470-480``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import (attention_seg, attention_seg_plain, flash_hil_seg,
                           flash_hil_seg_plain)
from ..ops.kernels.attention_packed import W_MAX
from .dropout import ByteDropout
from .init import normal_, xavier_uniform_


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's self-attention with a combined
    ``in_proj`` (q|k|v) and ``out_proj``, over packed rows."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.nhead = nhead
        self.dropout = dropout
        self.in_proj = nn.Linear(d_model, 3 * d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        self.use_kernel = True

    def init_from(self, gen):
        xavier_uniform_(self.in_proj.weight, gen)
        nn.init.zeros_(self.in_proj.bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                gen=None) -> torch.Tensor:
        """x [R, W, d], seg [R, W] -> [R, W, d]."""
        rate = self.dropout if self.training else 0.0
        seed = 0
        if rate > 0.0:
            if gen is None:
                raise ValueError("attention dropout in training mode needs "
                                 "the run's Generators")
            seed = gen.attention_seed()
        qkv = self.in_proj(x)
        if x.shape[1] > W_MAX:
            fn = flash_hil_seg if self.use_kernel else flash_hil_seg_plain
        else:
            fn = attention_seg if self.use_kernel else attention_seg_plain
        return self.out_proj(fn(qkv, seg, self.nhead, rate, seed))


class TransformerEncoderLayer(nn.Module):
    """Post-norm: x = LN1(x + drop(attn(x)));
    x = LN2(x + drop(lin2(drop(relu(lin1(x))))))."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, nhead, dropout,
                                                device=device)
        self.linear1 = nn.Linear(d_model, dim_feedforward, device=device)
        self.linear2 = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.drop = ByteDropout(dropout)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                gen=None) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x, seg, gen), gen))
        f = self.drop(torch.relu(self.linear1(x)), gen)
        return self.norm2(x + self.drop(self.linear2(f), gen))


class TransformerNodeEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int = 4,
                 dim_feedforward: int = 512, num_layers: int = 4,
                 norm_input: bool = False, dropout: float = 0.0,
                 device=None):
        super().__init__()
        self.cls_embedding = nn.Parameter(torch.zeros(d_model, device=device))
        self.norm_input = (nn.LayerNorm(d_model, eps=1e-5, device=device)
                           if norm_input else None)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                    device=device)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def init_from(self, gen):
        normal_(self.cls_embedding, 1.0, gen)

    def forward(self, dense: torch.Tensor, seg: torch.Tensor,
                cls_mask: torch.Tensor, gen=None) -> torch.Tensor:
        """dense [R, W, d] packed rows (CLS slots arrive zero), seg [R, W]
        graph id per slot (-1 = pad), cls_mask [R, W] marks CLS slots."""
        dense = dense + self.cls_embedding * cls_mask[:, :, None].to(dense.dtype)
        if self.norm_input is not None:
            dense = self.norm_input(dense)
        for layer in self.layers:
            dense = layer(dense, seg, gen)
        return self.final_norm(dense)
