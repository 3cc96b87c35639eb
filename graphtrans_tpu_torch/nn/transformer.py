"""Transformer encoder (``graphtrans_tpu/nn/transformer.py``): post-norm
layers (attn -> add -> LN -> FF -> add -> LN), an optional input LayerNorm,
a final LayerNorm and a learnable CLS embedding, over one of two layouts.

Packed rows (``seg`` given, the GraphTrans path): variable-length rows of
several graphs, attention segment-masked, in kernel K2 for rows of up to
384 tokens and in K3 (``flash_hil_seg``) for wider rows, as
``graphtrans_tpu/nn/transformer.py:189-234`` routes them; the CLS embedding
is added at each graph's CLS slot. In training mode attention dropout runs
inside K2 or K3 from one seed per layer per step, and ``ByteDropout`` acts
on the attention output, the FF activation and the FF output
(``graphtrans_tpu/nn/transformer.py:470-480``).

Unpacked rows (``valid`` given, the Transformer-only model): a dense
``[B, S, d]`` batch, one graph a row, with a key-padding mask; a CLS column
is appended (``:537-541``). Rows of S tokens with ``128 // S >= 2`` are
packed ``gb`` graphs to a row with block-diagonal attention (``:546-575``),
and each attention call takes the route the JAX package takes on a TPU
(``dense_route``): K4 (``attention_dense``), K5 (``flash_attention``) or the
plain masked softmax, which the JAX package leaves to XLA. In training mode
attention dropout runs inside K4 or K5 from one seed per layer per step;
on the plain route it is ``ByteDropout`` on the probabilities, as the JAX
package drops ``att`` (``:376``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import (attention_dense, attention_dense_plain,
                           attention_seg, attention_seg_plain,
                           flash_attention, flash_attention_plain,
                           flash_hil_seg, flash_hil_seg_plain,
                           key_padding_segs)
from ..ops.kernels.attention_packed import W_MAX
from .dropout import ByteDropout
from .init import normal_, xavier_uniform_

CHUNK_THRESHOLD = 512   # graphtrans_tpu/nn/transformer.py:_CHUNK_THRESHOLD
PACK_WIDTH = 128        # graph-packed rows hold up to 128 tokens


def graphs_per_row(S: int) -> int:
    """How many graphs of S tokens (CLS included) share a packed row."""
    return max(1, PACK_WIDTH // S)


def dense_route(S: int, d: int, block: int = 0) -> str:
    """The JAX package's TPU route for attention over unpacked rows of S
    tokens and width d (``graphtrans_tpu/nn/transformer.py:270-304``):
    "k4" (``attention_dense``), "k5" (``flash_attention``) or "plain" (the
    masked softmax in PyTorch)."""
    if block > 0:
        return "k4" if d % 128 == 0 and S <= W_MAX else "plain"
    if S >= CHUNK_THRESHOLD:
        return "k5"
    if d % 128 == 0 and 128 < S <= W_MAX:
        return "k4"
    return "plain"


class MultiheadSelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's self-attention with a combined
    ``in_proj`` (q|k|v) and ``out_proj``, over packed or unpacked rows."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0,
                 device=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.nhead = nhead
        self.dropout = dropout
        self.in_proj = nn.Linear(d_model, 3 * d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)
        self.attn_drop = ByteDropout(dropout)     # the plain unpacked route
        self.use_kernel = True

    def init_from(self, gen):
        xavier_uniform_(self.in_proj.weight, gen)
        nn.init.zeros_(self.in_proj.bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, seg=None, gen=None, valid=None,
                block: int = 0) -> torch.Tensor:
        """x [R, W, d] -> [R, W, d]: packed rows with seg [R, W], or
        unpacked rows with the key mask valid (bool [R, W]; on K5's route
        its ``key_padding_segs``) and ``block`` > 0 for graph blocks of
        that width."""
        rate = self.dropout if self.training else 0.0
        if seg is None:
            return self.out_proj(self._unpacked(self.in_proj(x), valid,
                                                block, rate, gen))
        seed = self._seed(rate, gen)
        qkv = self.in_proj(x)
        if x.shape[1] > W_MAX:
            fn = flash_hil_seg if self.use_kernel else flash_hil_seg_plain
        else:
            fn = attention_seg if self.use_kernel else attention_seg_plain
        return self.out_proj(fn(qkv, seg, self.nhead, rate, seed))

    @staticmethod
    def _seed(rate, gen) -> int:
        """The kernel's dropout seed for this layer and step (0 at rate 0)."""
        if rate == 0.0:
            return 0
        if gen is None:
            raise ValueError("attention dropout in training mode needs the "
                             "run's Generators")
        return gen.kernel_seed()

    def _unpacked(self, qkv, valid, block, rate, gen):
        route = dense_route(qkv.shape[1], qkv.shape[2] // 3, block)
        if route == "k5":
            fn = flash_attention if self.use_kernel else flash_attention_plain
            return fn(qkv, *valid, self.nhead, rate, self._seed(rate, gen))
        if route == "k4":
            fn = attention_dense if self.use_kernel else attention_dense_plain
            return fn(qkv, valid, self.nhead, block, rate,
                      self._seed(rate, gen))
        drop = (lambda p: self.attn_drop(p, gen)) if rate > 0.0 else None
        return attention_dense_plain(qkv, valid, self.nhead, block, drop=drop)


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

    def forward(self, x: torch.Tensor, seg=None, gen=None, valid=None,
                block: int = 0) -> torch.Tensor:
        a = self.self_attn(x, seg, gen, valid, block)
        x = self.norm1(x + self.drop(a, gen))
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

    def forward(self, dense: torch.Tensor, valid=None, seg=None,
                cls_mask=None, gen=None) -> torch.Tensor:
        """Packed rows: dense [R, W, d] (CLS slots arrive zero), seg [R, W]
        graph id per slot (-1 = pad), cls_mask [R, W] marks CLS slots ->
        [R, W, d]. Unpacked rows: dense [B, S, d], valid [B, S] -> [B, S+1,
        d], the CLS column last."""
        if seg is None:
            return self._unpacked(dense, valid, gen)
        dense = dense + self.cls_embedding * cls_mask[:, :, None].to(dense.dtype)
        if self.norm_input is not None:
            dense = self.norm_input(dense)
        for layer in self.layers:
            dense = layer(dense, seg, gen)
        return self.final_norm(dense)

    def _unpacked(self, dense, valid, gen):
        B, _, d = dense.shape
        cls = self.cls_embedding.to(dense.dtype).expand(B, 1, d)
        dense = torch.cat([dense, cls], dim=1)
        valid = torch.cat([valid, valid.new_ones(B, 1)], dim=1)
        if self.norm_input is not None:
            dense = self.norm_input(dense)
        S = dense.shape[1]
        gb = graphs_per_row(S)
        block = 0
        if gb > 1:
            pad = -B % gb
            dense = torch.cat([dense, dense.new_zeros(pad, S, d)])
            valid = torch.cat([valid, valid.new_zeros(pad, S)])
            dense = dense.reshape(-1, gb * S, d)
            valid = valid.reshape(-1, gb * S)
            block = S
        if dense_route(dense.shape[1], d, block) == "k5":
            valid = key_padding_segs(valid)    # K5's form, once for all layers
        for layer in self.layers:
            dense = layer(dense, gen=gen, valid=valid, block=block)
        dense = self.final_norm(dense)
        return dense.reshape(-1, S, d)[:B] if gb > 1 else dense
