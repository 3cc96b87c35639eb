"""Transformer encoder (``graphtrans_tpu/nn/transformer.py``): post-norm
layers (attn -> add -> LN -> FF -> add -> LN), an optional input LayerNorm,
a final LayerNorm and a learnable CLS embedding, over one of two layouts,
each attention call on the route the JAX package takes on a TPU under the
model's attention backend (``set_attn_backend``, ``attention_route``).

Packed rows (``seg`` given, the GraphTrans path): variable-length rows of
several graphs, attention segment-masked (K2, K3, K5's segment form or the
plain masked softmax); the CLS embedding is added at each graph's CLS slot.
In training mode attention dropout runs inside the kernels from one seed
per layer per step, and ``ByteDropout`` acts on the attention output, the
FF activation and the FF output (``graphtrans_tpu/nn/transformer.py:
470-480``).

Unpacked rows (``valid`` given, the Transformer-only model): a dense
``[B, S, d]`` batch, one graph a row, with a key-padding mask; a CLS column
is appended (``:537-541``). Under the packing backends rows of S tokens
with ``128 // S >= 2`` are packed ``gb`` graphs to a row with
block-diagonal attention (``:546-575``); attention takes K4, K5, K9 or the
plain masked softmax, and under ``packed_layer`` the whole layer is K10
(``transformer_layer``, ``:449-451``). In training mode attention dropout
runs inside the kernels from one seed per layer per step; on the plain
route it is ``ByteDropout`` on the probabilities, as the JAX package drops
``att`` (``:376``), and under ``chunked`` an exact-probability Bernoulli
mask (``:74-78``), drawn from the run's device generator.

In bf16 (the bf16 step) attention runs under the backend auto: packed
rows on K2's and K3's bf16 instances, unpacked rows (the Transformer-only
model) on K4's and K5's, at heads of 64 for K4 and K5, or on the plain
route, which rounds as the JAX package's XLA route does (scores and
softmax in float32, the probabilities rounded to bf16 before
``ByteDropout`` and the product with V in bf16). LayerNorm takes its
statistics in float32 and rounds its output once, as flax's does. The
routes of K9 and K10 (and ``chunked``) raise NotImplementedError naming
slice 10."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import (attention_dense, attention_dense_plain,
                           attention_seg, attention_seg_plain,
                           attention_smalls, attention_smalls_plain,
                           flash_attention, flash_attention_plain,
                           flash_hil_seg, flash_hil_seg_plain,
                           key_padding_segs, transformer_layer,
                           transformer_layer_plain)
from ..ops.kernels.attention_packed import keep_drop
from ..train.precision import refuse_bf16
from .dropout import ByteDropout
from .init import normal_, xavier_uniform_

CHUNK_THRESHOLD = 512   # graphtrans_tpu/nn/transformer.py:_CHUNK_THRESHOLD
PACK_WIDTH = 128        # graph-packed rows hold up to 128 tokens
# set_attn_backend's names (graphtrans_tpu/nn/transformer.py:135-137); the
# root main.py's --attn_backend takes the first seven
BACKENDS = ("auto", "flash", "smalls", "chunked", "dense", "packed",
            "packed_smalls", "packed_fused", "packed_layer")
CLI_BACKENDS = BACKENDS[:7]
PACKING = ("auto", "packed", "packed_smalls", "packed_fused", "packed_layer")
# the routes that run in bf16 (K5 on unpacked rows only)
BF16_ROUTES = ("k2", "k3", "k4", "k5", "plain")


def graphs_per_row(S: int, backend: str = "auto") -> int:
    """How many graphs of S tokens (CLS included) share a packed row under
    ``backend`` (``graphtrans_tpu/nn/transformer.py:551-565``)."""
    return max(1, PACK_WIDTH // S) if backend in PACKING else 1


def attention_route(backend: str, S: int, d: int, block: int = 0,
                    seg: bool = False) -> str:
    """The JAX package's TPU branch for rows of S tokens and width d under
    ``backend`` (``graphtrans_tpu/nn/transformer.py:189-304``, ``:449-451``):
    "k10" (the whole layer in ``transformer_layer``), "k2"
    (``attention_seg``), "k3" (``flash_hil_seg``), "k4"
    (``attention_dense``), "k5" (``flash_attention``, with ``seg`` its
    segment form), "k9" (``attention_smalls``), "chunked" or "plain" (the
    masked softmax in PyTorch). ``block`` > 0: graph-packed rows of graphs
    of ``block`` tokens; ``seg``: GraphTrans's variable-length rows."""
    lanes = d % 128 == 0
    if seg:
        if backend in ("auto", "packed_fused") and lanes and S <= 384:
            return "k2"
        if backend in ("auto", "flash") and lanes and S > 384:
            return "k3"
        if backend in ("auto", "flash") and S >= 256:
            return "k5"
        return "plain"
    if block > 0:
        if backend == "packed_layer" and lanes and S <= PACK_WIDTH:
            return "k10"
        if backend == "packed_smalls":
            return "k9"
        if backend in ("auto", "packed_fused") and lanes and S <= 384:
            return "k4"
        return "plain"
    if backend == "auto":
        if S >= CHUNK_THRESHOLD:
            return "k5"
        return "k4" if lanes and 128 < S <= 384 else "plain"
    return {"smalls": "k9", "flash": "k5", "chunked": "chunked"}.get(backend,
                                                                     "plain")


def kernel_seed(rate: float, gen) -> int:
    """A kernel's dropout seed for this layer and step (0 at rate 0)."""
    if rate == 0.0:
        return 0
    if gen is None:
        raise ValueError("dropout in training mode needs the run's "
                         "Generators")
    return gen.kernel_seed()


def set_attn_backend(model: nn.Module, name: str) -> nn.Module:
    """Route the attention of every encoder in ``model`` by ``name`` (one of
    ``BACKENDS``; "auto" is the default), as the JAX package's
    process-wide ``set_attn_backend`` does, but for this model alone."""
    if name not in BACKENDS:
        raise ValueError(f"attention backend {name!r} is not one of "
                         f"{BACKENDS}")
    for m in model.modules():
        if isinstance(m, TransformerNodeEncoder):
            m.attn_backend = name
    return model


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
        self.attn_drop = ByteDropout(dropout)     # the plain route
        self.use_kernel = True

    def init_from(self, gen):
        xavier_uniform_(self.in_proj.weight, gen)
        nn.init.zeros_(self.in_proj.bias)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, route: str, seg=None, gen=None,
                valid=None, block: int = 0) -> torch.Tensor:
        """x [R, W, d] -> [R, W, d] on ``route`` (``attention_route``):
        packed rows with seg [R, W], or unpacked rows with the key mask
        valid (bool [R, W]; on K5's route its ``key_padding_segs``) and
        ``block`` > 0 for graph blocks of that width."""
        rate = self.dropout if self.training else 0.0
        qkv = self.in_proj(x)
        kernel = self.use_kernel
        if route not in BF16_ROUTES or (route == "k5" and seg is not None):
            # K5 on packed rows is the flash backend's (part 3b)
            refuse_bf16(qkv, f"attention route {route}")
        if route in ("k2", "k3"):
            fn = {"k2": (attention_seg, attention_seg_plain),
                  "k3": (flash_hil_seg, flash_hil_seg_plain)}[route][
                      not kernel]
            y = fn(qkv, seg, self.nhead, rate, kernel_seed(rate, gen))
        elif route == "k5":
            fn = flash_attention if kernel else flash_attention_plain
            segs = (seg, seg) if seg is not None else valid
            y = fn(qkv, *segs, self.nhead, rate, kernel_seed(rate, gen))
        elif route in ("k4", "k9"):
            fn = {"k4": (attention_dense, attention_dense_plain),
                  "k9": (attention_smalls, attention_smalls_plain)}[route][
                      not kernel]
            y = fn(qkv, valid, self.nhead, block, rate,
                   kernel_seed(rate, gen))
        else:
            y = self._plain(qkv, route, seg, valid, block, rate, gen)
        return self.out_proj(y)

    def _plain(self, qkv, route, seg, valid, block, rate, gen):
        """The masked softmax in PyTorch: ByteDropout on the probabilities,
        or under ``chunked`` an exact-probability Bernoulli mask. In bf16
        (packed and unpacked rows, the JAX package's XLA route,
        ``graphtrans_tpu/nn/transformer.py:364-376``) the scores and
        softmax are float32 and the probabilities are rounded to bf16
        before the dropout and the product (``attention_seg_plain`` and
        ``attention_dense_plain`` with ``kernel`` False)."""
        drop = None
        if rate > 0.0 and route == "chunked":
            if gen is None:
                raise ValueError("dropout in training mode needs the run's "
                                 "Generators")
            drop = lambda p: keep_drop(torch.rand(
                p.shape, generator=gen.device, device=p.device)
                < 1.0 - rate, rate)(p)
        elif rate > 0.0:
            drop = lambda p: self.attn_drop(p, gen)
        if seg is not None:
            return attention_seg_plain(qkv, seg, self.nhead, drop=drop,
                                       kernel=False)
        return attention_dense_plain(qkv, valid, self.nhead, block, drop=drop,
                                     kernel=False)


class TransformerEncoderLayer(nn.Module):
    """Post-norm: x = LN1(x + drop(attn(x)));
    x = LN2(x + drop(lin2(drop(relu(lin1(x)))))). On route "k10" the whole
    layer is K10 over the same parameters (``transformer_layer``; the JAX
    package's fused layer keeps the unfused variable tree, so the weights
    convert alike)."""

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
        self.use_kernel = True

    def forward(self, x: torch.Tensor, route: str, seg=None, gen=None,
                valid=None, block: int = 0) -> torch.Tensor:
        if route == "k10":
            refuse_bf16(x, "attention route k10")
            return self._fused(x, valid, block, gen)
        a = self.self_attn(x, route, seg, gen, valid, block)
        x = self.norm1(x + self.drop(a, gen))
        f = self.drop(torch.relu(self.linear1(x)), gen)
        return self.norm2(x + self.drop(self.linear2(f), gen))

    def fused_params(self) -> tuple:
        """The layer's twelve parameters in K10's order (its
        ``PARAM_NAMES``)."""
        attn = self.self_attn
        return (attn.in_proj.weight, attn.in_proj.bias, attn.out_proj.weight,
                attn.out_proj.bias, self.norm1.weight, self.norm1.bias,
                self.linear1.weight, self.linear1.bias, self.linear2.weight,
                self.linear2.bias, self.norm2.weight, self.norm2.bias)

    def _fused(self, x, valid, block, gen):
        attn = self.self_attn
        rate = attn.dropout if self.training else 0.0
        fn = transformer_layer if self.use_kernel else transformer_layer_plain
        return fn(x, valid, self.fused_params(), attn.nhead, block, rate,
                  kernel_seed(rate, gen))


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
        self.attn_backend = "auto"      # set_attn_backend

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
        route = attention_route(self.attn_backend, dense.shape[1],
                                dense.shape[2], seg=True)
        for layer in self.layers:
            dense = layer(dense, route, seg, gen)
        return self.final_norm(dense)

    def _unpacked(self, dense, valid, gen):
        B, _, d = dense.shape
        cls = self.cls_embedding.to(dense.dtype).expand(B, 1, d)
        dense = torch.cat([dense, cls], dim=1)
        valid = torch.cat([valid, valid.new_ones(B, 1)], dim=1)
        if self.norm_input is not None:
            dense = self.norm_input(dense)
        S = dense.shape[1]
        gb = graphs_per_row(S, self.attn_backend)
        block = 0
        if gb > 1:
            pad = -B % gb
            dense = torch.cat([dense, dense.new_zeros(pad, S, d)])
            valid = torch.cat([valid, valid.new_zeros(pad, S)])
            dense = dense.reshape(-1, gb * S, d)
            valid = valid.reshape(-1, gb * S)
            block = S
        route = attention_route(self.attn_backend, dense.shape[1], d, block)
        if route == "k5":
            valid = key_padding_segs(valid)    # K5's form, once for all layers
        for layer in self.layers:
            dense = layer(dense, route, gen=gen, valid=valid, block=block)
        dense = self.final_norm(dense)
        return dense.reshape(-1, S, d)[:B] if gb > 1 else dense
