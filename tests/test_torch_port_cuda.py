"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports no JAX, so it runs on a machine with a card
and no JAX (``--noconftest`` skips tests/conftest.py, which imports JAX):
    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import argparse
import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

from graphtrans_tpu_torch.data.batch import collate  # noqa: E402
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import BOND_FEATURE_DIMS  # noqa: E402
from graphtrans_tpu_torch.ops.dense_mp import bond_table_index  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_seg, attention_seg_bwd, attention_seg_bwd_plain,
    attention_seg_plain, gin_agg, gin_agg_bwd, gin_agg_bwd_plain,
    gin_agg_plain, set_kernels)
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    attention_seg_with_stats, seg_instance)

K1_TOL, K2_TOL, LOGITS_TOL = 1e-5, 2e-5, 1e-4
GRAD_TOL = 5e-4  # gradients (the SMOKE_TPU.json bound)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _batch(G=9, Sm=48, Em=144, seed=0):
    graphs = make_mol_dataset(num_graphs=G - 2, num_tasks=4, min_nodes=1,
                              max_nodes=Sm, seed=seed)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    return collate(graphs, G, G * Sm, 4096, num_tasks=4, y_dtype="float32",
                   node_stride=Sm, dense_edge_cap=Em, seq_pack_w=128)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (False, False)])
def test_gin_agg_kernel_matches_plain(cuda, d, with_w, with_scale):
    b = _batch().to(cuda)
    G, Sm, Em = b.num_graph_slots, b.node_stride, b.edge_src_dense.shape[1]
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(G, Sm, d, generator=gen).to(cuda)
    x = x.masked_fill(~b.node_mask.reshape(G, Sm, 1), 0.0)
    args = (x, b.edge_src_dense, b.edge_dst_dense, b.edge_mask_dense,
            bond_table_index(b.edge_attr_dense, BOND_FEATURE_DIMS),
            torch.randn(sum(BOND_FEATURE_DIMS), d, generator=gen).to(cuda),
            torch.randn(G, Em, generator=gen).to(cuda) if with_w else None,
            torch.tensor([1.25], device=cuda) if with_scale else None)
    before = gin_agg.launches
    got = gin_agg(*args)
    torch.cuda.synchronize()
    assert gin_agg.launches == before + 1
    assert (got - gin_agg_plain(*args)).abs().max().item() <= K1_TOL
    assert not got.reshape(G * Sm, d)[~b.node_mask].any()


def _k1_args(b, d, with_w, with_scale, cuda):
    G, Sm, Em = b.num_graph_slots, b.node_stride, b.edge_src_dense.shape[1]
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(G, Sm, d, generator=gen).to(cuda)
    x = x.masked_fill(~b.node_mask.reshape(G, Sm, 1), 0.0)
    return (x, b.edge_src_dense, b.edge_dst_dense, b.edge_mask_dense,
            bond_table_index(b.edge_attr_dense, BOND_FEATURE_DIMS),
            torch.randn(sum(BOND_FEATURE_DIMS), d, generator=gen).to(cuda),
            torch.randn(G, Em, generator=gen).to(cuda) if with_w else None,
            torch.tensor([1.25], device=cuda) if with_scale else None)


@functools.lru_cache(maxsize=None)
def _k1_batch(G):
    """G graph slots (the last two padding where G > 2): molecules of up to
    48 nodes in 144 edge slots, or at G 4097 the bench batch's stride 32
    and 96 slots; graphs of 1 node up, so one-node graphs (no edges) share
    chunks with full ones; masked slots and padding rows in every graph."""
    Sm, Em = (32, 96) if G > 1000 else (48, 144)
    graphs = make_mol_dataset(num_graphs=max(1, G - 2), num_tasks=4,
                              min_nodes=1, max_nodes=Sm, seed=G)
    return collate(graphs, G, G * Sm, G * Em, num_tasks=4, y_dtype="float32",
                   node_stride=Sm, dense_edge_cap=Em)


@functools.lru_cache(maxsize=None)
def _k1_fwd_batch(G, Sm):
    """G graph slots of stride Sm and 3 Sm edge slots (the last two padding
    where G > 2): molecules of 1 node up, so graphs with no edges share
    chunks with full ones, and one graph (slot 1) whose slots are all
    masked where G > 1."""
    graphs = make_mol_dataset(num_graphs=max(1, G - 2), num_tasks=4,
                              min_nodes=1, max_nodes=Sm, seed=G + Sm)
    b = collate(graphs, G, G * Sm, G * 3 * Sm, num_tasks=4,
                y_dtype="float32", node_stride=Sm, dense_edge_cap=3 * Sm)
    if G > 1:
        mask = b.edge_mask_dense.copy()
        mask[1] = False
        b = dataclasses.replace(b, edge_mask_dense=mask)
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 64, 4097])
@pytest.mark.parametrize("Sm", [32, 48, 128])
@pytest.mark.parametrize("d", [40, 128, 256, 300])
def test_gin_agg_fwd_kernel_matches_plain(cuda, deterministic, G, Sm, d):
    """K1's forward against the plain version (K1_TOL) with and without w
    and scale, at one graph, 64 and the bench batch's 4097, strides 32, 48
    and 128: graphs with no edges and one whose slots are all masked, the
    launch fwd_geometry picks (channels split at 1 and 64 graphs); the same
    bits on two runs; padding node rows scale*x (0 without a scale). The
    plain version runs under deterministic algorithms: its scatter_add_
    otherwise sums with atomics in no fixed order, and moved by up to
    1.14e-5 from run to run."""
    from graphtrans_tpu_torch.ops.kernels.gin_agg import fwd_geometry

    b = _k1_fwd_batch(G, Sm).to(cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    geo = fwd_geometry(G, Sm, 3 * Sm, 3, sum(BOND_FEATURE_DIMS), d, False,
                       sms)
    assert (geo.slices > 1) == (G < 100 and d >= 64)
    for with_w, with_scale in ((False, True), (True, False), (True, True),
                               (False, False)):
        args = _k1_args(b, d, with_w, with_scale, cuda)
        before = gin_agg.launches
        got, again = gin_agg(*args), gin_agg(*args)
        torch.cuda.synchronize()
        assert gin_agg.launches == before + 2
        assert torch.equal(got, again)
        assert (got - gin_agg_plain(*args)).abs().max().item() <= K1_TOL
        pad = ~b.node_mask.reshape(G, Sm)
        want = args[0][pad] * (args[7].item() if with_scale else 0.0)
        assert torch.allclose(got[pad], want, rtol=0, atol=K1_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [65, 4097])
@pytest.mark.parametrize("d", [42, 300])
def test_gin_agg_fwd_launches_agree(cuda, G, d, monkeypatch):
    """The same work under each launch: fwd_geometry's, the one it picks
    for a card of 16 SMs (other chunks of graphs and channel slices), and
    (d % 4 == 0) copies one float off 16-byte alignment (one channel a
    thread): each within K1_TOL of the plain version, all with the same
    bits (a row's terms have one order under every launch)."""
    k1 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.gin_agg")
    fwd_geometry = k1.fwd_geometry
    b = _k1_batch(G).to(cuda)
    args = _k1_args(b, d, True, True, cuda)
    want = gin_agg_plain(*args)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shape = (G, b.node_stride, args[1].shape[1], args[4].shape[1],
             args[5].shape[0], d, True)
    outs = [gin_agg(*args)]
    assert fwd_geometry(*shape, 16) != fwd_geometry(*shape, sms)
    with monkeypatch.context() as m:
        m.setattr(k1, "_sms", lambda device: 16)
        outs.append(gin_agg(*args))

    def shifted(t):     # a contiguous copy whose address is 4 bytes off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    off = list(args)
    off[0], off[5] = shifted(args[0]), shifted(args[5])
    assert fwd_geometry(*shape, sms, align=1).vec == 1
    outs.append(gin_agg(*off))
    torch.cuda.synchronize()
    assert len(outs) == 3
    for got in outs:
        assert (got - want).abs().max().item() <= K1_TOL
        assert torch.equal(got, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 65, 4097])
@pytest.mark.parametrize("d", [40, 128, 300])
@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (True, True)])
def test_gin_agg_bwd_kernel_matches_plain(cuda, G, d, with_w, with_scale):
    """dx, dT, dw and dscale of K1's backward kernels against autograd
    through the plain version (5e-4 of max(1, max|ref|)) at one graph, at
    serve64's 65 and at the bench batch's 4097: dx on padding rows exactly
    scale*gout (0 without a scale), dw on masked slots exactly 0, the same
    bits on two runs."""
    b = _k1_batch(G).to(cuda)
    args = _k1_args(b, d, with_w, with_scale, cuda)
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        7)).to(cuda)
    before = gin_agg_bwd.launches
    got = gin_agg_bwd(*args, gout)
    again = gin_agg_bwd(*args, gout)
    torch.cuda.synchronize()
    assert gin_agg_bwd.launches == before + 2
    want = gin_agg_bwd_plain(*args, gout)
    for name, g, w, a in zip(("dx", "dT", "dw", "dscale"), got, want, again):
        assert (g is None) == (w is None), name
        if g is not None:
            err = (g - w).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, w.abs().max().item()), name
            assert torch.equal(g, a), name
    pad = ~b.node_mask.reshape(args[0].shape[:2])
    scale = args[7].item() if with_scale else 0.0
    assert torch.equal(got[0][pad], scale * gout[pad])
    if with_w:
        assert not got[2][~b.edge_mask_dense].any()


@pytest.mark.cuda
@pytest.mark.parametrize("G", [65, 4097])
@pytest.mark.parametrize("d", [42, 300])
def test_gin_agg_bwd_launches_agree(cuda, G, d):
    """The same work on 16-byte aligned tensors and on copies one float
    off (4 channels a thread where d allows, else 1) matches autograd
    through the plain version, w and scale given; dx has the same bits
    under each launch (a row's sum has one order)."""
    from graphtrans_tpu_torch.ops.kernels.gin_agg import bwd_geometry

    b = _k1_batch(G).to(cuda)
    args = _k1_args(b, d, True, True, cuda)
    gout = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(
        3)).to(cuda)
    want = gin_agg_bwd_plain(*args, gout)

    def shifted(t):     # a contiguous copy whose address is 4 bytes off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    off = list(args)
    off[0], off[5] = shifted(args[0]), shifted(args[5])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shape = (G, b.node_stride, args[1].shape[1], args[4].shape[1],
             args[5].shape[0], d, True, sms)
    vecs = [bwd_geometry(*shape, align).vec for align in (4, 1)]
    assert vecs == ([4, 1] if d % 4 == 0 else [1, 1])
    dx = None
    for a, g_out in ((args, gout), (off, shifted(gout))):
        got = gin_agg_bwd(*a, g_out)
        for name, g, w in zip(("dx", "dT", "dw", "dscale"), got, want):
            err = (g - w).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, w.abs().max().item()), name
        dx = got[0] if dx is None else dx
        assert torch.equal(got[0], dx)


@pytest.mark.cuda
@pytest.mark.parametrize("W,d,H", [(128, 128, 4), (384, 128, 4), (256, 64, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_seg_bwd_kernel_matches_plain(cuda, W, d, H, rate):
    """K2 forward with dropout and its backward kernel against the plain
    version, which draws the same mask, and its autograd."""
    qkv, seg = _k2_case(W, d, cuda)
    g = torch.randn(qkv.shape[0], W, d,
                    generator=torch.Generator().manual_seed(3)).to(cuda)
    seed = 987654321
    out, m, l = attention_seg_with_stats(qkv, seg, H, rate, seed)
    before = attention_seg_bwd.launches
    dqkv = attention_seg_bwd(qkv, seg, H, g, (out, m, l), rate, seed)
    torch.cuda.synchronize()
    assert attention_seg_bwd.launches == before + 1
    want = attention_seg_plain(qkv, seg, H, rate, seed)
    assert (out - want).abs().max().item() <= K2_TOL
    err = (dqkv - attention_seg_bwd_plain(qkv, seg, H, g, rate, seed)).abs()
    assert err.max().item() <= GRAD_TOL
    assert not dqkv[seg < 0].any()


def _k2_case(W, d, cuda):
    gen = torch.Generator().manual_seed(W + d)
    R = 6
    seg = torch.full((R, W), -1, dtype=torch.int32)
    lens = torch.randint(2, W // 3, (64,), generator=gen).tolist()
    g = 0
    for r in range(R - 1):                       # the last row is all padding
        s = 0
        while s + lens[g % 64] <= W - 5:
            seg[r, s:s + lens[g % 64]] = g
            s += lens[g % 64]
            g += 1
    return torch.randn(R, W, 3 * d, generator=gen).to(cuda), seg.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("W,d,H", [(128, 128, 4), (384, 128, 4), (256, 64, 2)])
def test_attention_seg_kernel_matches_plain(cuda, W, d, H):
    qkv, seg = _k2_case(W, d, cuda)
    before = attention_seg.launches
    got = attention_seg(qkv, seg, H)
    torch.cuda.synchronize()
    assert attention_seg.launches == before + 1
    assert (got - attention_seg_plain(qkv, seg, H)).abs().max().item() <= K2_TOL
    assert not got[seg < 0].any()


# K2's rows by segment length: 1, 27, 64, 65, 128 (and 129, 384 on wide
# rows), an id in two runs (7), padding gaps and an all-padding row
K2_SEGMENTS = {
    37: [[10, (3, -1), 9, 12, (3, -1)], [(5, 2), 5, (5, 2), (22, -1)], [37]],
    128: [[1] * 9 + [27] * 4 + [(11, -1)], [64, 64], [65, (63, -1)], [128],
          [(20, 7), 10, (15, 7), (83, -1)], [(128, -1)]],
    384: [[129, 128, (127, -1)], [384], [1, 27, 64, 65, 127, (100, -1)],
          [(150, 7), 100, (100, 7), (34, -1)], [(384, -1)]],
}


def _k2_segments(W, cuda, extra=()):
    """qkv (random) and seg of the rows K2_SEGMENTS[W], then ``extra``."""
    rows = K2_SEGMENTS[W] + list(extra)
    seg = torch.full((len(rows), W), -1, dtype=torch.int32)
    g = 1000
    for r, runs in enumerate(rows):
        s = 0
        for run in runs:
            n, gid = run if isinstance(run, tuple) else (run, None)
            if gid != -1:
                seg[r, s:s + n] = g if gid is None else gid
            g, s = g + 1, s + n
    gen = torch.Generator().manual_seed(W)
    return (torch.randn(len(seg), W, 384, generator=gen).to(cuda),
            seg.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [37, 128, 384])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_seg_segments_match_plain(cuda, W, rate):
    """K2 and K2-bwd on rows of every segment length around the
    instances' limits, an id in two runs and an all-padding row: within
    K2_TOL (forward) and GRAD_TOL of max(1, max |ref|) (backward) of the
    plain version, m and l their log-sum-exp, padding rows exactly 0, the
    same bits on two runs, launches counted by instance."""
    H, seed = 4, 2**31 - 11
    qkv, seg = _k2_segments(W, cuda)
    g = torch.randn(qkv.shape[0], W, 128,
                    generator=torch.Generator().manual_seed(5)).to(cuda)
    inst = seg_instance(W)
    f0, b0 = attention_seg.instances[inst], attention_seg_bwd.instances[inst]
    runs = []
    for _ in range(2):
        out, m, l = attention_seg_with_stats(qkv, seg, H, rate, seed)
        dqkv = attention_seg_bwd(qkv, seg, H, g, (out, m, l), rate, seed)
        runs.append((out, m, l, dqkv))
    torch.cuda.synchronize()
    assert attention_seg.instances[inst] == f0 + 2
    assert attention_seg_bwd.instances[inst] == b0 + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, m, l, dqkv = runs[0]
    want = attention_seg_plain(qkv, seg, H, rate, seed)
    assert (out - want).abs().max().item() <= K2_TOL
    want_d = attention_seg_bwd_plain(qkv, seg, H, g, rate, seed)
    assert ((dqkv - want_d).abs().max().item()
            <= GRAD_TOL * max(1.0, want_d.abs().max().item()))
    pad = seg < 0
    assert not out[pad].any() and not dqkv[pad].any()
    q, k = (t.reshape(len(seg), W, H, 32).transpose(1, 2)
            for t in (qkv[..., :128], qkv[..., 128:256]))
    s = q @ k.transpose(-1, -2) / 32 ** 0.5
    meet = (seg[:, :, None] == seg[:, None, :]) & ~pad[:, None, :]
    lse = torch.logsumexp(s.masked_fill(~meet[:, None], -float("inf")), -1)
    lse = lse.transpose(1, 2)[~pad]
    assert (m[~pad] + l[~pad].log() - lse).abs().max().item() <= 1e-5
    serving = attention_seg(qkv, seg, H)
    assert (serving - attention_seg_plain(qkv, seg, H)).abs().max().item() \
        <= K2_TOL


@pytest.mark.cuda
def test_model_kernels_match_plain_versions(cuda):
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.init import init_weights

    model = GNNTransformer(4, 3, 300, True, 128, 4, 512, 2, True, device=cuda)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    b = _batch(seed=3).to(cuda)
    with torch.inference_mode():
        got = model(b)[b.graph_mask]
        want = set_kernels(model, False)(b)[b.graph_mask]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= LOGITS_TOL


def _train_model(cuda, seed=0):
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.init import init_weights

    model = GNNTransformer(4, 3, 300, True, 128, 4, 512, 2, True,
                           gnn_dropout=0.3, transformer_dropout=0.3,
                           device=cuda)
    return init_weights(model, torch.Generator().manual_seed(seed)).train()


def _loss_and_grads(model, b, cuda, kernels: bool):
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.train.losses import binary_multitask_loss

    set_kernels(model, kernels)
    model.zero_grad(set_to_none=True)
    loss = binary_multitask_loss(model(b, Generators.seeded(5, cuda)), b)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_backward_through_kernels_reaches_every_leaf(cuda):
    """loss.backward() through the CUDA wrappers gives a gradient to the
    GIN inputs, every bond table, every eps and every in_proj, equal to
    the plain route's (the wrappers are autograd Functions)."""
    model = _train_model(cuda)
    b = _batch(seed=3).to(cuda)
    f1, b1 = gin_agg_bwd.launches, attention_seg_bwd.launches
    _, grads = _loss_and_grads(model, b, cuda, kernels=True)
    assert gin_agg_bwd.launches == f1 + 3
    assert attention_seg_bwd.launches == b1 + 2
    state = {n: p for n, p in model.named_parameters()}
    _, plain = _loss_and_grads(model, b, cuda, kernels=False)
    for name in state:
        if ("edge_encoder" in name or name.endswith(".eps")
                or "in_proj" in name or "atom_encoder" in name):
            g = grads[name]
            assert g is not None and g.abs().sum().item() > 0, name
            err = (g - plain[name]).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, plain[name].abs().max().item()), name


@pytest.mark.cuda
def test_train_step_kernels_match_plain(cuda):
    """One AdamW step with dropout on, from the same state and generator
    seeds: loss, gradients and updated parameters through the kernels
    against the plain versions on the card."""
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.train.losses import binary_multitask_loss
    from graphtrans_tpu_torch.train.optim import build_optimizer
    from graphtrans_tpu_torch.trainers.base_trainer import make_train_step

    b = _batch(seed=4).to(cuda)
    args = argparse.Namespace(lr=1e-4, weight_decay=0.0, grad_clip=None,
                              scheduler=None, epochs=1)
    out = []
    for kernels in (True, False):
        model = set_kernels(_train_model(cuda), kernels)
        opt = build_optimizer(model, args, 1)
        step = make_train_step(model, binary_multitask_loss, opt,
                               Generators.seeded(11, cuda))
        loss = step(b).item()
        out.append((loss, {n: p.grad.clone() for n, p in
                           model.named_parameters()},
                    {n: p.detach().clone() for n, p in
                     model.named_parameters()}))
    (lk, gk, pk), (lp, gp, pp) = out
    assert abs(lk - lp) <= LOGITS_TOL
    for name in gk:
        scale = max(1.0, gp[name].abs().max().item())
        assert (gk[name] - gp[name]).abs().max().item() <= GRAD_TOL * scale, name
        # Adam: a rounding-level gradient may move by up to 2 lr
        firm = gp[name].abs() >= 1e-5
        diff = (pk[name] - pp[name]).abs()
        assert diff.max().item() <= 2 * args.lr + 1e-6, name
        assert torch.where(firm, diff, 0.0).max().item() <= (
            1e-6 + 0.01 * args.lr), name


# ---- code2 serving: K3 (flash_hil_seg) and K7 (spmm) ----------------------

K3_TOL = 2e-5


def _k3_case(W, d, cuda):
    """Two packed rows of width W: segments of many sizes (single tokens
    too) and a padding tail; one all-padding row."""
    gen = torch.Generator().manual_seed(W + d)
    seg = torch.full((3, W), -1, dtype=torch.int32)
    s = g = 0
    for n in [W // 2 + 5, 1, 60, 1, 130, 7, W // 8]:
        if s + n > W - 3:
            break
        seg[0, s:s + n] = g
        s, g = s + n, g + 1
    seg[1, :W - 40] = torch.arange(W - 40) // 97 + g
    return torch.randn(3, W, 3 * d, generator=gen).to(cuda), seg.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [512, 1024])
@pytest.mark.parametrize("d", [128, 64])
def test_flash_hil_kernel_matches_plain(cuda, W, d):
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_plain)

    qkv, seg = _k3_case(W, d, cuda)
    H = d // 32
    before = flash_hil_seg.launches
    got = flash_hil_seg(qkv, seg, H)
    torch.cuda.synchronize()
    assert flash_hil_seg.launches == before + 1
    assert (got - flash_hil_seg_plain(qkv, seg, H)).abs().max().item() <= K3_TOL
    assert not got[seg < 0].any()


def _k7_case(d, cuda, N=3000, E=9000, n_valid=7000):
    gen = torch.Generator().manual_seed(d)
    dst = torch.sort(torch.randint(0, N - 500, (n_valid,), generator=gen))[0]
    src = torch.randint(0, N - 1, (n_valid,), generator=gen)
    pad = torch.full((E - n_valid,), N - 1)
    dst, src = torch.cat([dst, pad]), torch.cat([src, pad])
    mask = torch.arange(E) < n_valid
    return [t.to(cuda) for t in (
        torch.randn(N, d, generator=gen), torch.randn(E, d, generator=gen),
        src.int(), dst.int(), mask, torch.rand(E, generator=gen) + 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_kernel_matches_plain(cuda, d, message, weighted):
    from graphtrans_tpu_torch.ops.kernels import spmm, spmm_plain

    x, emb, src, dst, mask, w = _k7_case(d, cuda)
    w = w if weighted else None
    before = spmm.launches
    got = spmm(x, emb, src, dst, mask, w, message)
    torch.cuda.synchronize()
    assert spmm.launches == before + 1
    want = spmm_plain(x, emb, src, dst, mask, w, message)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    assert not got[x.shape[0] - 500:].any()      # rows with no valid edge


def _code2_batch(seed=0):
    from graphtrans_tpu_torch.data.synthetic import make_code_dataset
    from graphtrans_tpu_torch.data.vocab import (augment_edge,
                                                 encode_seq_to_arr,
                                                 get_vocab_mapping)

    raw = make_code_dataset(num_graphs=14, vocab_size=50, seq_len_max=6,
                            seed=seed, size_dist="code2")
    raw[0] = make_code_dataset(num_graphs=1, min_nodes=1100, max_nodes=1100,
                               seed=seed)[0]
    v2i, _ = get_vocab_mapping([g["y_seq"] for g in raw], 50)
    graphs = [dict(augment_edge(g), _id=i,
                   y_arr=encode_seq_to_arr(g["y_seq"], v2i, 5))
              for i, g in enumerate(raw)]
    batch = collate(graphs, 15, 8192, 32768, num_tasks=len(v2i),
                    max_seq_len=5, seq_pack_w=1024, seq_pack_w2=384,
                    seq_pack_w3=128)
    return batch, len(v2i)


def _code2_model(num_tasks, cuda):
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder
    from graphtrans_tpu_torch.nn.init import init_weights

    model = GNNTransformer(num_tasks, 3, 300, True, 128, 4, 512, 2, True,
                           device=cuda, gnn_type="gcn",
                           node_encoder=ASTNodeEncoder(300, 20, 100,
                                                       device=cuda),
                           max_seq_len=5)
    return init_weights(model, torch.Generator().manual_seed(0)).eval()


@pytest.mark.cuda
def test_code2_model_kernels_match_plain_versions(cuda):
    from graphtrans_tpu_torch.ops.kernels import flash_hil_seg, spmm

    batch, num_tasks = _code2_batch()
    assert batch.pack_w == 1024 and batch.pack3_w == 128
    b = batch.to(cuda)
    model = _code2_model(num_tasks, cuda)
    f0, s0 = flash_hil_seg.launches, spmm.launches
    with torch.inference_mode():
        got = model(b)[b.graph_mask]
        assert flash_hil_seg.launches == f0 + 2 and spmm.launches == s0 + 3
        want = set_kernels(model, False)(b)[b.graph_mask]
    assert torch.isfinite(got).all() and got.shape[1:] == (5, num_tasks)
    assert (got - want).abs().max().item() <= LOGITS_TOL


@pytest.mark.cuda
def test_k3_k7_refuse_to_drop_gradients(cuda):
    """Through either kernel a CUDA leaf gets its gradient from the backward
    kernel (equal to autograd through the plain version); an edge weight
    that asks for a gradient K7 does not compute raises, as does a gradient
    through K7 without the edges' SrcOrder; under no_grad and
    inference_mode the forwards run without saving anything, and K3 with
    dropout runs its one dropout launch (which writes the statistics)."""
    from graphtrans_tpu_torch.ops.kernels import (
        SrcOrder, flash_hil_seg, flash_hil_seg_bwd, flash_hil_seg_bwd_plain,
        flash_hil_seg_plain, spmm, spmm_bwd, spmm_bwd_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    qkv, seg = _k3_case(512, 128, cuda)
    x, emb, src, dst, mask, w = _k7_case(128, cuda)
    leaf_q = qkv.clone().requires_grad_()
    leaf_x, leaf_e = x.clone().requires_grad_(), emb.clone().requires_grad_()
    g3 = torch.randn(3, 512, 128, device=cuda)
    g7 = torch.randn(x.shape, device=cuda)
    order = SrcOrder(src, mask, x.shape[0])
    b3, b7 = flash_hil_seg_bwd.launches, spmm_bwd.launches
    flash_hil_seg(leaf_q, seg, 4, 0.3, 99).backward(g3)
    spmm(leaf_x, leaf_e, src, dst, mask, w, order=order).backward(g7)
    torch.cuda.synchronize()
    assert (flash_hil_seg_bwd.launches, spmm_bwd.launches) == (b3 + 1, b7 + 1)
    want = flash_hil_seg_bwd_plain(qkv, seg, 4, g3, 0.3, 99)
    assert (leaf_q.grad - want).abs().max().item() <= GRAD_TOL * max(
        1.0, want.abs().max().item())
    for got, ref in zip((leaf_x.grad, leaf_e.grad),
                        spmm_bwd_plain(x, emb, src, dst, mask, g7, w)):
        assert (got - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item())
    with pytest.raises(ValueError, match="edge_weight"):
        spmm(leaf_x, emb, src, dst, mask, w.clone().requires_grad_(),
             order=order)
    with pytest.raises(ValueError, match="SrcOrder"):
        spmm(leaf_x, emb, src, dst, mask, w)
    with torch.no_grad():
        flash_hil_seg(leaf_q, seg, 4)
        spmm(leaf_x, emb, src, dst, mask, w)
        # dropout is for training: its launch always saves the statistics
        out, m, _ = flash_hil_seg_with_stats(qkv, seg, 4, 0.3, 99,
                                             stats=False)
        assert m is not None
        assert (flash_hil_seg(leaf_q, seg, 4, 0.3, 99) - out).abs().max(
            ).item() == 0
        assert (out - flash_hil_seg_plain(qkv, seg, 4, 0.3, 99)).abs().max(
            ).item() <= K3_TOL
    with torch.inference_mode():
        flash_hil_seg(leaf_q, seg, 4)
        spmm(leaf_x, emb, src, dst, mask, w)
    torch.cuda.synchronize()


# ---- code2 training: K3 with dropout, K3-bwd, K7-bwd ----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("W", [512, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_hil_dropout_and_bwd_kernels_match_plain(cuda, W, rate):
    """K3's forward with dropout and its dq and dk/dv kernels against the
    plain version, which draws the same mask, and its autograd."""
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg_bwd,
                                                  flash_hil_seg_bwd_plain,
                                                  flash_hil_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    qkv, seg = _k3_case(W, 128, cuda)
    g = torch.randn(3, W, 128, generator=torch.Generator().manual_seed(W)
                    ).to(cuda)
    seed = 2**31 - 7
    saved = flash_hil_seg_with_stats(qkv, seg, 4, rate, seed)
    before = flash_hil_seg_bwd.launches
    dqkv = flash_hil_seg_bwd(qkv, seg, 4, g, saved, rate, seed)
    torch.cuda.synchronize()
    assert flash_hil_seg_bwd.launches == before + 1
    out = saved[0]
    assert (out - flash_hil_seg_plain(qkv, seg, 4, rate, seed)
            ).abs().max().item() <= K3_TOL
    want = flash_hil_seg_bwd_plain(qkv, seg, 4, g, rate, seed)
    assert (dqkv - want).abs().max().item() <= GRAD_TOL * max(
        1.0, want.abs().max().item())
    assert not dqkv[seg < 0].any() and not out[seg < 0].any()


K3_SEGMENTS = {   # rows of (length, graph id: None a new one, -1 padding)
    512: [[1, 64, 385, (62, -1)], [(512, -1)],
          [(100, 7), 200, (100, 7), 1, (111, -1)], [512], [(7, -1), 505]],
    1024: [[1024], [1, 64, 385, 1, 64, 385, (124, -1)], [(1024, -1)],
           [(300, 9), 400, (300, 9), (24, -1)]],
}


def _k3_segments(W, cuda):
    seg = torch.full((len(K3_SEGMENTS[W]), W), -1, dtype=torch.int32)
    g = 1000
    for r, runs in enumerate(K3_SEGMENTS[W]):
        s = 0
        for run in runs:
            n, gid = run if isinstance(run, tuple) else (run, None)
            if gid != -1:
                seg[r, s:s + n] = g if gid is None else gid
            g, s = g + 1, s + n
    gen = torch.Generator().manual_seed(W + 1)
    return (torch.randn(len(seg), W, 384, generator=gen).to(cuda),
            seg.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [512, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_hil_segments_match_plain(cuda, W, rate):
    """K3's forward (the long forward under seg as both tags) on segments
    of 1, 64, 385 and 1024 tokens, an all-padding row and one graph id in
    two runs: within K3_TOL of the plain version, m and l the plain
    softmax statistics (m = -inf, l = 0 and the output exactly 0 on
    padding queries), the same bits on two runs, and K3-bwd on these m
    and l within GRAD_TOL of autograd through the plain version."""
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_bwd,
                                                  flash_hil_seg_bwd_plain,
                                                  flash_hil_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    H, seed = 4, 2**31 - 13
    qkv, seg = _k3_segments(W, cuda)
    g = torch.randn(qkv.shape[0], W, 128,
                    generator=torch.Generator().manual_seed(W)).to(cuda)
    before = flash_hil_seg.launches
    runs = [flash_hil_seg_with_stats(qkv, seg, H, rate, seed)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert flash_hil_seg.launches == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, m, l = runs[0]
    assert (out - flash_hil_seg_plain(qkv, seg, H, rate, seed)
            ).abs().max().item() <= K3_TOL
    pad = seg < 0
    assert not out[pad].any()
    meet = (seg[:, :, None] == seg[:, None, :]) & ~pad[:, None, :]
    _check_stats(m, l, qkv, meet, H)
    dqkv = flash_hil_seg_bwd(qkv, seg, H, g, (out, m, l), rate, seed)
    want = flash_hil_seg_bwd_plain(qkv, seg, H, g, rate, seed)
    assert (dqkv - want).abs().max().item() <= GRAD_TOL * max(
        1.0, want.abs().max().item())
    assert not dqkv[pad].any()
    serving = flash_hil_seg(qkv, seg, H, rate, seed)
    assert torch.equal(serving, out)


def _k3_straddle_case(W, cuda):
    """Three rows of width W, 4 heads of 32: row 0 segments of sizes that
    straddle the long backward's 64-token tiles (single tokens among them)
    and a padding tail; row 1 all padding, so its tiles and chunks hold no
    valid key (a K3 query always attends itself: a valid segment has
    keys); row 2 segments of 97."""
    gen = torch.Generator().manual_seed(W)
    seg = torch.full((3, W), -1, dtype=torch.int32)
    s = g = 0
    for n in [1, 63, 2, 130, 1, 65, 200, 3, 129, 31, 1, 250]:
        if s + n > W - 5:
            break
        seg[0, s:s + n] = g
        s, g = s + n, g + 1
    seg[2, :W - 40] = torch.arange(W - 40) // 97 + g
    return torch.randn(3, W, 384, generator=gen).to(cuda), seg.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1024, 1001, 448])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_hil_long_bwd_matches_plain(cuda, W, rate):
    """K3-bwd on the long-row backward (seg as both tags, K3's own mask
    policy) against autograd through the plain version at code2's W=1024
    and at widths that are no multiple of 64: segments that straddle the
    64-token tiles and chunks, an all-padding row; padding tokens exactly
    zero, and two runs give the same bits."""
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg_bwd,
                                                  flash_hil_seg_bwd_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    qkv, seg = _k3_straddle_case(W, cuda)
    g = torch.randn(3, W, 128, generator=torch.Generator().manual_seed(W + 1)
                    ).to(cuda)
    seed = 2**31 - 5
    saved = flash_hil_seg_with_stats(qkv, seg, 4, rate, seed)
    dqkv = flash_hil_seg_bwd(qkv, seg, 4, g, saved, rate, seed)
    again = flash_hil_seg_bwd(qkv, seg, 4, g, saved, rate, seed)
    torch.cuda.synchronize()
    want = flash_hil_seg_bwd_plain(qkv, seg, 4, g, rate, seed)
    assert (dqkv - want).abs().max().item() <= GRAD_TOL * max(
        1.0, want.abs().max().item())
    assert not dqkv[seg < 0].any()
    assert torch.equal(dqkv, again)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_bwd_kernel_matches_plain(cuda, d, message, weighted):
    """dx and d_emb of K7's backward kernel against autograd through the
    plain version; masked edges (the padding tail and one mid-list) get
    exact-zero d_emb rows."""
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, spmm_bwd,
                                                  spmm_bwd_plain)

    x, emb, src, dst, mask, w = _k7_case(d, cuda)
    mask[5] = False
    w = w if weighted else None
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(d)
                    ).to(cuda)
    before = spmm_bwd.launches
    got = spmm_bwd(x, emb, src, dst, mask, g, SrcOrder(src, mask, x.shape[0]),
                   w, message)
    torch.cuda.synchronize()
    assert spmm_bwd.launches == before + 1
    for a, b in zip(got, spmm_bwd_plain(x, emb, src, dst, mask, g, w,
                                        message)):
        assert (a - b).abs().max().item() <= GRAD_TOL * max(
            1.0, b.abs().max().item())
    assert not got[1][~mask].any()


def _k7_hub_case(d, cuda, N=3000, E=12000, n_valid=9000):
    """_k7_case's edges with a hub (source row 7 holds 3000 valid edges),
    zero weights inside rows (every fifth edge of row 11, all of row 12),
    a masked edge mid-list, source rows N-600 .. N-2 with no edge, and a
    masked padding tail."""
    gen = torch.Generator().manual_seed(d + 1)
    dst = torch.sort(torch.randint(0, N - 500, (n_valid,), generator=gen))[0]
    src = torch.randint(0, N - 600, (n_valid,), generator=gen)
    src[torch.randperm(n_valid, generator=gen)[:3000]] = 7
    pad = torch.full((E - n_valid,), N - 1)
    dst, src = torch.cat([dst, pad]), torch.cat([src, pad])
    mask = torch.arange(E) < n_valid
    mask[5] = False
    w = torch.rand(E, generator=gen) + 0.1
    w[torch.nonzero(src == 11).flatten()[::5]] = 0.0
    w[src == 12] = 0.0
    return [t.to(cuda) for t in (
        torch.randn(N, d, generator=gen), torch.randn(E, d, generator=gen),
        src.int(), dst.int(), mask, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 128, 300, 512])
@pytest.mark.parametrize("message", ["relu_add", "add"])
def test_spmm_bwd_runs_match_plain(cuda, d, message):
    """K7-bwd's walk over runs of whole source rows against autograd
    through the plain version (5e-4 of max(1, max|ref|)): rows with no
    edge (dx exactly 0), a row of 3000 edges, zero weights inside a row
    and a whole row of them, masked edges (d_emb rows exactly 0); the
    same bits on two runs, and on copies one float off 16-byte alignment
    (one float a load)."""
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, spmm_bwd,
                                                  spmm_bwd_plain)

    x, emb, src, dst, mask, w = _k7_hub_case(d, cuda)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(d)
                    ).to(cuda)
    order = SrcOrder(src, mask, x.shape[0])
    before = spmm_bwd.launches
    got = spmm_bwd(x, emb, src, dst, mask, g, order, w, message)
    again = spmm_bwd(x, emb, src, dst, mask, g, order, w, message)
    torch.cuda.synchronize()
    assert spmm_bwd.launches == before + 2
    want = spmm_bwd_plain(x, emb, src, dst, mask, g, w, message)
    for a, b, c in zip(got, want, again):
        assert (a - b).abs().max().item() <= GRAD_TOL * max(
            1.0, b.abs().max().item())
        assert torch.equal(a, c)
    assert not got[1][~mask].any() and not got[1][w == 0].any()
    assert not got[0][x.shape[0] - 600:x.shape[0] - 1].any()

    def shifted(t):     # a contiguous copy whose address is 4 bytes off
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    off = spmm_bwd(shifted(x), shifted(emb), src, dst, mask, shifted(g),
                   order, w, message)
    for a, c in zip(got, off):
        assert torch.equal(a, c)


@pytest.fixture
def deterministic():
    """Deterministic algorithms while the kernels are held against the plain
    route: its index_add_ otherwise sums with atomics in no fixed order,
    which the virtual node's batch-statistics BatchNorm over a few graph
    rows (single-pass variance) magnifies to ~1e-3 of its MLP's gradients,
    the plain route against itself."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield
    torch.use_deterministic_algorithms(False)


def _code2_train_model(num_tasks, cuda):
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder
    from graphtrans_tpu_torch.nn.init import init_weights

    model = GNNTransformer(num_tasks, 3, 300, True, 128, 4, 512, 2, True,
                           gnn_dropout=0.0, transformer_dropout=0.3,
                           device=cuda, gnn_type="gcn",
                           node_encoder=ASTNodeEncoder(300, 20, 100,
                                                       device=cuda),
                           max_seq_len=5)
    return init_weights(model, torch.Generator().manual_seed(0)).train()


@pytest.mark.cuda
def test_code2_backward_through_kernels_reaches_every_leaf(cuda,
                                                           deterministic):
    """loss.backward() of the code2 model through K3, K3-bwd, K7 and
    K7-bwd (and K2) gives every parameter a gradient equal to the plain
    route's, dropout 0.3 on the same masks."""
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.ops.kernels import flash_hil_seg_bwd, spmm_bwd
    from graphtrans_tpu_torch.train.losses import seq_token_loss

    batch, num_tasks = _code2_batch(seed=1)
    b = batch.to(cuda)
    model = _code2_train_model(num_tasks, cuda)
    grads = []
    for kernels in (True, False):
        set_kernels(model, kernels)
        model.zero_grad(set_to_none=True)
        f0, s0 = flash_hil_seg_bwd.launches, spmm_bwd.launches
        seq_token_loss(model(b, Generators.seeded(5, cuda)), b).backward()
        if kernels:
            assert flash_hil_seg_bwd.launches == f0 + 2     # 2 layers
            assert spmm_bwd.launches == s0 + 3              # 3 GCN layers
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        ref = grads[1][name]
        assert g is not None and g.abs().sum().item() > 0, name
        assert (g - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item()), name


@pytest.mark.cuda
def test_code2_train_step_kernels_match_plain(cuda, deterministic):
    """One AdamW step of the code2 model with attention dropout 0.3, from
    the same state and generator seeds: loss, gradients and parameters
    through the kernels against the plain versions on the card. Parameters
    under the rule of the CPU step test (test_torch_port_code2_train.py):
    a first Adam step moves an entry by up to lr whatever its gradient's
    size, so every entry whose gradient is not below 1e-5 must lie within
    1e-6 plus 1% of lr."""
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.train.losses import seq_token_loss
    from graphtrans_tpu_torch.train.optim import build_optimizer
    from graphtrans_tpu_torch.trainers.base_trainer import make_train_step

    batch, num_tasks = _code2_batch(seed=2)
    b = batch.to(cuda)
    args = argparse.Namespace(lr=1e-4, weight_decay=0.0, grad_clip=None,
                              scheduler=None, epochs=1)
    out = []
    for kernels in (True, False):
        model = set_kernels(_code2_train_model(num_tasks, cuda), kernels)
        step = make_train_step(model, seq_token_loss,
                               build_optimizer(model, args, 1),
                               Generators.seeded(11, cuda))
        loss = step(b).item()
        out.append((loss, {n: p.grad.clone() for n, p in
                           model.named_parameters()},
                    {n: p.detach().clone() for n, p in
                     model.named_parameters()}))
    (lk, gk, pk), (lp, gp, pp) = out
    assert abs(lk - lp) <= LOGITS_TOL
    for name in gk:
        scale = max(1.0, gp[name].abs().max().item())
        assert (gk[name] - gp[name]).abs().max().item() <= GRAD_TOL * scale, name
        firm = gp[name].abs() >= 1e-5
        diff = (pk[name] - pp[name]).abs()
        assert diff.max().item() <= 2 * args.lr + 1e-6, name
        assert torch.where(firm, diff, 0.0).max().item() <= (
            1e-6 + 0.01 * args.lr), name


# ---- the Transformer-only model: K4 (attention_dense), K5 (flash_attention)


def _dense_valid(B, S, block, gen):
    """A key mask with padding keys everywhere, one block (block 0: one
    row) without a valid key, and each graph's CLS key valid."""
    valid = torch.rand(B, S, generator=gen) < 0.6
    last = (torch.arange(S) % block == block - 1) if block else (
        torch.arange(S) == S - 1)
    valid |= last
    valid[1, block:2 * block] = False
    if block == 0:
        valid[1] = False
    return valid


def _live(valid, block):
    """The queries that attend a key: those whose graph block (the last may
    be shorter; block 0: the row) holds a valid key."""
    B, S = valid.shape
    if block == 0:
        return valid.any(-1, keepdim=True).expand(B, S)
    live = torch.zeros_like(valid)
    for s in range(0, S, block):
        live[:, s:s + block] = valid[:, s:s + block].any(-1, keepdim=True)
    return live


@pytest.mark.cuda
@pytest.mark.parametrize("S,block,d,H", [
    (98, 49, 256, 4), (99, 33, 256, 4), (257, 0, 256, 4), (384, 0, 128, 4),
    (128, 64, 64, 2)])
def test_attention_dense_kernel_matches_plain(cuda, S, block, d, H):
    """K4 at the Transformer-only model's shapes (rows of two 49-token or
    three 33-token graphs, rows of 257) and hd 32: padding queries in a
    live block attend its keys; a block without a valid key gives zeros."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_plain)

    gen = torch.Generator().manual_seed(S + d)
    B = 7
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    valid = _dense_valid(B, S, block, gen).to(cuda)
    before = attention_dense.launches
    got = attention_dense(qkv, valid, H, block)
    torch.cuda.synchronize()
    assert attention_dense.launches == before + 1
    want = attention_dense_plain(qkv, valid, H, block)
    assert (got - want).abs().max().item() <= K2_TOL
    live = _live(valid, block)
    assert not got[~live].any() and (got[live].abs().sum(-1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("S,d,H", [(1001, 256, 4), (513, 256, 4),
                                   (1001, 128, 4), (600, 256, 2)])
@pytest.mark.parametrize("form", ["key_padding", "seg"])
def test_flash_attention_kernel_matches_plain(cuda, S, d, H, form):
    """K5 at code2's row widths, heads of 64, 32 and 128, with a key-padding
    mask (graph rows of ~125 nodes and a CLS key, one row without a valid
    key) or a segment mask."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention,
                                                  flash_attention_plain,
                                                  key_padding_segs)

    gen = torch.Generator().manual_seed(S + d + H)
    B = 6
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    if form == "key_padding":
        n = torch.randint(9, 300, (B,), generator=gen)
        valid = torch.arange(S)[None, :] < n[:, None]
        valid[:, -1] = True
        valid[2] = False
        segq, segk = key_padding_segs(valid.to(cuda))
    else:
        seg = (torch.arange(S)[None, :] // torch.randint(
            40, 400, (B, 1), generator=gen)).int()
        seg[:, S - 37:] = -1
        seg[3] = -1
        segq = segk = seg.to(cuda)
    before = flash_attention.launches
    got = flash_attention(qkv, segq, segk, H)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(qkv, segq, segk, H)
    assert (got - want).abs().max().item() <= K2_TOL
    live = ((segq[:, :, None] == segk[:, None, :])
            & (segk >= 0)[:, None, :]).any(-1)
    assert not got[~live].any() and (got[live].abs().sum(-1) > 0).all()


@pytest.mark.cuda
def test_k4_k5_refuse_other_widths_and_gradients(cuda):
    """Head widths and row widths the kernels do not compile raise, naming
    those they do, forward and backward; a gradient through either reaches
    qkv through its backward kernels."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_bwd,
                                                  flash_attention,
                                                  flash_attention_bwd,
                                                  key_padding_segs)

    valid = torch.ones(2, 600, dtype=torch.bool, device=cuda)
    segs = key_padding_segs(valid)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        flash_attention(torch.randn(2, 600, 3 * 96, device=cuda), *segs, 2)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        flash_attention_bwd(torch.randn(2, 600, 3 * 96, device=cuda), *segs,
                            2, torch.randn(2, 600, 96, device=cuda))
    with pytest.raises(ValueError, match=r"\(32, 64\)"):
        attention_dense(torch.randn(2, 96, 3 * 256, device=cuda),
                        valid[:, :96], 2, 48)
    with pytest.raises(ValueError, match="384"):
        attention_dense_bwd(torch.randn(2, 400, 3 * 128, device=cuda),
                            valid[:, :400], 2,
                            torch.randn(2, 400, 128, device=cuda))
    qkv = torch.randn(2, 600, 3 * 128, device=cuda, requires_grad=True)
    before = flash_attention_bwd.launches
    flash_attention(qkv, *segs, 2, 0.3, 5).sum().backward()
    assert flash_attention_bwd.launches == before + 1
    assert torch.isfinite(qkv.grad).all() and qkv.grad.abs().sum() > 0
    qkv = torch.randn(2, 96, 3 * 128, device=cuda, requires_grad=True)
    before = attention_dense_bwd.launches
    attention_dense(qkv, valid[:, :96], 2, 48, 0.3, 5).sum().backward()
    assert attention_dense_bwd.launches == before + 1
    assert torch.isfinite(qkv.grad).all() and qkv.grad.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,block,d,H", [
    (98, 49, 256, 4), (99, 33, 256, 4), (257, 0, 256, 4), (384, 0, 256, 4),
    (128, 64, 64, 2), (99, 33, 128, 4), (384, 64, 256, 4),
    (100, 33, 256, 4), (383, 0, 128, 4)])
def test_attention_dense_dropout_and_bwd_kernels_match_plain(cuda, S, block,
                                                             d, H, rate):
    """K4 with dropout and K4-bwd against the plain version (the same mask)
    and its autograd, up to rows of 384 at hd 64 (the wide instance keeps
    the span's dQ in shared memory there), heads of 32, block 64 at rows of
    384 and a partial last block (S % block != 0): a block without a valid
    key (each row 1 has one) gives zero dq, dk and dv; a padding key zero
    dk and dv. Both instances are reached."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense_bwd,
                                                  attention_dense_bwd_plain,
                                                  attention_dense_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats)

    gen = torch.Generator().manual_seed(S + d + int(rate * 10))
    B = 9
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    valid = _dense_valid(B, S, block, gen).to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    seed = 2**31 - 77
    saved = attention_dense_with_stats(qkv, valid, H, block, rate, seed)
    before = attention_dense_bwd.launches
    instances = dict(attention_dense_bwd.instances)
    dqkv = attention_dense_bwd(qkv, valid, H, g, block, rate, seed, saved)
    torch.cuda.synchronize()
    assert attention_dense_bwd.launches == before + 1
    wide = (block or S) > 64
    assert attention_dense_bwd.instances == dict(
        instances, **{"wide" if wide else "short": instances[
            "wide" if wide else "short"] + 1})
    want = attention_dense_plain(qkv, valid, H, block, rate, seed)
    assert (saved[0] - want).abs().max().item() <= K2_TOL
    ref = attention_dense_bwd_plain(qkv, valid, H, g, block, rate, seed)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    dead = ~_live(valid, block)
    assert not dqkv[dead].any()
    assert not dqkv[..., d:][~valid].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,d,H", [(1001, 256, 4), (513, 256, 4),
                                   (1001, 128, 4), (600, 256, 2)])
@pytest.mark.parametrize("form", ["key_padding", "seg"])
def test_flash_attention_dropout_and_bwd_kernels_match_plain(cuda, S, d, H,
                                                             form, rate):
    """K5 with dropout and K5-bwd against the plain version (the same mask,
    drawn with torch) and its autograd, heads of 64, 32 and 128; padding
    keys and queries without a key get exact zeros."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain,
                                                  key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    gen = torch.Generator().manual_seed(S + d + H + int(rate * 10))
    B = 3
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    if form == "key_padding":
        n = torch.randint(9, 300, (B,), generator=gen)
        valid = torch.arange(S)[None, :] < n[:, None]
        valid[:, -1] = True
        valid[2] = False
        segq, segk = key_padding_segs(valid.to(cuda))
    else:
        seg = (torch.arange(S)[None, :] // torch.randint(
            40, 400, (B, 1), generator=gen)).int()
        seg[:, S - 37:] = -1
        seg[2] = -1
        segq = segk = seg.to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    seed = 987654321
    saved = flash_attention_with_stats(qkv, segq, segk, H, rate, seed)
    dqkv = flash_attention_bwd(qkv, segq, segk, H, g, rate, seed, saved)
    torch.cuda.synchronize()
    want = flash_attention_plain(qkv, segq, segk, H, rate, seed)
    assert (saved[0] - want).abs().max().item() <= K2_TOL
    ref = flash_attention_bwd_plain(qkv, segq, segk, H, g, rate, seed)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    live = ((segq[:, :, None] == segk[:, None, :])
            & (segk >= 0)[:, None, :]).any(-1)
    assert not dqkv[..., :d][~live].any()
    assert not dqkv[..., d:][segk < 0].any()


def _stats_ref(qkv, meet, H):
    """The plain statistics of each (row, query, head) in float64: the max
    scaled score over the keys the query attends (``meet`` bool [B, S, S]),
    the sum of exp(s - max) over them, and whether it has a key."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    hd = d // H
    q, k, _ = (t.double().reshape(B, S, H, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) / hd ** 0.5
    s = s.masked_fill(~meet[:, None], float("-inf"))
    mx = s.amax(-1)
    has = meet.any(-1)[:, None].expand_as(mx)
    lsum = torch.exp(s - torch.where(has, mx, 0.0)[..., None]).sum(-1)
    return mx.transpose(1, 2), lsum.transpose(1, 2), has.transpose(1, 2)


def _check_stats(m, l, qkv, meet, H):
    """m and l as attention_fwd.cuh defines them: the max scaled score and
    the sum of the undropped exp(s - m); m = -inf and l = 0 exactly for a
    query without a key."""
    mx, lsum, has = _stats_ref(qkv, meet, H)
    assert (m.double()[has] - mx[has]).abs().max().item() <= K2_TOL
    assert ((l.double()[has] - lsum[has]).abs()
            <= K2_TOL * lsum[has].clamp_min(1.0)).all()
    assert (m[~has] == float("-inf")).all() and not l[~has].any()


def _k4_meet(valid, block):
    S = valid.shape[1]
    grp = torch.arange(S, device=valid.device) // (block or S)
    return valid[:, None, :] & (grp[:, None] == grp[None, :])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S,block", [(98, 49), (99, 33), (100, 33),
                                     (257, 0), (384, 0)])
def test_attention_dense_forward_instances_and_stats(cuda, S, block, hd,
                                                     rate):
    """K4's forward at both instances (the tile one for spans of up to 128
    tokens, a partial last block among them; the long one for rows of 257
    and 384 at block 0) against the plain version, with and without
    dropout: m and l against the plain scores, K4-bwd from them against
    autograd, a block without a valid key exactly 0, the launch counted
    under its instance (serving and training)."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_bwd,
                                                  attention_dense_bwd_plain,
                                                  attention_dense_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats, dense_fwd_geometry)

    H, B, seed = 4, 7, 2**31 - 99
    d = H * hd
    gen = torch.Generator().manual_seed(S + hd + block + int(rate * 10))
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    valid = _dense_valid(B, S, block, gen).to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    instance = dense_fwd_geometry(B, S, block, hd, H, True, rate).instance
    assert instance == ("tile" if (block or S) <= 128 else "long")
    before = attention_dense.launches
    counts = dict(attention_dense.instances)
    served = attention_dense(qkv, valid, H, block, rate, seed)
    out, m, l = attention_dense_with_stats(qkv, valid, H, block, rate, seed)
    dqkv = attention_dense_bwd(qkv, valid, H, g, block, rate, seed,
                               (out, m, l))
    torch.cuda.synchronize()
    assert attention_dense.launches == before + 2
    assert attention_dense.instances == dict(
        counts, **{instance: counts[instance] + 2})
    assert torch.equal(served, out)
    want = attention_dense_plain(qkv, valid, H, block, rate, seed)
    assert (out - want).abs().max().item() <= K2_TOL
    _check_stats(m, l, qkv, _k4_meet(valid, block), H)
    ref = attention_dense_bwd_plain(qkv, valid, H, g, block, rate, seed)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    dead = ~_live(valid, block)
    assert not out[dead].any() and not dqkv[dead].any()
    if rate == 0.0:
        assert (out[~dead].abs().sum(-1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [513, 1001])
@pytest.mark.parametrize("form", ["prefix_cls", "permuted"])
def test_flash_attention_long_forward_stats(cuda, form, S, hd, rate):
    """K5's long forward at code2's row widths and heads of 32, 64 and 128,
    key-padding (a row without a valid key) and segment tags: the output
    against the plain version (queries without a key exactly 0), m and l
    against the plain scores, K5-bwd from them against autograd."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    B, H, seed = 3, 2, 55
    d = H * hd
    gen = torch.Generator().manual_seed(S + hd + len(form) + int(rate * 10))
    segq, segk = (t.to(cuda) for t in _k5_tags(form, B, S, gen))
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    before = flash_attention.launches
    out, m, l = flash_attention_with_stats(qkv, segq, segk, H, rate, seed)
    dqkv = flash_attention_bwd(qkv, segq, segk, H, g, rate, seed, (out, m, l))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(qkv, segq, segk, H, rate, seed)
    assert (out - want).abs().max().item() <= K2_TOL
    meet = ((segq[:, :, None] == segk[:, None, :])
            & (segk >= 0)[:, None, :])
    _check_stats(m, l, qkv, meet, H)
    live = meet.any(-1)
    assert not out[~live].any()
    ref = flash_attention_bwd_plain(qkv, segq, segk, H, g, rate, seed)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    assert not dqkv[..., :d][~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,block,hd", [(300, 150, 64), (400, 130, 32),
                                        (1001, 0, 64), (513, 0, 128),
                                        (257, 0, 128)])
def test_attention_smalls_long_forward(cuda, S, block, hd, rate):
    """K9's long forward: graph blocks wider than tile_max (150; 130 with a
    partial last block), code2's rows of 1001 and 513, and rows of 257 at
    hd 128 (above its 112): the output against the plain version (a block
    without a valid key exactly 0), m and l against the plain scores, K9-bwd
    from them against autograd; the launch counted as the long instance."""
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls,
                                                  attention_smalls_bwd,
                                                  attention_smalls_bwd_plain,
                                                  attention_smalls_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats)

    H, seed = 2, 31
    d = H * hd
    gen = torch.Generator().manual_seed(S + block + hd + int(rate * 10))
    qkv, valid = _smalls_case(S, block, d, gen, cuda, B=3)
    g = torch.randn(3, S, d, generator=gen).to(cuda)
    counts = dict(attention_smalls.instances)
    out, m, l = attention_smalls_with_stats(qkv, valid, H, block, rate, seed)
    dqkv = attention_smalls_bwd(qkv, valid, H, g, block, rate, seed,
                                (out, m, l))
    torch.cuda.synchronize()
    assert attention_smalls.instances == dict(counts,
                                              long=counts["long"] + 1)
    want = attention_smalls_plain(qkv, valid, H, block, rate, seed)
    assert (out - want).abs().max().item() <= K2_TOL
    _check_stats(m, l, qkv, _k4_meet(valid, block), H)
    ref = attention_smalls_bwd_plain(qkv, valid, H, g, block, rate, seed)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    dead = ~_live(valid, block)
    assert not out[dead].any() and not dqkv[dead].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,block", [(37, 99, 33), (20, 98, 49)])
def test_transformer_layer_forward_through_the_tile_instance(cuda, B, S,
                                                             block):
    """K10's layer launches K4's forward at its tile instance (rows of 3 x
    33 and 2 x 49 tokens, d 256, 4 heads, stride H + 3 for its seeds): the
    layer with dropout against the plain one; K4's own count does not move
    (K10 counts its chain)."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  transformer_layer,
                                                  transformer_layer_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        dense_fwd_geometry)

    d, ff, H = 256, 512, 4
    assert dense_fwd_geometry(B, S, block, d // H, H, True,
                              0.3).instance == "tile"
    gen = torch.Generator().manual_seed(B + S)
    x, valid, params = _layer_case(B, S, d, ff, block, gen, cuda)
    before = attention_dense.launches, transformer_layer.launches
    got = transformer_layer(x, valid, params, H, block, 0.3, 17)
    torch.cuda.synchronize()
    assert (attention_dense.launches, transformer_layer.launches) == (
        before[0], before[1] + 1)
    want = transformer_layer_plain(x, valid, params, H, block, 0.3, 17)
    assert (got - want).abs().max().item() <= K2_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2100, 256), (7, 513, 512), (3, 128)])
def test_byte_dropout_kernel_matches_plain(cuda, shape):
    """K11 forward and backward (the kernel on the cotangent) against the
    plain version: the same mask, to the bit."""
    from graphtrans_tpu_torch.ops.kernels import (byte_dropout,
                                                  byte_dropout_plain)

    gen = torch.Generator().manual_seed(len(shape))
    x = torch.randn(*shape, generator=gen).to(cuda).requires_grad_()
    g = torch.randn(*shape, generator=gen).to(cuda)
    before = byte_dropout.launches
    got = byte_dropout(x, 2**31 - 3, 77)
    got.backward(g)
    torch.cuda.synchronize()
    assert byte_dropout.launches == before + 2
    xr = x.detach().requires_grad_()
    want = byte_dropout_plain(xr, 2**31 - 3, 77)
    want.backward(g)
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(x.grad, xr.grad)


def _tf_train_model(kind, num_tasks, cuda):
    import types

    from graphtrans_tpu_torch.models.transformer import build_transformer
    from graphtrans_tpu_torch.nn.init import init_weights

    args = argparse.Namespace(
        model_type="transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, d_model=256, gnn_emb_dim=256, nhead=4,
        dim_feedforward=512, num_encoder_layers=2, max_input_len=1000,
        transformer_norm_input=False, transformer_dropout=0.3,
        dataset="ogbg-code2" if kind == "code2" else "ogbg-molpcba")
    sizes = types.SimpleNamespace(num_nodetypes=20, num_nodeattributes=100,
                                  max_seq_len=5)
    model = build_transformer(args, num_tasks, cuda,
                              sizes if kind == "code2" else None)
    return init_weights(model, torch.Generator().manual_seed(0)).train()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mol", "code2", "mol-packed_layer",
                                  "mol-smalls"])
def test_transformer_backward_through_kernels_reaches_every_leaf(cuda, kind):
    """loss.backward() of the Transformer-only model (2 layers, d 256,
    attention dropout 0.3) through K4 and K4-bwd (molecules, rows of two
    graphs), K5 and K5-bwd (code2 rows past 512), K10 and K10-bwd (the
    molecules under ``packed_layer``: every product, LayerNorm and dropout
    of the layer) or K9 and K9-bwd (the molecules under ``smalls``) gives
    every parameter a gradient equal to the plain route's, on the same
    masks."""
    from graphtrans_tpu_torch.data.synthetic import make_code_dataset
    from graphtrans_tpu_torch.data.vocab import (augment_edge,
                                                 encode_seq_to_arr,
                                                 get_vocab_mapping)
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.nn.transformer import set_attn_backend
    from graphtrans_tpu_torch.ops.kernels import (attention_dense_bwd,
                                                  attention_smalls_bwd,
                                                  flash_attention_bwd,
                                                  transformer_layer_bwd)
    from graphtrans_tpu_torch.train.losses import (binary_multitask_loss,
                                                   seq_token_loss)

    kind, backend = (kind.split("-") + ["auto"])[:2]
    if kind == "mol":
        num_tasks = 128
        graphs = make_mol_dataset(num_graphs=30, num_tasks=num_tasks,
                                  min_nodes=3, max_nodes=40, seed=3)
        kw = dict(num_tasks=num_tasks, y_dtype="float32", dense_cap=48)
        wrapper, loss_fn, caps = (attention_dense_bwd, binary_multitask_loss,
                                  (32, 2048, 8192))
    else:
        raw = make_code_dataset(num_graphs=6, vocab_size=50, seq_len_max=6,
                                min_nodes=100, max_nodes=700, seed=4)
        v2i, _ = get_vocab_mapping([g["y_seq"] for g in raw], 50)
        graphs = [dict(augment_edge(g),
                       y_arr=encode_seq_to_arr(g["y_seq"], v2i, 5))
                  for g in raw]
        num_tasks = len(v2i)
        kw = dict(num_tasks=num_tasks, y_dtype="int32", max_seq_len=5,
                  max_input_len=1000, dense_cap=704)
        wrapper, loss_fn, caps = (flash_attention_bwd, seq_token_loss,
                                  (8, 8192, 32768))
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    b = collate(graphs, *caps, **kw).to(cuda)
    model = set_attn_backend(_tf_train_model(kind, num_tasks, cuda), backend)
    wrapper = {"packed_layer": transformer_layer_bwd,
               "smalls": attention_smalls_bwd}.get(backend, wrapper)
    grads = []
    for kernels in (True, False):
        set_kernels(model, kernels)
        model.zero_grad(set_to_none=True)
        before = wrapper.launches
        loss_fn(model(b, Generators.seeded(5, cuda)), b).backward()
        if kernels:
            assert wrapper.launches == before + 2            # 2 layers
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        ref = grads[1][name]
        assert g is not None and g.abs().sum().item() > 0, name
        assert (g - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("config,split,batch_size,kernel", [
    ("configs/molpcba/transformer/pooling=cls.yml", "valid", 256,
     "attention_dense"),
    ("configs/code2/transformer/pooling=cls.yml", "valid", 24,
     "flash_attention"),
    ("configs/code2/transformer/pooling=cls.yml", "test", 24, None)])
def test_transformer_predict_launches(cuda, tmp_path, config, split,
                                      batch_size, kernel):
    """A predict batch of each Transformer-only yml at full width: K4 on
    the molecules' packed rows, K5 on code2's 513-token rows, neither on
    code2's test rows of 449 (the plain softmax), five layers each."""
    import pathlib

    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.ops import kernels

    repo = pathlib.Path(__file__).resolve().parents[1]
    kernels.reset_launches()
    res = predict.main(["--configs", str(repo / config), "--data_root",
                        str(repo / "data_snapshots"), "--split", split,
                        "--batch_size", str(batch_size), "--out",
                        str(tmp_path / "p.jsonl")])
    assert res["records"] == 24 and res["batches"] <= 2
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    assert launches == ({kernel: 5 * res["batches"]} if kernel else {})


def _smalls_case(S, block, d, gen, cuda, B=6):
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    valid = _dense_valid(B, S, block, gen)
    return qkv, valid.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,block,d,H", [
    (33, 0, 256, 4), (49, 0, 256, 4), (99, 33, 256, 4), (98, 49, 128, 4),
    (1001, 0, 256, 4), (520, 0, 512, 4), (128, 0, 256, 4),
    (129, 0, 256, 4), (128, 0, 512, 4), (129, 0, 512, 4),
    (112, 0, 512, 4), (113, 0, 512, 4), (384, 64, 256, 4),
    (100, 33, 128, 4)])
def test_attention_smalls_kernels_match_plain(cuda, S, block, d, H, rate):
    """K9 (forward, with dropout) and K9-bwd against the plain version (the
    same mask) and its autograd, at the molecules' rows of 33 and 49
    (smalls), packed rows of three 33-token graphs (packed_smalls), code2's
    rows of 1001, heads of 32, 64 and 128, both sides of the tile
    instance's threshold (128 tokens; 112 at hd 128), block 64 and a
    partial last block: queries without a key give zeros, and their
    gradients and a padding key's dk and dv are zero. K9-bwd also runs
    through autograd on the forward's m and l."""
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        fwd_geometry)
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls,
                                                  attention_smalls_bwd,
                                                  attention_smalls_bwd_plain,
                                                  attention_smalls_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats)

    gen = torch.Generator().manual_seed(S + d + block)
    qkv, valid = _smalls_case(S, block, d, gen, cuda)
    g = torch.randn(*qkv.shape[:2], d, generator=gen).to(cuda)
    before = attention_smalls.launches, attention_smalls_bwd.launches
    instance = fwd_geometry(len(qkv), S, block, d // H, H, True,
                            rate).instance
    count = attention_smalls.instances[instance]
    got = attention_smalls(qkv, valid, H, block, rate, 77)
    saved = attention_smalls_with_stats(qkv, valid, H, block, rate, 77)
    dqkv = attention_smalls_bwd(qkv, valid, H, g, block, rate, 77, saved)
    leaf = qkv.clone().requires_grad_()
    attention_smalls(leaf, valid, H, block, rate, 77).backward(g)
    torch.cuda.synchronize()
    assert (attention_smalls.launches, attention_smalls_bwd.launches) == (
        before[0] + 3, before[1] + 2)
    assert attention_smalls.instances[instance] == count + 3
    assert torch.equal(leaf.grad, dqkv)
    want = attention_smalls_plain(qkv, valid, H, block, rate, 77)
    assert (got - want).abs().max().item() <= K2_TOL
    assert torch.equal(got, saved[0])
    ref = attention_smalls_bwd_plain(qkv, valid, H, g, block, rate, 77)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    dead = ~_live(valid, block)
    assert not got[dead].any() and not dqkv[dead].any()
    assert not dqkv[..., d:][~valid].any()
    if rate == 0.0:
        assert (got[~dead].abs().sum(-1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,block", [(33, 0), (49, 0), (99, 33), (257, 0),
                                     (513, 0), (1001, 0)])
def test_attention_smalls_bwd_instances_match_autograd(cuda, S, block, hd,
                                                       rate):
    """K9-bwd at every instance (short at rows of 33 and 49 and packed
    block 33; wide at 257 for hd 32 and 64, long there at hd 128; long at
    513 and 1001) against autograd through the plain version: a block
    without a valid key and padding keys get exact zeros, two calls agree
    to the bit, and the launch is counted under its instance."""
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls_bwd,
                                                  attention_smalls_bwd_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_smalls import (
        attention_smalls_with_stats, bwd_geometry)

    H = 2
    d = H * hd
    gen = torch.Generator().manual_seed(S + hd + block + int(rate * 10))
    qkv, valid = _smalls_case(S, block, d, gen, cuda, B=3)
    g = torch.randn(*qkv.shape[:2], d, generator=gen).to(cuda)
    saved = attention_smalls_with_stats(qkv, valid, H, block, rate, 99)
    instance = bwd_geometry(3, S, block, hd, H).instance
    assert instance == ("short" if (block or S) <= 64 else
                        "wide" if S <= 384 and hd <= 64 else "long")
    before = attention_smalls_bwd.launches
    counts = dict(attention_smalls_bwd.instances)
    dqkv = attention_smalls_bwd(qkv, valid, H, g, block, rate, 99, saved)
    again = attention_smalls_bwd(qkv, valid, H, g, block, rate, 99, saved)
    torch.cuda.synchronize()
    assert attention_smalls_bwd.launches == before + 2
    assert attention_smalls_bwd.instances == dict(
        counts, **{instance: counts[instance] + 2})
    assert torch.equal(dqkv, again)
    ref = attention_smalls_bwd_plain(qkv, valid, H, g, block, rate, 99)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    assert not dqkv[~_live(valid, block)].any()
    assert not dqkv[..., d:][~valid].any()


def _k5_tags(form, B, S, gen):
    """(segq, segk) int32 [B, S] on the CPU: a key-padding prefix plus CLS (row 2 without a valid key);
    contiguous segments whose ids are permuted, with padding tokens among
    them; or a segment id per token drawn at random (-1: padding)."""
    from graphtrans_tpu_torch.ops.kernels import key_padding_segs

    if form == "prefix_cls":
        n = torch.randint(9, 300, (B,), generator=gen)
        valid = torch.arange(S)[None, :] < n[:, None]
        valid[:, -1] = True
        valid[2] = False
        return key_padding_segs(valid)
    if form == "permuted":
        width = torch.randint(20, 200, (B, 1), generator=gen)
        seg = torch.arange(S)[None, :] // width
        perm = torch.randperm(S, generator=gen)
        seg = perm[seg]
        seg[torch.rand(B, S, generator=gen) < 0.2] = -1
    else:
        seg = torch.randint(-1, 3, (B, S), generator=gen)
    seg[2] = -1
    return seg.int(), seg.int()


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S", [513, 1001])
@pytest.mark.parametrize("form", ["prefix_cls", "permuted", "scattered"])
def test_flash_attention_bwd_long_rows_match_autograd(cuda, S, form, rate):
    """K5-bwd on the long-row backward at code2's row widths, hd 64: a
    key-padding prefix plus CLS, segments that are not a prefix (permuted
    ids, padding among them) and a segment id per token; a row without a
    valid key. Within 5e-4 of max(1, max|ref|) of autograd through the
    plain version; queries without a key and padding keys get exact
    zeros; two calls agree to the bit."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention_bwd,
                                                  flash_attention_bwd_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    B, H, d = 3, 4, 256
    gen = torch.Generator().manual_seed(S + len(form) + int(rate * 10))
    segq, segk = (t.to(cuda) for t in _k5_tags(form, B, S, gen))
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    saved = flash_attention_with_stats(qkv, segq, segk, H, rate, 4321)
    before = flash_attention_bwd.launches
    dqkv = flash_attention_bwd(qkv, segq, segk, H, g, rate, 4321, saved)
    again = flash_attention_bwd(qkv, segq, segk, H, g, rate, 4321, saved)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    assert torch.equal(dqkv, again)
    ref = flash_attention_bwd_plain(qkv, segq, segk, H, g, rate, 4321)
    assert (dqkv - ref).abs().max().item() <= GRAD_TOL * max(
        1.0, ref.abs().max().item())
    live = ((segq[:, :, None] == segk[:, None, :])
            & (segk >= 0)[:, None, :]).any(-1)
    assert not dqkv[..., :d][~live].any()
    assert not dqkv[..., d:][segk < 0].any()
    if rate == 0.0:
        assert (dqkv[..., :d][live].abs().sum(-1) > 0).all()


def _layer_case(B, S, d, ff, block, gen, cuda):
    x = torch.randn(B, S, d, generator=gen)
    valid = _dense_valid(B, S, block, gen)
    shapes = ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (ff, d),
              (ff,), (d, ff), (d,), (d,), (d,))
    params = [torch.randn(*s, generator=gen) / (s[-1] ** 0.5 if len(s) == 2
                                                else 4.0) for s in shapes]
    params[4] += 1.0                                    # LN scales near 1
    params[10] += 1.0
    return (x.to(cuda), valid.to(cuda), [p.to(cuda) for p in params])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,S,d,ff,H,block", [
    (37, 99, 256, 512, 4, 33), (20, 98, 256, 512, 4, 49),
    (11, 96, 128, 256, 2, 24)])
def test_transformer_layer_kernels_match_plain(cuda, B, S, d, ff, H, block,
                                               rate):
    """K10 (forward, with its four dropouts) and K10-bwd against the plain
    layer (the same masks) and its autograd: the output, dx and all twelve
    parameter gradients; B not a multiple of the reference's 8-row tile.
    The backward is held to the plain one on the kernel's relu decisions
    (``relu_side``: a pre-activation within f32 rounding of 0 may take
    either side; at 20 x 98 x 512 one did, and moved a row of dx by 0.02).
    Two runs of the backward give the same bits (no atomics)."""
    from graphtrans_tpu_torch.ops.kernels import (
        transformer_layer, transformer_layer_bwd, transformer_layer_bwd_plain,
        transformer_layer_plain)
    from graphtrans_tpu_torch.ops.kernels.transformer_layer import (
        relu_side, transformer_layer_saved)

    gen = torch.Generator().manual_seed(B + S + d)
    x, valid, params = _layer_case(B, S, d, ff, block, gen, cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    before = transformer_layer.launches, transformer_layer_bwd.launches
    got = transformer_layer(x, valid, params, H, block, rate, 91)
    y, saved = transformer_layer_saved(x, valid, params, H, block, rate, 91)
    grads = transformer_layer_bwd(x, valid, params, H, block, g, rate, 91,
                                  saved)
    again = transformer_layer_bwd(x, valid, params, H, block, g, rate, 91,
                                  saved)
    torch.cuda.synchronize()
    assert (transformer_layer.launches, transformer_layer_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    want = transformer_layer_plain(x, valid, params, H, block, rate, 91)
    assert (got - want).abs().max().item() <= K2_TOL
    assert torch.equal(got, y)
    refs = transformer_layer_bwd_plain(x, valid, params, H, block, g, rate,
                                       91, relu_side(saved, (B, S, ff)))
    for i, (mine, ref) in enumerate(zip(grads, refs)):
        assert mine.shape == ref.shape, i
        assert (mine - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item()), i
        assert torch.equal(mine, again[i]), i


def _epilogue_ref(epi, acc, bias, res, keep, inv_keep):
    """layer_gemm's epilogue (csrc/transformer_layer.cu:epilogue) applied to
    a product ``acc``; ``keep`` the drop mask of its elements (None: no
    dropout)."""
    tl = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                                 "transformer_layer")
    drop = (lambda t: t) if keep is None else (
        lambda t: torch.where(keep, t * inv_keep, torch.zeros_like(t)))
    if epi == tl.EPI_BIAS:
        return acc + bias
    if epi == tl.EPI_BIAS_DROP_RES:
        return res + drop(acc + bias)
    if epi == tl.EPI_BIAS_RELU_DROP:
        return drop(torch.relu(acc + bias))
    if epi == tl.EPI_RES:
        return acc + res
    if epi == tl.EPI_DRELU:
        return torch.where(res > 0, acc * (1.0 if keep is None else inv_keep),
                           torch.zeros_like(acc))
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("epi", range(6))
@pytest.mark.parametrize("layout", [0, 1, 2])
def test_layer_gemm_matches_a_float64_product(cuda, layout, epi, rate):
    """layer_gemm (3xTF32 on the tensor cores) at each layout and epilogue,
    with M, N and K ragged against its 128 x 64 x 32 tiles, against the
    float64 product of the same operands with the epilogue in float64: its
    error within 4x the error of torch's float32 product (TF32 off) on the
    same operands (TF32 off, torch's default), plus one float32 rounding
    of the largest value. Two runs give the same bits."""
    tl = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                                 "transformer_layer")
    assert not torch.backends.cuda.matmul.allow_tf32   # torch's default
    gen = torch.Generator().manual_seed(100 * layout + 10 * epi
                                        + int(rate * 10))
    S, H = 7, 4                                   # rows r*S + t, 4 heads
    M, N, K = (196, 200, 1043) if layout == tl.TN else (1043, 196, 100)
    a = torch.randn(*((K, M) if layout == tl.TN else (M, K)), generator=gen)
    b = torch.randn(*((N, K) if layout == tl.NT else (K, N)), generator=gen)
    bias = torch.randn(N, generator=gen)
    res = torch.randn(M, N, generator=gen)
    A = a.T if layout == tl.TN else a
    B = b.T if layout == tl.NT else b
    seed = 12345
    keep = None
    if rate > 0.0 and epi in (tl.EPI_BIAS_DROP_RES, tl.EPI_BIAS_RELU_DROP,
                              tl.EPI_DRELU):
        keep = tl.layer_keep(M // S, S, N, H, rate, seed, 1, "cpu").view(M, N)
    drop = (tl._drop_args(rate, seed, 1, H, S) if rate > 0.0
            else tl._NO_DROP)
    ref = _epilogue_ref(epi, A.double() @ B.double(), bias.double(),
                        res.double(), keep, 1.0 / (1.0 - rate))
    lib = tl._load()
    args = [t.to(cuda) for t in (a, b, bias, res)]
    got = tl._gemm(lib, args[0], args[1], M, N, K, layout, epi, args[2],
                   args[3], drop)
    again = tl._gemm(lib, args[0], args[1], M, N, K, layout, epi, args[2],
                     args[3], drop)
    plain = _epilogue_ref(epi, (A.to(cuda) @ B.to(cuda)), args[2], args[3],
                          None if keep is None else keep.to(cuda),
                          1.0 / (1.0 - rate))
    torch.cuda.synchronize()
    err = (got.cpu().double() - ref).abs().max().item()
    err_f32 = (plain.cpu().double() - ref).abs().max().item()
    assert err <= 4 * err_f32 + 2**-24 * ref.abs().max().item(), (err,
                                                                  err_f32)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 44])
def test_layer_gemm_weight_grad_splits(cuda, splits):
    """The weight-gradient layout (A [K, M] transposed, K the batch's rows)
    split over K into partials: each partial and their in-order sum
    (layer_sum) against float64; splits whose K range is empty write
    zeros."""
    tl = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                                 "transformer_layer")
    gen = torch.Generator().manual_seed(splits)
    M, N, K = 256, 132, 2050
    g, x = (torch.randn(K, M, generator=gen), torch.randn(K, N, generator=gen))
    lib = tl._load()
    part = tl._gemm(lib, g.to(cuda), x.to(cuda), M, N, K, tl.TN,
                    splits=splits)
    torch.cuda.synchronize()
    _, _, _, kchunk, _ = tl.gemm_geometry(M, N, K, tl.TN, splits)
    part = part.view(splits, M, N).cpu().double()
    for z in range(splits):
        k0, k1 = min(K, z * kchunk), min(K, (z + 1) * kchunk)
        want = g[k0:k1].double().T @ x[k0:k1].double()
        assert (part[z] - want).abs().max().item() <= 1e-5 * max(
            1.0, want.abs().max().item()), z
    want = g.double().T @ x.double()
    assert (part.sum(0) - want).abs().max().item() <= 1e-5 * want.abs().max(
        ).item()


@pytest.mark.cuda
def test_layer_gemm_refuses_misaligned_rows(cuda):
    """A row length that breaks 16-byte cp.async copies (K % 4 in layouts 0
    and 1, M % 4 in layout 2, N % 4 in all) is refused, not read past."""
    tl = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                                 "transformer_layer")
    lib = tl._load()
    x = torch.randn(64, 99, device=cuda)
    w = torch.randn(128, 99, device=cuda)
    with pytest.raises(RuntimeError, match="layer_gemm"):
        tl._gemm(lib, x, w, 64, 128, 99, tl.NT)
    with pytest.raises(RuntimeError, match="layer_gemm"):
        tl._gemm(lib, torch.randn(99, 66, device=cuda),
                 torch.randn(99, 64, device=cuda), 66, 64, 99, tl.TN)
    with pytest.raises(RuntimeError, match="layer_gemm"):
        tl._gemm(lib, torch.randn(64, 96, device=cuda),
                 torch.randn(96, 98, device=cuda), 64, 98, 96, tl.NN)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k4_bwd_and_k10_bwd_on_the_same_rows(cuda, rate):
    """K4-bwd and K10-bwd on the same packed rows (37 x 99, block 33, d 256,
    4 heads): K4-bwd draws K4's mask (seeds H a tile) and, as K10-bwd runs
    it, K10's (seeds H + 3 a tile); each against autograd through its plain
    version on the same mask."""
    from graphtrans_tpu_torch.ops.kernels import (
        attention_dense_bwd, attention_dense_bwd_plain, attention_dense_plain,
        transformer_layer_bwd, transformer_layer_bwd_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats, dense_bwd_launch, dense_fwd_launch,
        keep_drop, keep_mask)
    from graphtrans_tpu_torch.ops.kernels.transformer_layer import (
        STREAMS, relu_side, transformer_layer_saved)

    B, S, d, ff, H, block, seed = 37, 99, 256, 512, 4, 33, 2**31 - 5
    gen = torch.Generator().manual_seed(4099)
    x, valid, params = _layer_case(B, S, d, ff, block, gen, cuda)
    qkv = torch.randn(B, S, 3 * d, generator=gen).to(cuda)
    g = torch.randn(B, S, d, generator=gen).to(cuda)
    tol = lambda ref: GRAD_TOL * max(1.0, ref.abs().max().item())

    saved = attention_dense_with_stats(qkv, valid, H, block, rate, seed)
    dqkv = attention_dense_bwd(qkv, valid, H, g, block, rate, seed, saved)
    ref = attention_dense_bwd_plain(qkv, valid, H, g, block, rate, seed)
    assert (dqkv - ref).abs().max().item() <= tol(ref)

    stride = H + STREAMS                      # K10's seeds a tile
    saved = dense_fwd_launch(qkv, valid, H, block, rate, seed, True, stride)
    dqkv = dense_bwd_launch(qkv, valid, H, g, block, rate, seed, saved,
                            stride)
    drop = (keep_drop(keep_mask(B, S, H, rate, seed, cuda, stride), rate)
            if rate > 0.0 else None)
    leaf = qkv.clone().requires_grad_()
    out = attention_dense_plain(leaf, valid, H, block, drop=drop)
    ref = torch.autograd.grad(out, leaf, g)[0]
    assert (saved[0] - out.detach()).abs().max().item() <= K2_TOL
    assert (dqkv - ref).abs().max().item() <= tol(ref)

    _, kept = transformer_layer_saved(x, valid, params, H, block, rate, seed)
    grads = transformer_layer_bwd(x, valid, params, H, block, g, rate, seed,
                                  kept)
    refs = transformer_layer_bwd_plain(x, valid, params, H, block, g, rate,
                                       seed, relu_side(kept, (B, S, ff)))
    torch.cuda.synchronize()
    for i, (mine, ref) in enumerate(zip(grads, refs)):
        assert (mine - ref).abs().max().item() <= tol(ref), i


@pytest.mark.cuda
def test_k9_k10_refuse_other_shapes_and_carry_gradients(cuda):
    """K10 refuses rows wider than 128, d % 128 != 0 and block 0; K9 a head
    width it does not compile; autograd reaches x and every parameter
    through K10-bwd and qkv through K9-bwd."""
    from graphtrans_tpu_torch.ops.kernels import (attention_smalls,
                                                  attention_smalls_bwd,
                                                  transformer_layer,
                                                  transformer_layer_bwd)

    gen = torch.Generator().manual_seed(3)
    x, valid, params = _layer_case(4, 99, 128, 256, 33, gen, cuda)
    with pytest.raises(ValueError, match="at most 128"):
        transformer_layer(torch.randn(2, 132, 128, device=cuda),
                          valid[:2, :1].expand(2, 132).contiguous(), params,
                          2, 33)
    with pytest.raises(ValueError, match="block > 0"):
        transformer_layer(x, valid, params, 2, 0)
    with pytest.raises(ValueError, match=r"\(32, 64, 128\)"):
        attention_smalls(torch.randn(2, 40, 3 * 96, device=cuda),
                         valid[:2, :40].contiguous(), 2)
    leaves = [t.requires_grad_() for t in (x, *params)]
    before = transformer_layer_bwd.launches
    transformer_layer(leaves[0], valid, leaves[1:], 2, 33, 0.3,
                      5).sum().backward()
    assert transformer_layer_bwd.launches == before + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in leaves)
    qkv = torch.randn(2, 40, 3 * 128, device=cuda, requires_grad=True)
    before = attention_smalls_bwd.launches
    attention_smalls(qkv, valid[:2, :40].contiguous(), 2, 0, 0.3,
                     5).sum().backward()
    assert attention_smalls_bwd.launches == before + 1
    assert torch.isfinite(qkv.grad).all() and qkv.grad.abs().sum() > 0


# ---- K6: the strided sum with precomputed edge embeddings (NCI1) ----------


def _k6_case(G, d, with_w, cuda, seed=0):
    """K6's arguments on a strided batch of G - 1 synthetic TU graphs and
    one padding slot (stride 48, 160 edge slots), random x, emb and w."""
    from graphtrans_tpu_torch.data.synthetic import make_tu_dataset

    graphs = [dict(g, _id=i) for i, g in enumerate(
        make_tu_dataset(num_graphs=G - 1, seed=seed))]
    b = collate(graphs, G, G * 48, max(16384, 80 * G), num_tasks=2,
                y_dtype="int32", node_stride=48,
                dense_edge_cap=160).to(cuda)
    gen = torch.Generator().manual_seed(G + d)
    x = torch.randn(G, 48, d, generator=gen).to(cuda)
    x = x.masked_fill(~b.node_mask.reshape(G, 48, 1), 0.0)
    emb = torch.randn(G, 160, d, generator=gen).to(cuda)
    w = torch.randn(G, 160, generator=gen).to(cuda) if with_w else None
    return (x, b.edge_src_dense, b.edge_dst_dense, b.edge_mask_dense, emb, w)


@pytest.mark.cuda
@pytest.mark.parametrize("G,d", [(128, 128), (37, 128), (37, 200)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_dense_agg_kernels_match_plain(cuda, G, d, relu, with_w):
    """K6 and K6-bwd against the plain version and its autograd, at G 128
    and at a G that is not a multiple of 16, one channel slice and two."""
    from graphtrans_tpu_torch.ops.kernels import (dense_agg, dense_agg_bwd,
                                                  dense_agg_bwd_plain,
                                                  dense_agg_plain)

    args = _k6_case(G, d, with_w, cuda)
    f0, b0 = dense_agg.launches, dense_agg_bwd.launches
    got = dense_agg(*args, relu=relu)
    gout = torch.randn(got.shape, generator=torch.Generator().manual_seed(
        9)).to(cuda)
    grads = dense_agg_bwd(*args, gout, relu=relu)
    torch.cuda.synchronize()
    assert (dense_agg.launches, dense_agg_bwd.launches) == (f0 + 1, b0 + 1)
    assert (got - dense_agg_plain(*args, relu=relu)).abs().max().item() \
        <= K1_TOL
    want = dense_agg_bwd_plain(*args, gout, relu=relu)
    for name, g, w in zip(("dx", "demb", "dw"), grads, want):
        assert (g is None) == (w is None), name
        if g is not None:
            err = (g - w).abs().max().item()
            assert err <= GRAD_TOL * max(1.0, w.abs().max().item()), name
    assert not grads[1][~args[3]].any()          # masked slots: demb 0


@pytest.mark.cuda
def test_dense_agg_autograd_and_refusals(cuda):
    """The CUDA wrapper is an autograd Function whose backward is K6-bwd,
    and it raises on what the kernel does not take (edge lists past its
    shared memory: 20000 slots a graph)."""
    from graphtrans_tpu_torch.ops.kernels import (dense_agg, dense_agg_bwd,
                                                  dense_agg_plain)

    x, src, dst, emask, emb, w = _k6_case(37, 128, True, cuda)
    leaves = [t.clone().requires_grad_() for t in (x, emb, w)]
    b0 = dense_agg_bwd.launches
    dense_agg(leaves[0], src, dst, emask, leaves[1], leaves[2]).square() \
        .sum().backward()
    assert dense_agg_bwd.launches == b0 + 1
    plain = [t.clone().requires_grad_() for t in (x, emb, w)]
    dense_agg_plain(plain[0], src, dst, emask, plain[1], plain[2]).square() \
        .sum().backward()
    for a, b in zip(leaves, plain):
        assert (a.grad - b.grad).abs().max().item() <= GRAD_TOL * max(
            1.0, b.grad.abs().max().item())
    with pytest.raises(ValueError, match="expected"):
        dense_agg(x, src.long(), dst, emask, emb)
    with pytest.raises(ValueError, match="contiguous"):
        dense_agg(x.transpose(0, 1).contiguous().transpose(0, 1), src, dst,
                  emask, emb)
    with pytest.raises(ValueError, match="shared memory"):
        dense_agg(torch.zeros(2, 48, 128, device=cuda),
                  torch.zeros(2, 20000, dtype=torch.int32, device=cuda),
                  torch.zeros(2, 20000, dtype=torch.int32, device=cuda),
                  torch.zeros(2, 20000, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
def test_nci1_step_through_kernels_matches_plain(cuda):
    """The NCI1 GraphTrans at the yml's widths (GCN 5 x 128 on the strided
    layout, JK=last, 3 encoder layers of 128, dropout 0.1/0.1): eval logits
    and one train step through K6/K6-bwd and K2/K2-bwd against the plain
    route with the same dropout draws."""
    from graphtrans_tpu_torch.data.synthetic import make_tu_dataset
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.nn.encoders import (LinearNodeEncoder,
                                                  ZeroEdgeEncoder)
    from graphtrans_tpu_torch.nn.init import init_weights
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.train.losses import classification_loss

    graphs = [dict(g, _id=i) for i, g in enumerate(
        make_tu_dataset(num_graphs=40, seed=4))]
    b = collate(graphs, 41, 41 * 48, 8192, num_tasks=2, y_dtype="int32",
                node_stride=48, dense_edge_cap=160, seq_pack_w=128).to(cuda)
    model = GNNTransformer(
        2, 5, 128, False, 128, 4, 256, 3, True, gnn_dropout=0.1,
        transformer_dropout=0.1, device=cuda, gnn_type="gcn",
        node_encoder=LinearNodeEncoder(16, 128, device=cuda), gnn_JK="last",
        edge_encoder=lambda: ZeroEdgeEncoder(128))
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(b)[b.graph_mask]
        assert (kernels.dense_agg.launches,
                kernels.attention_seg.launches) == (5, 3)
        want = set_kernels(model, False)(b)[b.graph_mask]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= LOGITS_TOL
    model.train()
    result = []
    for on in (True, False):
        set_kernels(model, on)
        model.zero_grad(set_to_none=True)
        kernels.reset_launches()
        loss = classification_loss(model(b, Generators.seeded(5, cuda)), b)
        loss.backward()
        if on:
            assert (kernels.dense_agg_bwd.launches,
                    kernels.attention_seg_bwd.launches) == (5, 3)
        result.append((loss.item(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()}))
    (lk, gk), (lp, gp) = result
    assert abs(lk - lp) <= LOGITS_TOL
    for name in gk:
        err = (gk[name] - gp[name]).abs().max().item()
        assert err <= GRAD_TOL * max(1.0, gp[name].abs().max().item()), name


# ---- K8 (blocked_gather_message_scatter) and K12 (segment_sum_mxu) ---------


def _k8_batch(seed=0):
    """A flat code2-like batch of 40 ASTs with both block plans at
    ``chunk_capacity`` of its caps."""
    from graphtrans_tpu_torch.data.loader import dataset_caps
    from graphtrans_tpu_torch.data.synthetic import make_code_dataset
    from graphtrans_tpu_torch.data.vocab import augment_edge
    from graphtrans_tpu_torch.ops.block_plan import chunk_capacity

    graphs = [dict(augment_edge(g), _id=i) for i, g in enumerate(
        make_code_dataset(num_graphs=40, min_nodes=20, max_nodes=400,
                          seed=seed))]
    ncap, ecap = dataset_caps(graphs, 40)
    b = collate(graphs, 41, ncap, ecap, num_tasks=4, y_dtype="float32",
                bsp_chunks_cap=chunk_capacity(ecap, ncap))
    assert b.bsp_fwd is not None
    return b


def _k8_case(d, cuda, seed=0):
    """K8's arguments as a GCN layer gets them: random x, one random row
    per edge laid out in each plan's order (as the edge encoder makes both
    copies), slot weights from random per-node values."""
    from graphtrans_tpu_torch.ops.block_plan import build_block_plan

    b = _k8_batch(seed)
    gen = torch.Generator().manual_seed(d + seed)
    N, E = b.num_node_slots, b.edge_src.shape[0]
    x = torch.randn(N, d, generator=gen)
    per_edge = torch.randn(E, d, generator=gen)
    vals = torch.rand(N, generator=gen) + 0.2
    w_edge = vals[torch.from_numpy(b.edge_src).long()] * vals[
        torch.from_numpy(b.edge_dst).long()]
    embs, ws = [], []
    for major in ("dst", "src"):
        perm = torch.from_numpy(build_block_plan(
            b.edge_src, b.edge_dst, b.edge_mask, N,
            b.bsp_fwd["blk_out"].shape[0], major)["perm"])
        real = perm >= 0
        emb = torch.zeros(perm.shape[0], d)
        emb[real] = per_edge[perm[real]]
        w = torch.zeros(perm.shape[0])
        w[real] = w_edge[perm[real]]
        embs.append(emb.to(cuda))
        ws.append(w.to(cuda))
    return b.to(cuda), x.to(cuda), embs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_blocked_kernels_match_plain(cuda, d, message, weighted):
    """K8's forward, d_emb and dx kernels against the plain versions (the
    forward 1e-5, the backward 5e-4 of max(1, max|ref|) from autograd
    through the plain forward); slots that are not real get exact-zero
    d_emb rows; one launch each."""
    from graphtrans_tpu_torch.ops.kernels import (
        blocked_gather_message_scatter,
        blocked_gather_message_scatter_bwd_plain,
        blocked_gather_message_scatter_demb,
        blocked_gather_message_scatter_demb_plain,
        blocked_gather_message_scatter_dx,
        blocked_gather_message_scatter_dx_plain,
        blocked_gather_message_scatter_plain)

    b, x, (ef, eb), (wf, wb) = _k8_case(d, cuda)
    if not weighted:
        wf = wb = None
    pf, pb = b.bsp_fwd, b.bsp_bwd
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)
                    ).to(cuda)
    counts = [f.launches for f in (blocked_gather_message_scatter,
                                   blocked_gather_message_scatter_demb,
                                   blocked_gather_message_scatter_dx)]
    out = blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb, message)
    demb = blocked_gather_message_scatter_demb(x, g, ef, pf, wf, message)
    dx = blocked_gather_message_scatter_dx(x, g, eb, pb, wb, message)
    torch.cuda.synchronize()
    assert [f.launches for f in (blocked_gather_message_scatter,
                                 blocked_gather_message_scatter_demb,
                                 blocked_gather_message_scatter_dx)] == [
        c + 1 for c in counts]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:                     # index_add_ sums in a fixed order
        want = blocked_gather_message_scatter_plain(x, ef, eb, pf, pb, wf,
                                                    wb, message)
        ref_dx, ref_demb = blocked_gather_message_scatter_bwd_plain(
            x, ef, eb, pf, pb, g, wf, wb, message)
        plain_dx = blocked_gather_message_scatter_dx_plain(x, g, eb, pb, wb,
                                                           message)
    finally:
        torch.use_deterministic_algorithms(False)
    plain_demb = blocked_gather_message_scatter_demb_plain(x, g, ef, pf, wf,
                                                           message)
    assert torch.isfinite(out).all()
    assert (out - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    for got, ref in ((demb, ref_demb), (dx, ref_dx), (demb, plain_demb),
                     (dx, plain_dx)):
        assert (got - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item())
    real = pf["mask"].reshape(-1) > 0
    assert not demb[~real].any()


@pytest.mark.cuda
def test_blocked_autograd_and_refusals(cuda):
    """Through K8 a CUDA leaf gets its gradient from the d_emb and dx
    kernels (emb_bwd none); a slot weight that asks for a gradient raises;
    under no_grad and inference_mode the forward saves nothing."""
    from graphtrans_tpu_torch.ops.kernels import (
        blocked_gather_message_scatter,
        blocked_gather_message_scatter_bwd_plain,
        blocked_gather_message_scatter_demb,
        blocked_gather_message_scatter_dx)

    b, x, (ef, eb), (wf, wb) = _k8_case(128, cuda, seed=1)
    pf, pb = b.bsp_fwd, b.bsp_bwd
    leaves = [t.clone().requires_grad_() for t in (x, ef, eb)]
    g = torch.randn(x.shape, device=cuda)
    c_demb = blocked_gather_message_scatter_demb.launches
    c_dx = blocked_gather_message_scatter_dx.launches
    blocked_gather_message_scatter(*leaves, pf, pb, wf, wb).backward(g)
    torch.cuda.synchronize()
    assert blocked_gather_message_scatter_demb.launches == c_demb + 1
    assert blocked_gather_message_scatter_dx.launches == c_dx + 1
    assert leaves[2].grad is None
    for got, ref in zip(leaves[:2], blocked_gather_message_scatter_bwd_plain(
            x, ef, eb, pf, pb, g, wf, wb)):
        assert (got.grad - ref).abs().max().item() <= GRAD_TOL * max(
            1.0, ref.abs().max().item())
    with pytest.raises(ValueError, match="gradient"):
        blocked_gather_message_scatter(leaves[0], ef, eb, pf, pb,
                                       wf.clone().requires_grad_(), wb)
    with pytest.raises(ValueError, match="multiple"):
        blocked_gather_message_scatter(x[:-1], ef, eb, pf, pb, wf, wb)
    with pytest.raises(ValueError, match="expected"):
        blocked_gather_message_scatter(x, ef[:-1], eb, pf, pb, wf, wb)
    with torch.no_grad():
        blocked_gather_message_scatter(*leaves, pf, pb, wf, wb)
    with torch.inference_mode():
        blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_code2_model_blocked_route_matches_plain_and_k7(cuda, deterministic):
    """The code2 model with both plans and the switch on: 3 K8 launches a
    forward and 3 + 3 + 3 with its gradients, 0 of K7; logits and
    gradients against the plain versions of the same route and against
    the K7 route."""
    from graphtrans_tpu_torch.data.synthetic import make_code_dataset
    from graphtrans_tpu_torch.data.vocab import (augment_edge,
                                                 encode_seq_to_arr,
                                                 get_vocab_mapping)
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.ops import kernels
    from graphtrans_tpu_torch.ops.block_plan import (chunk_capacity,
                                                     set_block_spmm)
    from graphtrans_tpu_torch.train.losses import seq_token_loss

    raw = make_code_dataset(num_graphs=14, vocab_size=50, seq_len_max=6,
                            seed=3, size_dist="code2")
    v2i, _ = get_vocab_mapping([g["y_seq"] for g in raw], 50)
    graphs = [dict(augment_edge(g), _id=i,
                   y_arr=encode_seq_to_arr(g["y_seq"], v2i, 5))
              for i, g in enumerate(raw)]
    b = collate(graphs, 15, 8192, 32768, num_tasks=len(v2i), max_seq_len=5,
                seq_pack_w=1024, seq_pack_w2=384, seq_pack_w3=128,
                bsp_chunks_cap=chunk_capacity(32768, 8192)).to(cuda)
    assert b.bsp_fwd is not None
    model = set_block_spmm(_code2_model(len(v2i), cuda), "on")
    kernels.reset_launches()
    with torch.inference_mode():
        got = model(b)[b.graph_mask]
        counts = kernels.launch_counts()
        assert (counts["blocked_gather_message_scatter"],
                counts["spmm"]) == (3, 0)
        plain = set_kernels(model, False)(b)[b.graph_mask]
        k7 = set_block_spmm(set_kernels(model, True), "off")(b)[b.graph_mask]
    assert torch.isfinite(got).all()
    assert (got - plain).abs().max().item() <= LOGITS_TOL
    assert (got - k7).abs().max().item() <= LOGITS_TOL
    model.train()
    grads = []
    for kern, mode in ((True, "on"), (False, "on"), (True, "off")):
        set_block_spmm(set_kernels(model, kern), mode)
        model.zero_grad(set_to_none=True)
        kernels.reset_launches()
        seq_token_loss(model(b, Generators.seeded(5, cuda)), b).backward()
        if kern and mode == "on":
            counts = kernels.launch_counts()
            assert [counts[k] for k in (
                "blocked_gather_message_scatter",
                "blocked_gather_message_scatter_demb",
                "blocked_gather_message_scatter_dx", "spmm",
                "spmm_bwd")] == [3, 3, 3, 0, 0]
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        for ref in (grads[1][name], grads[2][name]):
            assert (g - ref).abs().max().item() <= GRAD_TOL * max(
                1.0, ref.abs().max().item()), name


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,d", [(1024, 4096, 128), (65536, 196608, 128),
                                   (512, 1024, 256)])
def test_segment_sum_mxu_kernel_matches_plain(cuda, N, E, d):
    """K12 against its plain version (index_add_ under deterministic
    algorithms) over sorted dsts with out-of-range edges at both ends; one
    launch; None on a refused shape; msg that asks for a gradient
    raises."""
    from graphtrans_tpu_torch.ops.kernels import (segment_sum_mxu,
                                                  segment_sum_mxu_plain)

    gen = torch.Generator().manual_seed(N)
    msg = torch.randn(E, d, generator=gen).to(cuda)
    dst = torch.sort(torch.cat([
        torch.randint(0, N, (E - 64,), generator=gen),
        torch.full((32,), -1), torch.full((32,), N)]))[0].int().to(cuda)
    before = segment_sum_mxu.launches
    got = segment_sum_mxu(msg, dst, N)
    torch.cuda.synchronize()
    assert segment_sum_mxu.launches == before + 1
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = segment_sum_mxu_plain(msg, dst, N)
    finally:
        torch.use_deterministic_algorithms(False)
    assert got.dtype == torch.float32 and got.shape == (N, d)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    assert segment_sum_mxu(msg[:, :100].contiguous(), dst, N) is None
    with pytest.raises(ValueError, match="gradient"):
        segment_sum_mxu(msg.clone().requires_grad_(), dst, N)


# ---- K7's forward over runs of rows, K12 on the merge path ----------------


def _only_kernel_launched(fn, kernel: str, calls: int = 5, tries: int = 4):
    """Whether ``calls`` calls of ``fn`` (after a warm-up call) launched no
    CUDA work but kernels named ``kernel``, at least one recorded, from
    torch.profiler. The profiler may drop a kernel's record, so the count
    can fall short of ``calls``, and a profile that recorded no CUDA work
    at all is taken again, up to ``tries`` profiles; a launch of any other
    op in any call shows under its own name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert names and len(names) <= calls, names
    assert all(kernel in n for n in names), names


def _k7_tail_case(d, cuda, N=3000, live=9000, tail=30000):
    """dst-sorted edges: live ones over rows 0..N-501 with masks mid-row
    (every 9th), a hub (row 5 with 600 more), zero weights (one inside row
    11, all of row 12), rows N-500..N-2 with no edge, and a masked padding
    tail of ``tail`` edges on node N-1 (whose row of x is zero)."""
    gen = torch.Generator().manual_seed(d + 2)
    dst = torch.sort(torch.cat([
        torch.randint(0, N - 500, (live - 600,), generator=gen),
        torch.full((600,), 5)]))[0]
    src = torch.randint(0, N - 1, (live,), generator=gen)
    pad = torch.full((tail,), N - 1)
    dst, src = torch.cat([dst, pad]), torch.cat([src, pad])
    E = live + tail
    mask = torch.arange(E) < live
    mask[:live:9] = False
    w = torch.rand(E, generator=gen) + 0.1
    w[torch.nonzero((dst == 11) & mask).flatten()[:1]] = 0.0
    w[dst == 12] = 0.0
    x = torch.randn(N, d, generator=gen)
    x[N - 1] = 0
    return [t.to(cuda) for t in (
        x, torch.randn(E, d, generator=gen), src.int(), dst.int(), mask, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128, 64, 45])
@pytest.mark.parametrize("message", ["relu_add", "add"])
def test_spmm_runs_match_plain_and_walk(cuda, d, message):
    """K7's forward over runs of whole destination rows, with and without
    the batch's DstOrder: within 1e-5 of max(1, max|ref|) of the plain
    version, the CPU walk's bits (tests/_port_walks.py), the same bits in
    both calls; rows with no live edge exactly 0; a call with the order
    launches one kernel and no PyTorch op before it. d 45: one float a
    load."""
    from _port_walks import k7_fwd_walk

    from graphtrans_tpu_torch.ops.kernels import DstOrder, spmm, spmm_plain

    x, emb, src, dst, mask, w = _k7_tail_case(d, cuda)
    N = x.shape[0]
    rows = DstOrder(dst, mask, N)
    before = spmm.launches
    got = spmm(x, emb, src, dst, mask, w, message, rows=rows)
    again = spmm(x, emb, src, dst, mask, w, message)
    torch.cuda.synchronize()
    assert spmm.launches == before + 2
    assert torch.equal(got, again)
    want = spmm_plain(x, emb, src, dst, mask, w, message)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    assert not got[N - 500:].any() and not got[12].any()
    host = [t.cpu() for t in (x, emb, src, dst, mask, w)]
    walk, writes, _ = k7_fwd_walk(*(t.numpy() for t in host),
                                  message == "relu_add",
                                  DstOrder(host[3], host[4], N))
    assert (writes == 1).all()
    assert torch.equal(got.cpu(), torch.from_numpy(walk))
    _only_kernel_launched(
        lambda: spmm(x, emb, src, dst, mask, w, message, rows=rows),
        "spmm_fwd")


@pytest.mark.cuda
@pytest.mark.parametrize("N,E,d,long_row",
                         [(1024, 4096, 128, None), (65536, 196608, 128, None),
                          (512, 1024, 256, None), (1024, 32768, 512, 30000)])
def test_segment_sum_mxu_merge_path(cuda, N, E, d, long_row):
    """K12 over sorted dsts with out-of-range edges at both ends, rows
    without edges (the last 50 among them), a row of 600 edges and, in
    the last case, one of 30000: within 1e-5 of max(1, max|ref|) of the
    plain version, the CPU walk's bits where it is small, identical bits
    in two calls, one launch and no PyTorch op launched before it."""
    from _port_walks import k12_walk

    from graphtrans_tpu_torch.ops.kernels import (segment_sum_mxu,
                                                  segment_sum_mxu_plain)
    from graphtrans_tpu_torch.ops.kernels.scatter_mxu import SPAN

    gen = torch.Generator().manual_seed(N + d)
    extra = [torch.full((600,), 7)] + (
        [torch.full((long_row,), 200)] if long_row else [])
    rest = E - 600 - (long_row or 0) - 40
    dst = torch.sort(torch.cat([
        torch.randint(0, N - 50, (rest,), generator=gen), *extra,
        torch.full((20,), -1), torch.full((20,), N)]))[0].int()
    msg = torch.randn(E, d, generator=gen)
    dc, mc = dst.to(cuda), msg.to(cuda)
    before = segment_sum_mxu.launches
    got = segment_sum_mxu(mc, dc, N)
    again = segment_sum_mxu(mc, dc.long(), N)
    torch.cuda.synchronize()
    assert segment_sum_mxu.launches == before + 2
    assert torch.equal(got, again)
    want = segment_sum_mxu_plain(msg, dst, N)
    assert (got.cpu() - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    assert not got[N - 50:].any()
    if E <= 32768:
        walk, writes, cut = k12_walk(msg.numpy(), dst.numpy(), N, SPAN)
        assert (writes == 1).all() and 7 in cut
        assert torch.equal(got.cpu(), torch.from_numpy(walk))
    _only_kernel_launched(lambda: segment_sum_mxu(mc, dc, N),
                          "segment_sum_kernel")


@pytest.mark.cuda
def test_segment_sum_mxu_many_long_rows(cuda):
    """K12 with 70 rows of 4608 edges, each cut into some 36 pieces: the
    last block's scan meets them in two windows of 2048 warps and joins
    each with the whole block, in 8 ranges; the CPU walk's bits hold for
    every row."""
    from _port_walks import k12_walk

    from graphtrans_tpu_torch.ops.kernels import segment_sum_mxu
    from graphtrans_tpu_torch.ops.kernels.scatter_mxu import SPAN

    N, rows, per = 1024, 70, 4608
    dst = (torch.arange(rows * per) // per * 13).int()
    msg = torch.randn(rows * per, 128,
                      generator=torch.Generator().manual_seed(70))
    got = segment_sum_mxu(msg.to(cuda), dst.to(cuda), N)
    walk, writes, cut = k12_walk(msg.numpy(), dst.numpy(), N, SPAN)
    assert (writes == 1).all() and len(cut) == rows
    assert torch.equal(got.cpu(), torch.from_numpy(walk))


@pytest.mark.cuda
def test_segment_sum_mxu_two_streams_at_once(cuda):
    """K12 called on two streams at once, over and over (each stream has
    its own ticket counter): every result has the bits of the same call
    on one stream, the padding-like long row included."""
    from graphtrans_tpu_torch.ops.kernels import segment_sum_mxu

    N, E = 65536, 196608
    gen = torch.Generator().manual_seed(2)
    dst = torch.sort(torch.cat([torch.randint(0, N, (E - 25000,),
                                              generator=gen),
                                torch.full((25000,), N - 1)]))[0].int()
    dc = dst.to(cuda)
    msgs = [torch.randn(E, 128, generator=gen).to(cuda) for _ in range(2)]
    want = [segment_sum_mxu(m, dc, N) for m in msgs]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(20):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[k].append(segment_sum_mxu(msgs[k], dc, N))
    torch.cuda.synchronize()
    for k in range(2):
        for out in got[k]:
            assert torch.equal(out, want[k])


# ---- K8's forward over a SlotOrder, K6-bwd's instances -------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128, 45])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_blocked_fwd_matches_slot_walk(cuda, d, message, weighted):
    """K8's forward on K7's body over the batch's SlotOrder: the CPU
    walk's bits (tests/_port_walks.py), every row written once; the same
    bits with a new order and without the src-major plan (no gradient);
    within 1e-5 of max(1, max|ref|) of the plain version; a call with the
    order launches one kernel and no PyTorch op before it. d 45: one float
    a load."""
    from _port_walks import k8_fwd_walk

    from graphtrans_tpu_torch.ops.kernels import (
        SlotOrder, blocked_gather_message_scatter,
        blocked_gather_message_scatter_plain, slot_order)

    b, x, (ef, eb), (wf, wb) = _k8_case(d, cuda, seed=2)
    if not weighted:
        wf = wb = None
    pf, pb = b.bsp_fwd, b.bsp_bwd
    rows = slot_order(b)
    assert slot_order(b) is rows and rows.num_edges == b.edge_src.shape[0]
    before = blocked_gather_message_scatter.launches
    got = blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb, message,
                                         rows=rows)
    again = blocked_gather_message_scatter(x, ef, None, pf, None, wf, None,
                                           message)
    torch.cuda.synchronize()
    assert blocked_gather_message_scatter.launches == before + 2
    assert torch.equal(got, again)
    want = blocked_gather_message_scatter_plain(x, ef, eb, pf, pb, wf, wb,
                                                message)
    assert (got - want).abs().max().item() <= 1e-5 * max(
        1.0, want.abs().max().item())
    host = SlotOrder({k: v.cpu() for k, v in pf.items()}, x.shape[0],
                     rows.num_edges)
    walk, writes, _ = k8_fwd_walk(
        x.cpu().numpy(), ef.cpu().numpy(),
        None if wf is None else wf.cpu().numpy(), message == "relu_add",
        host)
    assert (writes == 1).all()
    assert torch.equal(got.cpu(), torch.from_numpy(walk))
    _only_kernel_launched(
        lambda: blocked_gather_message_scatter(x, ef, eb, pf, pb, wf, wb,
                                               message, rows=rows),
        "blocked_fwd")


@pytest.mark.cuda
def test_blocked_needs_the_src_major_plan_for_a_gradient(cuda):
    """Without the src-major plan K8 serves, and refuses a call that wants
    a gradient; the model's blocked layer under inference encodes the
    dst-major plan's slots only and gives the logits of the layer that
    encodes both."""
    from graphtrans_tpu_torch.ops.kernels import (
        blocked_gather_message_scatter)

    b, x, (ef, eb), (wf, wb) = _k8_case(128, cuda, seed=3)
    xl = x.clone().requires_grad_()
    with pytest.raises(ValueError, match="src-major"):
        blocked_gather_message_scatter(xl, ef, None, b.bsp_fwd, None, wf)
    with pytest.raises(ValueError, match="together"):
        blocked_gather_message_scatter(x, ef, eb, b.bsp_fwd, None, wf, wb)
    with torch.no_grad():
        blocked_gather_message_scatter(xl, ef, None, b.bsp_fwd, None, wf)


def _dense_agg_leaves(args, need):
    """K6's arguments with x, and emb and w where ``need`` names them,
    as leaves that want a gradient."""
    x, src, dst, emask, emb, w = args
    return (x.clone().requires_grad_(), src, dst, emask,
            emb.clone().requires_grad_("demb" in need),
            None if w is None else w.clone().requires_grad_("dw" in need))


@pytest.mark.cuda
@pytest.mark.parametrize("G,d", [(129, 128), (37, 200), (9, 600)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_dense_agg_bwd_instances_match_walk(cuda, G, d, relu, with_w):
    """K6-bwd's dx-only and full instances (one channel slice and, at d
    600, two, whose dw partials add up in order): None where demb or dw is
    not asked for; the same dx bits in every instance, the CPU walk's bits
    (tests/_port_walks.py: each product rounded before its add); demb and
    dw against autograd through the plain version; launches counted by
    instance; through autograd, the instance that the leaves ask for."""
    from _port_walks import k6_bwd_walk

    from graphtrans_tpu_torch.ops.kernels import (dense_agg, dense_agg_bwd,
                                                  dense_agg_bwd_plain)

    args = _k6_case(G, d, with_w, cuda, seed=5)
    gout = torch.randn(args[0].shape, generator=torch.Generator()
                       .manual_seed(G)).to(cuda)
    want = dense_agg_bwd_plain(*args, gout, relu=relu)
    outs = {}
    for need_demb in (False, True):
        for need_dw in (False, True):
            before = dict(dense_agg_bwd.instances)
            got = dense_agg_bwd(*args, gout, relu=relu, need_demb=need_demb,
                                need_dw=need_dw)
            torch.cuda.synchronize()
            name = "+".join(["dx"] + ["demb"] * need_demb
                            + ["dw"] * (need_dw and with_w))
            assert dense_agg_bwd.instances[name] == before[name] + 1
            assert (got[1] is None) == (not need_demb)
            assert (got[2] is None) == (not (need_dw and with_w))
            for g, w in zip(got[1:], want[1:]):
                if g is not None:
                    assert (g - w).abs().max().item() <= GRAD_TOL * max(
                        1.0, w.abs().max().item())
            outs[name] = got[0]
    assert all(torch.equal(dx, outs["dx"]) for dx in outs.values())
    host = [None if t is None else t.cpu().numpy() for t in args]
    walk, writes = k6_bwd_walk(*host, gout.cpu().numpy(), relu)
    assert (writes == 1).all()
    assert torch.equal(outs["dx"].cpu(), torch.from_numpy(walk))
    for need in ((), ("demb",), ("demb", "dw")):
        leaves = _dense_agg_leaves(args, need)
        before = dict(dense_agg_bwd.instances)
        dense_agg(*leaves, relu=relu).backward(gout)
        torch.cuda.synchronize()
        name = "+".join(["dx", *(n for n in need
                                 if n == "demb" or with_w)])
        assert {k: v - before[k] for k, v in dense_agg_bwd.instances.items()
                } == {k: int(k == name) for k in before}
        assert torch.equal(leaves[0].grad, outs["dx"])


# ---- K6's forward on K6-bwd's sorted body, K8-dx over a SlotOrder ----------


@pytest.mark.cuda
@pytest.mark.parametrize("G,d", [(129, 128), (1000, 128), (37, 200),
                                 (1000, 45)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_dense_agg_fwd_matches_walk(cuda, monkeypatch, G, d, relu, with_w):
    """K6's forward, a warp a graph over its valid slots sorted by (dst,
    slot), with the embeddings and without them (emb None, the emb-less
    instance): the CPU walk's bits (tests/_port_walks.py: each weight
    product rounded before its add), every row written once, under both
    launches (slices of 32 channels, the split of small batches, and K7's
    vector rule; G 129 takes the split, G 1000 the other by default);
    within 1e-5 of the plain version (zeros where emb is None); launches
    counted by instance."""
    from _port_walks import k6_fwd_walk

    from graphtrans_tpu_torch.ops.kernels import dense_agg, dense_agg_plain

    k6 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.dense_agg")
    x, src, dst, emask, emb, w = _k6_case(G, d, with_w, cuda, seed=8)
    zeros = torch.zeros_like(emb)
    host = [None if t is None else t.cpu().numpy()
            for t in (x, src, dst, emask, emb, w)]
    for e, inst in ((emb, "emb"), (None, "emb-less")):
        walk, writes = k6_fwd_walk(*host[:4], None if e is None else host[4],
                                   host[5], relu)
        assert (writes == 1).all()
        outs = []
        for split in (0, 10 ** 6):
            monkeypatch.setattr(k6, "FWD_SPLIT_PER_SM", split)
            before = dict(dense_agg.instances)
            outs.append(dense_agg(x, src, dst, emask, e, w, relu))
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in dense_agg.instances.items()
                    } == {k: int(k == inst) for k in before}
        for got in outs:
            assert torch.equal(got.cpu(), torch.from_numpy(walk))
        want = dense_agg_plain(x, src, dst, emask,
                               zeros if e is None else e, w, relu)
        assert (outs[0] - want).abs().max().item() <= 1e-5 * max(
            1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_dense_agg_emb_less_matches_zero_emb(cuda, relu, with_w):
    """K6 and K6-bwd with emb None against the same kernels given a zero
    emb tensor: the same forward and dx (and dw) bits; no demb; through
    autograd a leaf x gets the walk's dx bits with one dx-only launch."""
    from _port_walks import k6_bwd_walk

    from graphtrans_tpu_torch.ops.kernels import dense_agg, dense_agg_bwd

    x, src, dst, emask, emb, w = _k6_case(129, 128, with_w, cuda, seed=9)
    zeros = torch.zeros_like(emb)
    gout = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)
                       ).to(cuda)
    assert torch.equal(dense_agg(x, src, dst, emask, None, w, relu),
                       dense_agg(x, src, dst, emask, zeros, w, relu))
    none = dense_agg_bwd(x, src, dst, emask, None, w, gout, relu)
    zero = dense_agg_bwd(x, src, dst, emask, zeros, w, gout, relu,
                         need_demb=False)
    assert none[1] is None and torch.equal(none[0], zero[0])
    assert (none[2] is None) == (not with_w)
    if with_w:
        assert torch.equal(none[2], zero[2])
    host = [None if t is None else t.cpu().numpy() for t in (x, src, dst,
                                                              emask)]
    walk, _ = k6_bwd_walk(*host, None,
                          None if w is None else w.cpu().numpy(),
                          gout.cpu().numpy(), relu)
    assert torch.equal(none[0].cpu(), torch.from_numpy(walk))
    xl = x.clone().requires_grad_()
    before = dict(dense_agg_bwd.instances)
    dense_agg(xl, src, dst, emask, None, w, relu).backward(gout)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in dense_agg_bwd.instances.items()
            } == {k: int(k == "dx") for k in before}
    assert torch.equal(xl.grad, none[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128, 45])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_blocked_dx_matches_walk(cuda, d, message, weighted):
    """K8-dx on K7-bwd's walk over the src-major plan's SlotOrder: through
    ``src_slot_order`` (the dst-major emb copy and weight read through
    ``fwd_slot``) the bits of the call that reads the src-major copies at
    their own slots, and the CPU walk's bits (tests/_port_walks.py), every
    row written once; within 5e-4 of max(1, max|ref|) of the plain
    version; a call with the batch's order launches one kernel and no
    PyTorch op before it. d 45: one float a load."""
    from _port_walks import k8_dx_walk

    from graphtrans_tpu_torch.ops.kernels import (
        SlotOrder, blocked_gather_message_scatter_dx,
        blocked_gather_message_scatter_dx_plain, src_slot_order)

    b, x, (ef, eb), (wf, wb) = _k8_case(d, cuda, seed=4)
    if not weighted:
        wf = wb = None
    pb = b.bsp_bwd
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(d)
                    ).to(cuda)
    rows = src_slot_order(b)
    assert src_slot_order(b) is rows
    before = blocked_gather_message_scatter_dx.launches
    got = blocked_gather_message_scatter_dx(x, g, ef, pb, wf, message,
                                            rows=rows)
    own = blocked_gather_message_scatter_dx(x, g, eb, pb, wb, message)
    torch.cuda.synchronize()
    assert blocked_gather_message_scatter_dx.launches == before + 2
    assert torch.equal(got, own)
    host = SlotOrder({k: v.cpu() for k, v in pb.items()}, x.shape[0],
                     rows.num_edges, slot_map=pb["fwd_slot"].cpu())
    walk, writes = k8_dx_walk(x.cpu().numpy(), g.cpu().numpy(),
                              ef.cpu().numpy(),
                              None if wf is None else wf.cpu().numpy(),
                              message == "relu_add", host)
    assert (writes == 1).all()
    assert torch.equal(got.cpu(), torch.from_numpy(walk))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = blocked_gather_message_scatter_dx_plain(x, g, eb, pb, wb,
                                                       message)
    finally:
        torch.use_deterministic_algorithms(False)
    assert (got - want).abs().max().item() <= GRAD_TOL * max(
        1.0, want.abs().max().item())
    _only_kernel_launched(
        lambda: blocked_gather_message_scatter_dx(x, g, ef, pb, wf, message,
                                                  rows=rows),
        "blocked_dx")


# ---- the bf16 step: K1, K1-bwd, K2 and K2-bwd in bf16 ---------------------

BF16 = torch.bfloat16
# of max(1, max |plain bf16|): outputs two bf16 ulps at 1, gradients four
BF16_OUT_TOL, BF16_GRAD_TOL = 7.8e-3, 1.6e-2


def _rel_bf16(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 65, 4097])
@pytest.mark.parametrize("d", [40, 42, 300])
@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (True, True)])
def test_gin_agg_bf16_kernels_match_plain(cuda, G, d, with_w, with_scale):
    """K1 and K1-bwd's bf16 instances against their plain bf16 versions
    (the JAX kernel's rounding points): out within BF16_OUT_TOL and dx,
    dT, dw (bf16) and dscale (f32) within BF16_GRAD_TOL of max(1,
    max|plain|), at one graph, 65 and the bench batch's 4097, 4 channels a
    thread (d 40, 300) and 1 (d 42); counted by instance; padding rows of
    out exactly 0; the same bits on two runs."""
    b = _k1_batch(G).to(cuda)
    a = _k1_args(b, d, with_w, with_scale, cuda)
    args = (a[0].to(BF16), *a[1:5], a[5].to(BF16),
            None if a[6] is None else a[6].to(BF16), a[7])
    gout = torch.randn(a[0].shape, generator=torch.Generator().manual_seed(
        8)).to(cuda, BF16)
    f0, b0 = gin_agg.instances["bf16"], gin_agg_bwd.instances["bf16"]
    out = gin_agg(*args)
    got = gin_agg_bwd(*args, gout)
    again = gin_agg_bwd(*args, gout)
    torch.cuda.synchronize()
    assert gin_agg.instances["bf16"] == f0 + 1
    assert gin_agg_bwd.instances["bf16"] == b0 + 2
    assert out.dtype == BF16
    assert _rel_bf16(out, gin_agg_plain(*args)) <= BF16_OUT_TOL
    assert not out.reshape(-1, d)[~b.node_mask].any()
    want = gin_agg_bwd_plain(*args, gout)
    for name, g, w, r in zip(("dx", "dT", "dw", "dscale"), got, want, again):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype, name
            assert _rel_bf16(g, w) <= BF16_GRAD_TOL, name
            assert torch.equal(g, r), name


@pytest.mark.cuda
def test_bf16_wrappers_refuse_mixed_dtypes(cuda):
    """A bf16 x with an f32 table, or a bf16 qkv with an f32 cotangent,
    raises: no wrapper widens or narrows an input silently."""
    b = _k1_batch(65).to(cuda)
    a = _k1_args(b, 40, False, True, cuda)
    with pytest.raises(ValueError):
        gin_agg(a[0].to(BF16), *a[1:])
    qkv, seg = _k2_segments(128, cuda)
    q16 = qkv.to(BF16)
    out, m, l = attention_seg_with_stats(q16, seg, 4, 0.0, 0)
    with pytest.raises(ValueError):
        attention_seg_bwd(q16, seg, 4, out.float(), (out, m, l))


# rows of 128 whose segments cross the bf16 pair's 16-token tile borders
K2_TILE_ROWS = [[1, 15, 16, 17, 33, 46], [48, 48, (32, -1)],
                [17] * 7 + [9], [15] * 8 + [8], [33, 33, 33, 29]]


def _serve64_k2(cuda):
    """qkv (random) and seg of the molpcba snapshot's first serving batch
    of 64 graphs (chip_smoke.py's serve64)."""
    import pathlib

    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.data.mol import load_mol_splits
    from graphtrans_tpu_torch.utils.config import parse_with_config

    repo = pathlib.Path(__file__).resolve().parents[1]
    snap = str(repo / "data_snapshots")
    args = parse_with_config(predict.build_parser(), [
        "--configs", str(repo / "configs/molpcba/gnn-transformer/JK=cat/"
                         "pooling=cls+gin+norm_input.yml"),
        "--data_root", snap, "--batch_size", "64"])
    splits, num_tasks = load_mol_splits(snap, "ogbg-molpcba")
    b = next(iterate_batches(splits["train"], **predict.serving_layout(
        splits, args, num_tasks)))
    seg = torch.as_tensor(b.pack_seg).reshape(b.pack_rows, b.pack_w)
    gen = torch.Generator().manual_seed(64)
    return (torch.randn(b.pack_rows, b.pack_w, 384, generator=gen).to(cuda),
            seg.to(cuda))


def _k2_bf16_case(case, cuda):
    if case == "serve64":
        return _serve64_k2(cuda)
    W = int(case)
    return _k2_segments(W, cuda, K2_TILE_ROWS if W == 128 else ())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["37", "128", "serve64"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_seg_bf16_kernels_match_plain(cuda, case, rate):
    """K2 and K2-bwd's bf16 instances (rows of up to 128: a warp a
    16-query tile) on rows of every segment length, segments of 1, 15, 16,
    17, 33, 46 and 48 tokens and runs that cross the 16-token tile borders,
    an id in two runs, an all-padding row, and the molpcba snapshot's
    serve64 batch, against their plain bf16 versions (the same masks): out
    within BF16_OUT_TOL, dqkv within BF16_GRAD_TOL of max(1, max|plain|);
    the serving launch's bits; padding tokens exactly 0; the same bits on
    two runs; counted as tile_bf16; rows of 129 or more take the long
    bf16 instance (counted as long_bf16)."""
    H, seed = 4, 2**31 - 13
    qkv, seg = _k2_bf16_case(case, cuda)
    q16 = qkv.to(BF16)
    g = torch.randn(qkv.shape[0], qkv.shape[1], 128,
                    generator=torch.Generator().manual_seed(6)).to(cuda, BF16)
    f0 = attention_seg.instances["tile_bf16"]
    b0 = attention_seg_bwd.instances["tile_bf16"]
    runs = []
    for _ in range(2):
        out, m, l = attention_seg_with_stats(q16, seg, H, rate, seed)
        dqkv = attention_seg_bwd(q16, seg, H, g, (out, m, l), rate, seed)
        runs.append((out, m, l, dqkv))
    torch.cuda.synchronize()
    assert attention_seg.instances["tile_bf16"] == f0 + 2
    assert attention_seg_bwd.instances["tile_bf16"] == b0 + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, m, l, dqkv = runs[0]
    assert out.dtype == dqkv.dtype == BF16
    assert _rel_bf16(out, attention_seg_plain(q16, seg, H, rate, seed)) \
        <= BF16_OUT_TOL
    assert _rel_bf16(dqkv, attention_seg_bwd_plain(q16, seg, H, g, rate,
                                                   seed)) <= BF16_GRAD_TOL
    pad = seg < 0
    assert not out[pad].any() and not dqkv[pad].any()
    if rate == 0.0:
        assert torch.equal(attention_seg(q16, seg, H), out)
    wide, wseg = _k2_segments(384, cuda)
    l0, t0 = (attention_seg.instances[k] for k in ("long_bf16", "tile_bf16"))
    attention_seg(wide.to(BF16), wseg, H)   # rows of 384: the long instance
    assert attention_seg.instances["long_bf16"] == l0 + 1
    assert attention_seg.instances["tile_bf16"] == t0


@pytest.mark.cuda
def test_bf16_train_step_kernels_match_plain(cuda, deterministic):
    """One bf16 AdamW step (dropout on, the same seeds) through the bf16
    kernels against the plain bf16 versions: the loss within 2e-2 of
    max(1, |ref|), the float32 gradients within 5e-2 of max(1, max|ref|)
    (the bounds tests/test_torch_port_bf16.py holds the step to against
    the JAX package); the launches the bf16 instances."""
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.ops.kernels import reset_launches
    from graphtrans_tpu_torch.train.losses import binary_multitask_loss
    from graphtrans_tpu_torch.train.optim import build_optimizer
    from graphtrans_tpu_torch.trainers.base_trainer import make_train_step

    b = _batch(seed=4).to(cuda)
    args = argparse.Namespace(lr=1e-4, weight_decay=0.0, grad_clip=None,
                              scheduler=None, epochs=1)
    out = []
    for kernels in (True, False):
        model = set_kernels(_train_model(cuda), kernels)
        opt = build_optimizer(model, args, 1)
        step = make_train_step(model, binary_multitask_loss, opt,
                               Generators.seeded(11, cuda), "bf16")
        reset_launches()
        loss = step(b)
        out.append((loss, {n: p.grad.clone() for n, p in
                           model.named_parameters()}))
        if kernels:
            assert gin_agg.instances == {"f32": 0, "bf16": 3}
            assert gin_agg_bwd.instances == {"f32": 0, "bf16": 3}
            assert attention_seg.instances["tile_bf16"] == 2
            assert attention_seg_bwd.instances["tile_bf16"] == 2
    (lk, gk), (lp, gp) = out
    assert lk.dtype == torch.float32
    assert abs(lk.item() - lp.item()) <= 2e-2 * max(1.0, abs(lp.item()))
    for name in gk:
        assert gk[name].dtype == torch.float32, name
        assert _rel_bf16(gk[name], gp[name]) <= 5e-2, name


# ---- the code2 bf16 step: K2's long pair, K3, K3-bwd, K7, K7-bwd in bf16 --

# rows of 256 and 384 whose segments cross the 16-token tiles and the long
# bodies' 64-token tiles and chunks: single tokens, 15, 17, 63, 65, 129,
# an id in two runs, padding gaps, an all-padding row, a row of one graph
# of W tokens, and runs longer than K3's ring of three 64-key chunks
K2_LONG_ROWS = {
    256: [[1, 15, 17, 63, 65, 94, (1, -1)], [256], [(256, -1)],
          [(40, 7), 17, (40, 7), 64, (95, -1)], [(3, -1), 200, 53]],
    384: [[129, 128, (127, -1)], [1, 15, 17, 63, 65, 129, 94],
          [(150, 7), 100, (100, 7), (34, -1)], [(384, -1)], [384],
          [193, 191]],
    # the bf16 long pair's tiles inside runs: runs of a whole number of
    # 64-token chunks (64, 128, 192), runs of 1 token, and tiles that end
    # at their run's end beside the next graph's run
    320: [[128, 1, 64, 127], [64, 64, 1, (191, -1)], [192, 128],
          [(1, -1), 1, 64, 254]],
}
# K3's rows of the same kinds, with runs longer than its ring of three
# chunks (256, 447, 449)
K3_RUN_ROWS = {640: [[128, 1, 64, 447], [64, 64, 1, 256, (255, -1)],
                     [192, 192, 256], [(1, -1), 1, 189, 449]]}


def _rows_case(rows, W, seed, cuda):
    """qkv [len(rows), W, 384] (random) and seg of the rows' runs: n tokens
    of a new graph id, (n, id) of the given id, (n, -1) padding."""
    seg = torch.full((len(rows), W), -1, dtype=torch.int32)
    g = 1000
    for r, runs in enumerate(rows):
        s = 0
        for run in runs:
            n, gid = run if isinstance(run, tuple) else (run, None)
            if gid != -1:
                seg[r, s:s + n] = g if gid is None else gid
            g, s = g + 1, s + n
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(len(seg), W, 384, generator=gen).to(cuda, BF16),
            seg.to(cuda))


def _k2_long_case(W, cuda):
    return _rows_case(K2_LONG_ROWS[W], W, W + 7, cuda)


def _bf16_pair_check(fwd, bwd, plain, bwd_plain, qkv, seg, H, rate, seed,
                     counters, inst):
    """Forward with statistics and backward twice (the same bits), the
    serving launch's bits, padding exactly 0, counts by instance, and the
    plain bf16 versions within BF16_OUT_TOL and BF16_GRAD_TOL."""
    g = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3,
                    generator=torch.Generator().manual_seed(9)).to(
                        qkv.device, BF16)
    before = [c.instances[inst] for c in counters]
    runs = []
    for _ in range(2):
        out, m, l = fwd(qkv, seg, H, rate, seed)
        runs.append((out, m, l, bwd(qkv, seg, H, g, (out, m, l), rate, seed)))
    torch.cuda.synchronize()
    assert [c.instances[inst] for c in counters] == [b + 2 for b in before]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, m, l, dqkv = runs[0]
    assert out.dtype == dqkv.dtype == BF16
    assert m.dtype == l.dtype == torch.float32
    assert _rel_bf16(out, plain(qkv, seg, H, rate, seed)) <= BF16_OUT_TOL
    assert _rel_bf16(dqkv, bwd_plain(qkv, seg, H, g, rate, seed)) \
        <= BF16_GRAD_TOL
    pad = seg < 0
    assert not out[pad].any() and not dqkv[pad].any()
    assert (m[pad] == -float("inf")).all() and not l[pad].any()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("W", [256, 384, 320])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_attention_seg_long_bf16_kernels_match_plain(cuda, W, rate):
    """K2 and K2-bwd's long bf16 instance (rows of 129-384: the bf16 long
    forward, a run's keys staged whole, p normalised before it is rounded,
    and the bf16 long pair on its out, m and l, tiles inside one run, a
    tile's partners staged whole, delta summed from the pairs) on segments
    that cross the 16- and 64-token tiles, an id in two runs, an
    all-padding row, a row of one graph of W tokens, runs of more than 192
    tokens, runs of a whole number of 64-token chunks and of 1 token, and
    tiles ending at their run's end beside the next graph's run (W 320),
    against the plain bf16 versions (the same masks):
    out within BF16_OUT_TOL, dqkv within BF16_GRAD_TOL of max(1,
    max|plain|); padding tokens exactly 0 (m = -inf, l = 0); the same bits
    on two runs and from the serving launch; counted as long_bf16."""
    qkv, seg = _k2_long_case(W, cuda)
    out = _bf16_pair_check(attention_seg_with_stats, attention_seg_bwd,
                           attention_seg_plain, attention_seg_bwd_plain, qkv,
                           seg, 4, rate, 2**31 - 29,
                           (attention_seg, attention_seg_bwd), "long_bf16")
    if rate == 0.0:
        assert torch.equal(attention_seg(qkv, seg, 4), out)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["512", "1024", "straddle1024",
                                  "straddle448", "runs640"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_flash_hil_bf16_kernels_match_plain(cuda, case, rate):
    """K3 and K3-bwd's bf16 instances (the bf16 long forward's online
    softmax, its unnormalised p rounded before P V, a run's keys through
    the ring of chunk buffers; the bf16 long pair on its out, m and l,
    tiles inside one run, a tile's partners through the ring, delta = dO .
    O) on segments of 1, 64, 385, 505 and 1024 tokens (longer than the
    ring's three chunks), rows of one graph of W tokens, an id in two
    runs, all-padding rows, segments straddling the 64-token tiles, and
    (runs640) runs of a whole number of 64-token chunks and of 1 token and
    tiles ending at their run's end beside the next graph's run, against
    the plain bf16 versions (the same masks): within BF16_OUT_TOL and
    BF16_GRAD_TOL; padding exactly 0; the same bits on two runs and from
    the serving launch; counted as bf16."""
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_bwd,
                                                  flash_hil_seg_bwd_plain,
                                                  flash_hil_seg_plain)
    from graphtrans_tpu_torch.ops.kernels.flash_hil import (
        flash_hil_seg_with_stats)

    if case.startswith("straddle"):
        qkv, seg = _k3_straddle_case(int(case[8:]), cuda)
    elif case.startswith("runs"):
        W = int(case[4:])
        qkv, seg = _rows_case(K3_RUN_ROWS[W], W, W + 11, cuda)
    else:
        qkv, seg = _k3_segments(int(case), cuda)
    qkv = qkv.to(BF16)
    out = _bf16_pair_check(flash_hil_seg_with_stats, flash_hil_seg_bwd,
                           flash_hil_seg_plain, flash_hil_seg_bwd_plain, qkv,
                           seg, 4, rate, 2**31 - 31,
                           (flash_hil_seg, flash_hil_seg_bwd), "bf16")
    if rate == 0.0:
        assert torch.equal(flash_hil_seg(qkv, seg, 4), out)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,entry,W,whole", [
    ("attention_packed", "attention_seg_bwd_long_bf16_residency", 384, True),
    ("flash_hil", "flash_hil_bwd_bf16_residency", 1024, False)])
def test_bf16_long_bwd_instances_do_not_spill(cuda, kernel, entry, W, whole):
    """Every instance of the bf16 long pair (dq and dk/dv, with and
    without dropout) of K2's long instance and K3 takes no local memory
    (no spills) and fits three blocks an SM at its shared bytes on code2's
    widest rows."""
    import ctypes

    from graphtrans_tpu_torch.ops.kernels import _build, attention_packed

    mod = importlib.import_module(
        f"graphtrans_tpu_torch.ops.kernels.{kernel}")
    lib = mod._load()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    smem = attention_packed.long16_bwd_bytes(W, whole)
    for which in range(4):
        got = [ctypes.c_int(-1) for _ in range(3)]
        _build.check(lib, fn(which, smem, *(ctypes.cast(
            ctypes.pointer(v), ctypes.c_void_p) for v in got)), entry)
        regs, local, blocks = (v.value for v in got)
        assert local == 0, (which, regs, local)
        assert blocks >= 3, (which, regs, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [300, 128, 42])
@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weight", [None, "f32", "bf16"])
def test_spmm_bf16_kernels_match_plain(cuda, d, message, weight):
    """K7 and K7-bwd's bf16 instances (x, emb and g bf16, the weight f32 or
    the bf16 GCN norm widened; sums in float32, out, dx and d_emb rounded
    once) against their plain bf16 versions at 4 channels a thread (d 300,
    128) and 1 (d 42): out within BF16_OUT_TOL, dx and d_emb within
    BF16_GRAD_TOL of max(1, max|plain|); rows with no valid edge and the
    masked edges' d_emb rows exactly 0; counted as bf16."""
    from graphtrans_tpu_torch.ops.kernels import (SrcOrder, spmm, spmm_bwd,
                                                  spmm_bwd_plain, spmm_plain)

    x, emb, src, dst, mask, w = _k7_case(d, cuda)
    x, emb = x.to(BF16), emb.to(BF16)
    w = None if weight is None else w.to(BF16 if weight == "bf16"
                                         else torch.float32)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(d)).to(
        cuda, BF16)
    order = SrcOrder(src, mask, x.shape[0])
    f0, b0 = spmm.instances["bf16"], spmm_bwd.instances["bf16"]
    got = spmm(x, emb, src, dst, mask, w, message)
    dx, demb = spmm_bwd(x, emb, src, dst, mask, g, order, w, message)
    torch.cuda.synchronize()
    assert spmm.instances["bf16"] == f0 + 1
    assert spmm_bwd.instances["bf16"] == b0 + 1
    assert got.dtype == dx.dtype == demb.dtype == BF16
    assert _rel_bf16(got, spmm_plain(x, emb, src, dst, mask, w, message)) \
        <= BF16_OUT_TOL
    wdx, wdemb = spmm_bwd_plain(x, emb, src, dst, mask, g, w, message)
    assert _rel_bf16(dx, wdx) <= BF16_GRAD_TOL
    assert _rel_bf16(demb, wdemb) <= BF16_GRAD_TOL
    assert not got[x.shape[0] - 500:].any()      # rows with no valid edge
    assert not demb[~mask].any()


@pytest.mark.cuda
def test_code2_bf16_train_step_kernels_match_plain(cuda, deterministic):
    """One bf16 AdamW step of the code2 model (attention dropout 0.3, the
    same seeds) through the bf16 kernels against the plain bf16 versions:
    the loss within 2e-2 of max(1, |ref|), the float32 gradients within
    5e-2 of max(1, max|ref|) (the bounds the CPU step test holds the port
    to against the JAX package); every K2, K3 and K7 launch and every
    backward launch the bf16 instance."""
    from graphtrans_tpu_torch.nn.dropout import Generators
    from graphtrans_tpu_torch.ops.kernels import (flash_hil_seg,
                                                  flash_hil_seg_bwd,
                                                  reset_launches, spmm,
                                                  spmm_bwd)
    from graphtrans_tpu_torch.train.losses import seq_token_loss
    from graphtrans_tpu_torch.train.optim import build_optimizer
    from graphtrans_tpu_torch.trainers.base_trainer import make_train_step

    batch, num_tasks = _code2_batch(seed=2)
    b = batch.to(cuda)
    args = argparse.Namespace(lr=1e-4, weight_decay=0.0, grad_clip=None,
                              scheduler=None, epochs=1)
    out = []
    for kernels in (True, False):
        model = set_kernels(_code2_train_model(num_tasks, cuda), kernels)
        step = make_train_step(model, seq_token_loss,
                               build_optimizer(model, args, 1),
                               Generators.seeded(11, cuda), "bf16")
        reset_launches()
        loss = step(b)
        out.append((loss, {n: p.grad.clone() for n, p in
                           model.named_parameters()}))
        if kernels:
            for fn, n in ((spmm, 3), (spmm_bwd, 3), (flash_hil_seg, 2),
                          (flash_hil_seg_bwd, 2)):
                assert fn.instances == {"f32": 0, "bf16": n}, fn.__name__
            for fn in (attention_seg, attention_seg_bwd):
                assert fn.instances["tile"] == fn.instances["long"] == 0
                assert fn.launches == (fn.instances["tile_bf16"]
                                       + fn.instances["long_bf16"])
    (lk, gk), (lp, gp) = out
    assert lk.dtype == torch.float32
    assert abs(lk.item() - lp.item()) <= 2e-2 * max(1.0, abs(lp.item()))
    for name in gk:
        assert gk[name].dtype == torch.float32, name
        assert _rel_bf16(gk[name], gp[name]) <= 5e-2, name


# ---- the bf16 Transformer-only step: K4, K4-bwd, K5 and K5-bwd in bf16 ----


def _list16_pair_check(fwd, bwd, plain, bwd_plain, qkv, masks, H, rate,
                       seed, counters, inst, live, valid):
    """The bf16 key-list instances: forward with statistics and backward
    twice (the same bits), counts by instance, the plain bf16 versions
    within BF16_OUT_TOL and BF16_GRAD_TOL, queries without a key and
    padding keys exactly 0 (m = -inf, l = 0). ``masks`` are the arguments
    between qkv and H, ``inst`` the instance of each of ``counters``,
    ``live`` the queries that attend a key, ``valid`` the keys."""
    d = qkv.shape[-1] // 3
    g = torch.randn(qkv.shape[0], qkv.shape[1], d,
                    generator=torch.Generator().manual_seed(9)).to(
                        qkv.device, BF16)
    before = [c.instances[i] for c, i in zip(counters, inst)]
    runs = []
    for _ in range(2):
        out, m, l = fwd(qkv, *masks, H, rate, seed)
        runs.append((out, m, l, bwd(qkv, *masks, H, g, rate=rate, seed=seed,
                                    saved=(out, m, l))))
    torch.cuda.synchronize()
    assert [c.instances[i] for c, i in zip(counters, inst)] == [
        b + 2 for b in before]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    out, m, l, dqkv = runs[0]
    assert out.dtype == dqkv.dtype == BF16
    assert m.dtype == l.dtype == torch.float32
    assert _rel_bf16(out, plain(qkv, *masks, H, rate, seed)) <= BF16_OUT_TOL
    assert _rel_bf16(dqkv, bwd_plain(qkv, *masks, H, g, rate=rate,
                                     seed=seed)) <= BF16_GRAD_TOL
    assert not out[~live].any() and not dqkv[~live][:, :d].any()
    assert (m[~live] == -float("inf")).all() and not l[~live].any()
    assert not dqkv[..., d:][~valid].any()
    return out


# (B, S, block): K4's tile instance (graph blocks of up to 128 tokens: the
# molecule paths' packed rows) and its long one (rows of 129-384); the
# backward's short instance up to 64 tokens, its long pair above (blocks of
# 128 too)
K4_BF16_CASES = [(13, 99, 33), (9, 98, 49), (6, 128, 64), (5, 257, 0),
                 (4, 384, 0), (3, 200, 0), (4, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,S,block", K4_BF16_CASES)
def test_attention_dense_bf16_kernels_match_plain(cuda, B, S, block, rate):
    """K4 and K4-bwd's bf16 instances (the key-list bodies at heads of 64,
    K2's rounding: p normalised before it is rounded, delta summed from
    the pairs) on packed rows of 2-3 graph blocks and rows of 129-384 at
    block 0, padding keys everywhere, a block (a row) without a valid key,
    against the plain bf16 versions (the same mask): out within
    BF16_OUT_TOL, dqkv within BF16_GRAD_TOL of max(1, max|plain|); the
    same bits on two runs and from the serving launch; the forward counted
    as tile_bf16 or long_bf16, the backward as short_bf16 (graph blocks of
    up to 64 tokens, one kernel) or long_bf16."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_bwd,
                                                  attention_dense_bwd_plain,
                                                  attention_dense_plain)
    from graphtrans_tpu_torch.ops.kernels.attention_packed import (
        attention_dense_with_stats)

    gen = torch.Generator().manual_seed(B * S + block + int(rate * 10))
    qkv = torch.randn(B, S, 3 * 256, generator=gen).to(cuda, BF16)
    valid = _dense_valid(B, S, block, gen).to(cuda)
    span = block or S
    inst = (("tile" if span <= 128 else "long") + "_bf16",
            ("short" if span <= 64 else "long") + "_bf16")
    plain = lambda q, v, H, r, s: attention_dense_plain(q, v, H, block, r, s)
    bwd_plain = lambda q, v, H, g, rate, seed: attention_dense_bwd_plain(
        q, v, H, g, block, rate, seed)
    fwd = lambda q, v, H, r, s: attention_dense_with_stats(q, v, H, block, r,
                                                           s)
    bwd = lambda q, v, H, g, rate, seed, saved: attention_dense_bwd(
        q, v, H, g, block, rate, seed, saved)
    out = _list16_pair_check(fwd, bwd, plain, bwd_plain, qkv, (valid,), 4,
                             rate, 2**31 - 77,
                             (attention_dense, attention_dense_bwd), inst,
                             _live(valid, block), valid)
    if rate == 0.0:
        assert torch.equal(attention_dense(qkv, valid, 4, block), out)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,form", [(1001, "key_padding"), (520, "key_padding"),
                                    (600, "seg")])
def test_flash_attention_bf16_kernels_match_plain(cuda, S, form, rate):
    """K5 and K5-bwd's bf16 instances (the key-list bodies at heads of 64,
    the JAX kernel's rounding at precision None: the online softmax's
    unnormalised p rounded before P V, delta = dO . O, dS rounded and
    scaled after its products) on code2's rows of 1001 and rows of 520 in
    the key-padding form (a graph's nodes and its CLS column; a row
    without a valid key) and in the segment form, against the plain bf16
    versions (the same mask): within BF16_OUT_TOL and BF16_GRAD_TOL; the
    same bits on two runs and from the serving launch; counted as bf16."""
    from graphtrans_tpu_torch.ops.kernels import (flash_attention,
                                                  flash_attention_bwd,
                                                  flash_attention_bwd_plain,
                                                  flash_attention_plain,
                                                  key_padding_segs)
    from graphtrans_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_with_stats)

    gen = torch.Generator().manual_seed(S + int(rate * 10))
    B = 3
    qkv = torch.randn(B, S, 3 * 256, generator=gen).to(cuda, BF16)
    if form == "key_padding":
        n = torch.randint(9, 300, (B,), generator=gen)
        valid = torch.arange(S)[None, :] < n[:, None]
        valid[:, -1] = True
        valid[2] = False
        segq, segk = key_padding_segs(valid.to(cuda))
        live = valid.any(-1, keepdim=True).expand(B, S)
    else:
        seg = (torch.arange(S)[None, :] // torch.randint(
            40, 400, (B, 1), generator=gen)).int()
        seg[:, S - 37:] = -1
        seg[2] = -1
        segq = segk = seg.to(cuda)
        valid = live = seg >= 0
    out = _list16_pair_check(flash_attention_with_stats, flash_attention_bwd,
                             flash_attention_plain,
                             flash_attention_bwd_plain, qkv, (segq, segk), 4,
                             rate, 987654321,
                             (flash_attention, flash_attention_bwd),
                             ("bf16", "bf16"),
                             live.to(cuda), valid.to(cuda))
    if rate == 0.0:
        assert torch.equal(flash_attention(qkv, segq, segk, 4), out)


def _onehot_keys(B, S, block, n, cuda):
    """qkv [B, S, 3 * 256] with q = k = 0 and each valid key's V a one-hot
    row, channel its rank in its span (every head), valid: the first n
    tokens of each span and its last (at most 64 a span): the output of
    query i in channel c(j) is p_ij (1/n') times key j's keep bit."""
    span = block or S
    valid = torch.zeros(B, S, dtype=torch.bool)
    qkv = torch.zeros(B, S, 3 * 256)
    for s0 in range(0, S, span):
        s1 = min(S, s0 + span)
        valid[:, s0:min(s1, s0 + n)] = True
        valid[:, s1 - 1] = True
    for b in range(B):
        for s0 in range(0, S, span):
            idx = torch.nonzero(valid[b, s0:s0 + span]).flatten() + s0
            for r, j in enumerate(idx.tolist()):
                for h in range(4):
                    qkv[b, j, 512 + 64 * h + r] = 1.0
    return qkv.to(cuda), valid.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k4_tile", "k4_long", "k5"])
def test_bf16_dropout_masks_match_f32_instances(cuda, kernel):
    """Each bf16 instance draws its f32 instance's dropout mask at rate 0.3:
    with q = k = 0 and V one-hot by key rank (``_onehot_keys``) the zeros
    of the output are the mask, and the bf16 instance's zeros equal the
    f32 instance's and the plain version's (K4: K2's tiling with r the
    packed row; K5: the 256 x 256 tile schedule)."""
    from graphtrans_tpu_torch.ops.kernels import (attention_dense,
                                                  attention_dense_plain,
                                                  flash_attention,
                                                  flash_attention_plain,
                                                  key_padding_segs)

    B, S, block, n = {"k4_tile": (8, 99, 33, 30), "k4_long": (3, 300, 0, 50),
                      "k5": (3, 1001, 0, 50)}[kernel]
    qkv, valid = _onehot_keys(B, S, block, n, cuda)
    seed = 2**31 - 3
    if kernel == "k5":
        segs = key_padding_segs(valid)
        call = lambda fn, q: fn(q, *segs, 4, 0.3, seed)
        fns = (flash_attention, flash_attention_plain)
    else:
        call = lambda fn, q: fn(q, valid, 4, block, 0.3, seed)
        fns = (attention_dense, attention_dense_plain)
    kept = [call(fns[0], qkv) != 0, call(fns[0], qkv.to(BF16)) != 0,
            call(fns[1], qkv) != 0]
    torch.cuda.synchronize()
    assert torch.equal(kept[0], kept[1]) and torch.equal(kept[0], kept[2])
    frac = kept[0][..., :n].float().mean().item()
    assert abs(frac - 0.7) < 0.05, frac


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,entry", [
    ("attention_packed", "attention_dense_bf16_residency"),
    ("flash_attention", "flash_attention_bf16_residency")])
def test_bf16_list_instances_do_not_spill(cuda, kernel, entry):
    """Every kernel of K4's and K5's bf16 instances (forward, dq, dk/dv and
    K4-bwd's short one, their training launch) takes no local memory (no
    spills) and fits four blocks an SM (the forward) or three (the
    backward's kernels) at its shared bytes."""
    import ctypes

    from graphtrans_tpu_torch.ops.kernels import _build, attention_packed

    mod = importlib.import_module(
        f"graphtrans_tpu_torch.ops.kernels.{kernel}")
    lib = mod._load()
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    for which in range(4 if kernel == "attention_packed" else 3):
        got = [ctypes.c_int(-1) for _ in range(3)]
        smem = attention_packed.list16_bytes(which > 0)
        _build.check(lib, fn(which, smem, *(ctypes.cast(
            ctypes.pointer(v), ctypes.c_void_p) for v in got)), entry)
        regs, local, blocks = (v.value for v in got)
        assert local == 0, (which, regs, local)
        assert blocks >= (4 if which == 0 else 3), (which, regs, blocks)
