"""Kernel K8 (the blocked-CSR aggregation) and K12 (the segment sum of
precomputed messages) on the CPU against the JAX package: the block plans
and the bsp collate fields exactly, K8's plain forward and backward against
``ops/pallas/block_spmm.py:blocked_gather_message_scatter`` in interpret
mode, ``GCNConv`` and a narrow code2 GraphTrans on the blocked route
against the JAX modules under ``set_block_spmm("on")`` (and against the
port's own K7 route), and K12's plain version against
``ops/pallas/scatter_mxu.py:segment_sum_mxu`` in interpret mode. The CUDA
kernels are held against the plain versions on the card in
test_torch_port_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn.conv import GCNConv as JGCNConv  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, LinearEdgeEncoder as JLinearEdge)
from graphtrans_tpu.ops import block_plan as jbp  # noqa: E402
from graphtrans_tpu.ops.pallas import block_spmm as jk8  # noqa: E402
from graphtrans_tpu.ops.pallas import scatter_mxu as jk12  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.data import vocab as tv  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import (  # noqa: E402
    GNNTransformer)
from graphtrans_tpu_torch.nn.conv import GCNConv  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import (  # noqa: E402
    ASTNodeEncoder, LinearEdgeEncoder)
from graphtrans_tpu_torch.ops import block_plan as tbp  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    blocked_gather_message_scatter, blocked_gather_message_scatter_bwd_plain,
    blocked_gather_message_scatter_demb, blocked_gather_message_scatter_dx,
    blocked_gather_message_scatter_plain, segment_sum_mxu,
    segment_sum_mxu_plain, spmm)
from graphtrans_tpu_torch.train.losses import seq_token_loss  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import _hp  # noqa: E402
from test_torch_port_model import _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

FWD_TOL = 1e-5     # K8 and K12 forward, and logits-free sums of a few terms
GRAD_TOL = 5e-4    # of max(1, max |reference|)
LOGITS_TOL = 1e-4  # f32 BN/LN chains, as the code2 tests
SEQ, TYPES, ATTRS = 5, 20, 100


def _graphs(num_graphs=6, seed=5, vocab=None):
    """code2-like graphs (edges augmented, ids and, with ``vocab``, y_arr
    set) of 20-120 nodes."""
    raw = ts.make_code_dataset(num_graphs=num_graphs, vocab_size=vocab or 8,
                               seq_len_max=6, min_nodes=20, max_nodes=120,
                               seed=seed)
    v2i, _ = tv.get_vocab_mapping([g["y_seq"] for g in raw], vocab or 8)
    return [dict(tv.augment_edge(g), _id=i,
                 y_arr=tv.encode_seq_to_arr(g["y_seq"], v2i, SEQ))
            for i, g in enumerate(raw)], len(v2i)


CAPS = (7, 768, 2048)      # graph slots, node cap (6 blocks), edge cap


def _bsp_kw(cap=None):
    return dict(num_tasks=4, y_dtype="float32",
                bsp_chunks_cap=cap or tbp.chunk_capacity(CAPS[2], CAPS[1]))


# ---- the plans --------------------------------------------------------------


@pytest.mark.parametrize("major", ["dst", "src"])
@pytest.mark.parametrize("case", ["random", "hub", "empty", "overflow"])
def test_block_plan_and_permute_match_jax(major, case):
    """The vectorised build_block_plan against the JAX package's loop,
    array for array and dtype for dtype, on random edges (some masked), a
    hub node whose pair spans several chunks, no valid edge, and a cap one
    chunk short (both None)."""
    rng = np.random.default_rng(len(case) + len(major))
    N, E = 640, 3000
    src = rng.integers(0, N, E).astype(np.int32)
    if case == "hub":
        src[: E // 2] = 3
    dst = np.sort(rng.integers(0, N, E)).astype(np.int32)
    mask = rng.random(E) < (0.0 if case == "empty" else 0.85)
    cap = jbp.chunk_capacity(E, N)
    want = jbp.build_block_plan(src, dst, mask, N, cap, major)
    if case == "overflow":
        n_used = int((want["mask"].sum(1) > 0).sum()
                     + (want["is_first"] & (want["mask"].sum(1) == 0)).sum())
        cap = n_used - 1
        want = jbp.build_block_plan(src, dst, mask, N, cap, major)
        assert want is None
    got = tbp.build_block_plan(src, dst, mask, N, cap, major)
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    attr = rng.integers(-5, 5, (E, 2)).astype(np.int8)
    for fill in (0, 7):
        a = tbp.permute_edge_data(attr, want["perm"], fill)
        b = jbp.permute_edge_data(attr, want["perm"], fill)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tbp.NB, tbp.EB) == (jbp.NB, jbp.EB)
    assert tbp.chunk_capacity(E, N, 3) == jbp.chunk_capacity(E, N, 3)


@pytest.mark.parametrize("cap", ["fit", "overflow"])
def test_collate_bsp_fields_match_jax(cap):
    """Every field of the port's collate with ``bsp_chunks_cap`` against
    the JAX collate's (a cap of 3 chunks overflows: no plan, no copies);
    the src-major plan has one array more, ``fwd_slot``: each real slot's
    dst-major slot of the same edge, -1 on pad slots."""
    graphs, _ = _graphs()
    kw = _bsp_kw(None if cap == "fit" else 3)
    want = jb.collate(graphs, *CAPS, **kw)
    got = tb.collate(graphs, *CAPS, **kw)
    assert (got.bsp_fwd is None) == (cap == "overflow")
    for f in dataclasses.fields(got):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(b, dict):
            assert sorted(set(b) - set(a)) == (
                ["fwd_slot"] if f.name == "bsp_bwd" else []), f.name
            assert set(a) <= set(b), f.name
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), b[k])
                assert np.asarray(a[k]).dtype == b[k].dtype, (f.name, k)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
            assert np.asarray(a).dtype == b.dtype, f.name
        else:
            assert a == b or (a is None and b is None), f.name
    if cap == "fit":
        C = got.bsp_fwd["blk_out"].shape[0]
        pf, pb = (jbp.build_block_plan(want.edge_src, want.edge_dst,
                                       want.edge_mask, CAPS[1], C, major)
                  ["perm"] for major in ("dst", "src"))
        fwd_slot = got.bsp_bwd["fwd_slot"]
        real = pb >= 0
        assert fwd_slot.dtype == np.int32 and (fwd_slot[~real] == -1).all()
        np.testing.assert_array_equal(pf[fwd_slot[real]], pb[real])
    # a node cap off the block size gets no plans
    assert tb.collate(graphs, 7, 650, 2048, **kw).bsp_fwd is None


def test_batch_to_moves_the_plans():
    graphs, _ = _graphs()
    b = tb.collate(graphs, *CAPS, **_bsp_kw()).to("cpu")
    for plan, more in ((b.bsp_fwd, []), (b.bsp_bwd, ["fwd_slot"])):
        assert sorted(plan) == sorted(["blk_in", "blk_out", "is_first",
                                       "loc_in", "loc_out", "mask"] + more)
        assert all(isinstance(v, torch.Tensor) for v in plan.values())
        assert plan["blk_out"].dtype == torch.int32
    assert isinstance(b.edge_attr_bsp_bwd, torch.Tensor)


# ---- K8 ---------------------------------------------------------------------


def _k8_case(d=128, seed=0):
    """A bsp batch's plans with random x and emb (the two emb copies are
    the same random per-edge rows in each plan's order, as one encoder
    makes them) and GCN-style slot weights."""
    graphs, _ = _graphs(seed=seed + 5)
    b = tb.collate(graphs, *CAPS, **_bsp_kw())
    rng = np.random.default_rng(seed)
    N, E = CAPS[1], CAPS[2]
    x = rng.standard_normal((N, d)).astype(np.float32)
    per_edge = rng.standard_normal((E, d)).astype(np.float32)
    perm = {}
    for major in ("dst", "src"):
        perm[major] = tbp.build_block_plan(b.edge_src, b.edge_dst,
                                           b.edge_mask, N, b.bsp_fwd[
                                               "blk_out"].shape[0], major
                                           )["perm"]
    emb_f = tbp.permute_edge_data(per_edge, perm["dst"])
    emb_b = tbp.permute_edge_data(per_edge, perm["src"])
    vals = rng.uniform(0.2, 1.0, N).astype(np.float32)
    w_f = tbp.permute_edge_data(vals[b.edge_src] * vals[b.edge_dst],
                                perm["dst"])
    w_b = tbp.permute_edge_data(vals[b.edge_src] * vals[b.edge_dst],
                                perm["src"])
    return b, x, emb_f, emb_b, w_f, w_b


def _jplan(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _tplan(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [False, True])
def test_k8_plain_and_vjp_match_jax_kernel(message, weighted):
    """The plain forward within 1e-5 of the interpret-mode Pallas kernel;
    dx and d_emb (autograd through the plain version, and the plain
    versions of the d_emb and dx kernels) within 5e-4 of max(1, max|ref|)
    of its VJP; emb_bwd's cotangent is zero on both sides."""
    b, x, ef, eb, wf, wb = _k8_case(seed=1 + weighted)
    if not weighted:
        wf = wb = None
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    pf, pb = _jplan(b.bsp_fwd), _jplan(b.bsp_bwd)
    jw = [None if w is None else jnp.asarray(w) for w in (wf, wb)]
    want, vjp = jax.vjp(
        lambda a, e1, e2: jk8.blocked_gather_message_scatter(
            a, e1, e2, pf, pb, *jw, message=message, interpret=True),
        *(jnp.asarray(a) for a in (x, ef, eb)))
    want = np.asarray(want)
    jdx, jdemb, jdemb_b = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    assert not jdemb_b.any()

    tf, tbk = _tplan(b.bsp_fwd), _tplan(b.bsp_bwd)
    t = [torch.from_numpy(a) for a in (x, ef, eb)]
    tw = [None if w is None else torch.from_numpy(w) for w in (wf, wb)]
    got = blocked_gather_message_scatter_plain(*t, tf, tbk, *tw, message)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    # CPU tensors take the plain versions through the wrappers, uncounted
    counts = [f.launches for f in (blocked_gather_message_scatter,
                                   blocked_gather_message_scatter_demb,
                                   blocked_gather_message_scatter_dx)]
    leaves = [a.clone().requires_grad_() for a in t]
    out = blocked_gather_message_scatter(*leaves, tf, tbk, *tw, message)
    np.testing.assert_array_equal(out.detach().numpy(), got.numpy())
    tg = torch.from_numpy(g)
    dx, demb, demb_b = torch.autograd.grad(out, leaves, tg,
                                           allow_unused=True)
    assert demb_b is None
    ref_dx, ref_demb = blocked_gather_message_scatter_bwd_plain(
        *t, tf, tbk, tg, *tw, message)
    kdemb = blocked_gather_message_scatter_demb(t[0], tg, t[1], tf, tw[0],
                                                message)
    kdx = blocked_gather_message_scatter_dx(t[0], tg, t[2], tbk, tw[1],
                                            message)
    assert counts == [f.launches for f in (
        blocked_gather_message_scatter, blocked_gather_message_scatter_demb,
        blocked_gather_message_scatter_dx)]
    for name, ours, ref in (("dx", dx, jdx), ("d_emb", demb, jdemb),
                            ("bwd_plain dx", ref_dx, jdx),
                            ("bwd_plain d_emb", ref_demb, jdemb),
                            ("dx kernel's plain", kdx, jdx),
                            ("d_emb kernel's plain", kdemb, jdemb)):
        np.testing.assert_allclose(
            ours.numpy(), ref, rtol=0, err_msg=name,
            atol=GRAD_TOL * max(1.0, np.abs(ref).max()))
    real = b.bsp_fwd["mask"].reshape(-1) > 0
    assert not kdemb.numpy()[~real].any()        # slots that are not real


def test_k8_refuses_weight_gradients_and_bad_messages():
    b, x, ef, eb, wf, wb = _k8_case()
    t = [torch.from_numpy(a) for a in (x, ef, eb)]
    tf, tbk = _tplan(b.bsp_fwd), _tplan(b.bsp_bwd)
    w = torch.from_numpy(wf).requires_grad_()
    with pytest.raises(ValueError, match="gradient"):
        blocked_gather_message_scatter(*t, tf, tbk, w, torch.from_numpy(wb))
    with pytest.raises(ValueError, match="both"):
        blocked_gather_message_scatter(*t, tf, tbk, torch.from_numpy(wf))
    with pytest.raises(ValueError, match="message"):
        blocked_gather_message_scatter(*t, tf, tbk, message="max")
    with torch.no_grad():                  # no gradient asked: no refusal
        blocked_gather_message_scatter(*t, tf, tbk, w, torch.from_numpy(wb))
    with pytest.raises(ValueError, match="mode"):
        tbp.set_block_spmm(torch.nn.Linear(2, 2), "maybe")


# ---- GCNConv and the code2 model on the blocked route -----------------------


def test_gcn_conv_blocked_matches_jax_and_k7_route(monkeypatch):
    """The port's GCNConv with plans and the switch on against the JAX
    GCNConv under set_block_spmm("on") with the kernel in interpret mode:
    outputs within 1e-4 and every gradient (lin, root_emb, the edge
    encoder, h) within 5e-4 of max(1, max|ref|); the same layer on the K7
    route (switch off, or a batch without plans) agrees as closely."""
    graphs, _ = _graphs(seed=7)
    kw = _bsp_kw()
    jbatch = jb.collate(graphs, *CAPS, **kw)
    batch = tb.collate(graphs, *CAPS, **kw).to("cpu")
    d = 32
    rng = np.random.default_rng(3)
    h = rng.standard_normal((CAPS[1], d)).astype(np.float32)
    h[~jbatch.node_mask] = 0
    jconv = JGCNConv(emb_dim=d, edge_encoder=JLinearEdge(d))
    v = jconv.init(jax.random.key(0), jbatch, jnp.asarray(h), False)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(
            np.float32), jax.device_get(v["params"]))
    monkeypatch.setattr(jbp, "_BLOCK_SPMM", "on")
    monkeypatch.setattr(jbp, "_BLOCK_SPMM_INTERPRET", True)

    def jloss(p, hh):
        out = jconv.apply({"params": p}, jbatch, hh, False)
        return jnp.sum(out ** 2), out

    (_, jout), (jgp, jgh) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))

    conv = GCNConv(d, LinearEdgeEncoder(d))
    with torch.no_grad():
        conv.lin.weight.copy_(torch.from_numpy(params["TDense_0"]["kernel"].T))
        conv.lin.bias.copy_(torch.from_numpy(params["TDense_0"]["bias"]))
        enc = params["edge_encoder"]["TDense_0"]
        conv.edge_encoder.lin.weight.copy_(torch.from_numpy(enc["kernel"].T))
        conv.edge_encoder.lin.bias.copy_(torch.from_numpy(enc["bias"]))
        conv.root_emb.copy_(torch.from_numpy(params["root_emb"]))
    tbp.set_block_spmm(conv, "on")
    hl = torch.from_numpy(h).requires_grad_()
    counts = (blocked_gather_message_scatter.launches, spmm.launches)
    out = conv(batch, hl)
    (out ** 2).sum().backward()
    assert counts == (blocked_gather_message_scatter.launches, spmm.launches)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=LOGITS_TOL, rtol=0)
    pairs = [(hl.grad, jgh), (conv.lin.weight.grad,
                              jgp["TDense_0"]["kernel"].T),
             (conv.lin.bias.grad, jgp["TDense_0"]["bias"]),
             (conv.root_emb.grad, jgp["root_emb"]),
             (conv.edge_encoder.lin.weight.grad,
              jgp["edge_encoder"]["TDense_0"]["kernel"].T),
             (conv.edge_encoder.lin.bias.grad,
              jgp["edge_encoder"]["TDense_0"]["bias"])]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * max(1.0,
                                                       np.abs(want).max()))
    # the K7 route: the switch off, and a batch without plans
    k7_batch = dataclasses.replace(batch, bsp_fwd=None, bsp_bwd=None)
    with torch.no_grad():
        blocked = conv(batch, hl).numpy()
        on_k7 = conv(k7_batch, hl).numpy()
        tbp.set_block_spmm(conv, "off")
        off = conv(batch, hl).numpy()
    np.testing.assert_allclose(on_k7, blocked, atol=FWD_TOL, rtol=0)
    np.testing.assert_array_equal(off, on_k7)


# graphs in both packing tiers (384, 128), the blocked route in the two
# GCN layers, attention on the XLA route
SIZES = (200, 150, 60, 9, 100, 40)
MODEL_CAPS = (7, 640, 2048)


@pytest.fixture(scope="module")
def model_case():
    """A narrow code2 GraphTrans (emb 32, d_model 32, 2 GCN layers, 1
    encoder layer) with randomised variables on one bsp batch: the JAX
    model's logits, loss and gradients (BaseTrainer.make_grad_fn with the
    sequence loss, dropout off) on the blocked route in interpret mode."""
    graphs = []
    for k, n in enumerate(SIZES):
        graphs += ts.make_code_dataset(num_graphs=1, vocab_size=30,
                                       seq_len_max=7, min_nodes=n,
                                       max_nodes=n, seed=20 + k)
    v2i, _ = tv.get_vocab_mapping([g["y_seq"] for g in graphs], 30)
    graphs = [dict(tv.augment_edge(g), _id=i,
                   y_arr=tv.encode_seq_to_arr(g["y_seq"], v2i, SEQ))
              for i, g in enumerate(graphs)]
    num_tasks = len(v2i)
    kw = dict(num_tasks=num_tasks, max_seq_len=SEQ, y_dtype="int32",
              seq_pack_w=384, seq_pack_w2=128,
              bsp_chunks_cap=tbp.chunk_capacity(MODEL_CAPS[2],
                                                MODEL_CAPS[1]))
    jbatch = jb.collate(graphs, *MODEL_CAPS, **kw)
    batch = tb.collate(graphs, *MODEL_CAPS, **kw).to("cpu")
    assert batch.bsp_fwd is not None and batch.pack2_w == 128
    hp = _hp(32, 32)
    hp.lr, hp.weight_decay, hp.grad_clip = 1e-4, 0.0, None
    hp.scheduler, hp.epochs = None, 1
    jmodel = MODELS["gnn-transformer"].build(
        num_tasks, hp, JASTNodeEncoder(32, num_nodetypes=TYPES,
                                       num_nodeattributes=ATTRS,
                                       max_depth=20),
        lambda e: JLinearEdge(e))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(13)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbp, "_BLOCK_SPMM", "on")
        mp.setattr(jbp, "_BLOCK_SPMM_INTERPRET", True)
        logits = np.asarray(jax.jit(lambda v: jmodel.apply(
            v, jbatch, None, False))({"params": params,
                                      "batch_stats": stats}))
        grad_fn = jax.jit(BaseTrainer.make_grad_fn(
            jmodel, jlosses.seq_token_loss, hp))
        jgrads, _, jloss = jax.device_get(grad_fn(
            TrainState.create(params, stats, None), jbatch,
            jax.random.key(2)))
    make = lambda: GNNTransformer(
        num_tasks, 2, 32, True, 32, 4, 64, 1, True, gnn_type="gcn",
        node_encoder=ASTNodeEncoder(32, TYPES, ATTRS), max_seq_len=SEQ)
    return dict(batch=batch, make=make, params=params, stats=stats,
                logits=logits, jgrads=jgrads, jloss=float(jloss))


def _blocked_model(c):
    model = load_flax_variables(c["make"](), c["params"], c["stats"])
    return tbp.set_block_spmm(model, "on")


def test_code2_model_blocked_logits_match_jax(model_case):
    c = model_case
    b = c["batch"]
    model = _blocked_model(c).eval()
    with torch.no_grad():
        got = model(b).numpy()
        k7 = tbp.set_block_spmm(model, "off")(b).numpy()
    gm = b.graph_mask.numpy()
    np.testing.assert_allclose(got[gm], c["logits"][gm], atol=LOGITS_TOL,
                               rtol=0)
    np.testing.assert_allclose(got[gm], k7[gm], atol=LOGITS_TOL, rtol=0)


def test_code2_model_blocked_train_step_matches_jax(model_case):
    """One step's loss and every parameter gradient on the blocked route
    against the JAX model's, and against the port's K7 route."""
    c = model_case
    b = c["batch"]
    grads = []
    for mode in ("on", "off"):
        model = tbp.set_block_spmm(_blocked_model(c), mode).train()
        loss = seq_token_loss(model(b, Generators.seeded(0, "cpu")), b)
        loss.backward()
        np.testing.assert_allclose(loss.item(), c["jloss"], atol=LOGITS_TOL,
                                   rtol=0)
        grads.append({n: p.grad.numpy() for n, p in model.named_parameters()})
    twin = load_flax_variables(c["make"](), c["jgrads"], c["stats"])
    want = {k: v.numpy() for k, v in twin.state_dict().items()}
    for name, g in grads[0].items():
        for ref, what in ((want[name], "jax"), (grads[1][name], "k7 route")):
            np.testing.assert_allclose(
                g, ref, rtol=0, err_msg=f"{name} vs {what}",
                atol=GRAD_TOL * max(1.0, np.abs(ref).max()))


# ---- K12 --------------------------------------------------------------------


def test_segment_sum_mxu_matches_jax_kernel():
    """K12's plain version within 1e-5 of the interpret-mode Pallas kernel
    over sorted dsts with out-of-range edges at both ends (uncounted), and
    through the wrapper on CPU tensors (no launch counted)."""
    rng = np.random.default_rng(4)
    N, E, d = 512, 1024, 128
    msg = rng.standard_normal((E, d)).astype(np.float32)
    dst = np.sort(np.concatenate([rng.integers(0, N, E - 40),
                                  np.full(20, -1), np.full(20, N)])
                  ).astype(np.int32)
    want = np.asarray(jk12.segment_sum_mxu(jnp.asarray(msg),
                                           jnp.asarray(dst), N,
                                           interpret=True))
    t_msg, t_dst = torch.from_numpy(msg), torch.from_numpy(dst)
    got = segment_sum_mxu_plain(t_msg, t_dst, N)
    assert got.dtype == torch.float32 and got.shape == (N, d)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)
    before = segment_sum_mxu.launches
    np.testing.assert_array_equal(segment_sum_mxu(t_msg, t_dst, N).numpy(),
                                  got.numpy())
    assert segment_sum_mxu.launches == before


@pytest.mark.parametrize("shape", [(1024, 100, 512), (1024, 128, 500),
                                   (1000, 128, 512)])
def test_segment_sum_mxu_refuses_the_jax_shapes(shape):
    """None where the JAX function returns None: d % 128, N % 256 or
    E % 256 not 0."""
    E, d, N = shape
    msg = np.zeros((E, d), np.float32)
    dst = np.zeros(E, np.int32)
    assert jk12.segment_sum_mxu(jnp.asarray(msg), jnp.asarray(dst), N,
                                interpret=True) is None
    for fn in (segment_sum_mxu, segment_sum_mxu_plain):
        assert fn(torch.from_numpy(msg), torch.from_numpy(dst), N) is None
