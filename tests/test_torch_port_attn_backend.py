"""The port's attention-backend switch against the JAX package: K9's
(``attention_smallS``) and K10's (``fused_transformer_layer``) plain versions
against the Pallas kernels in interpret mode, forward and gradients, with
and without dropout; the route each backend takes; the Transformer-only
encoder under smalls, packed_smalls and packed_layer with converted
weights; one train step under packed_layer with dropout; and the flag of
the entry points."""

import argparse
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import AtomEncoder as JAtomEncoder  # noqa: E402
from graphtrans_tpu.ops.pallas import attention_smallS as jas  # noqa: E402
from graphtrans_tpu.ops.pallas import prng as jprng  # noqa: E402
from graphtrans_tpu.ops.pallas import transformer_layer as jtl  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.models.transformer import (  # noqa: E402
    TransformerModule)
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import AtomEncoder  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_smalls_bwd_plain, attention_smalls_plain,
    transformer_layer_bwd_plain, transformer_layer_plain)
from graphtrans_tpu_torch.train.losses import (  # noqa: E402
    binary_multitask_loss)
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
MOL_CONFIG = REPO / "configs/molpcba/transformer/pooling=cls.yml"
SNAPSHOT = str(REPO / "data_snapshots")
OUT_TOL = 2e-5    # kernel functions forward: f32, sums in another order
GRAD_TOL = 5e-4   # gradients, of max(1, max |reference|)
TOL = 1e-4        # logits and loss: f32 LN chains
RATE, SEED = 0.3, 1234567


def _heads(t, H):
    """[B, S, d] -> [B*H, S, hd] (the JAX kernel's layout)."""
    B, S, d = t.shape
    return np.asarray(t).reshape(B, S, H, d // H).transpose(0, 2, 1, 3) \
        .reshape(B * H, S, d // H)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())


def _interpret_keep(shape, rate, seed):
    """K9's keep mask drawn from its package's interpret-mode hash instead
    of the TPU PRNG."""
    thresh = jnp.uint32(min(max(1.0 - rate, 0.0), 1.0) * 0xFFFFFFFF)
    bits = jprng.random_bits_u32(shape, seed, interpret=True)
    return (bits < thresh).astype(jnp.float32)


# ---- K9 -------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("block", [0, 11])
def test_k9_plain_matches_jax_kernel(block, hd, rate, monkeypatch):
    """K9's plain version against ``attention_smallS`` in interpret mode
    (its ``_keep_mask`` on the package's interpret hash) at rows of 33 (3
    graphs of 11 with ``block``), 9 rows x 2 heads = two programs of 16
    pairs: forward, and dq, dk, dv through ``jax.vjp``; a query without a
    key gives zeros."""
    monkeypatch.setattr(jas, "_keep_mask", _interpret_keep)
    B, S, H = 9, 33, 2
    d = H * hd
    rng = np.random.default_rng(hd + block)
    qkv = rng.standard_normal((B, S, 3 * d)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    dead = slice(block, 2 * block) if block else slice(0, S)
    valid[1, dead] = False
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    q, k, v = (jnp.asarray(_heads(t, H)) for t in np.split(qkv, 3, -1))
    kvm = jnp.asarray(np.repeat(valid, H, 0))
    want, vjp = jax.vjp(lambda a, b, c: jas.attention_smallS(
        a, b, c, kvm, SEED, rate, True, True, block), q, k, v)
    args = (torch.from_numpy(qkv), torch.from_numpy(valid), H, block)
    got = attention_smalls_plain(*args, rate, SEED).numpy()
    np.testing.assert_allclose(_heads(got, H), np.asarray(want),
                               atol=OUT_TOL, rtol=0)
    dqkv = attention_smalls_bwd_plain(*args[:3], torch.from_numpy(g), block,
                                      rate, SEED).numpy()
    for mine, theirs in zip(np.split(dqkv, 3, -1),
                            vjp(jnp.asarray(_heads(g, H)))):
        assert _rel(_heads(mine, H), theirs) <= GRAD_TOL
    assert not got[1, dead].any()
    if rate:
        assert np.abs(got - attention_smalls_plain(*args).numpy()).max() > 0.1


# ---- K10 ------------------------------------------------------------------


def _layer_inputs(d, ff, seed):
    """x [10, 36, d] (two 8-row programs, the second ragged), graphs of 12
    tokens, and the layer's parameters in the flax layout."""
    rng = np.random.default_rng(seed)
    B, S = 10, 36
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[:, 11::12] = True                      # each graph's CLS
    valid[2, 12:24] = False                      # a graph block with no key
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    b = lambda n: (0.1 * rng.standard_normal(n)).astype(np.float32)
    flax = [f(d, 3 * d), b(3 * d), f(d, d), b(d), 1 + b(d), b(d), f(d, ff),
            b(ff), f(ff, d), b(d), 1 + b(d), b(d)]
    return x, valid, flax


def _torch_params(flax):
    """The flax layout ([in, out] kernels) as nn.Linear's [out, in]."""
    return [torch.from_numpy(np.ascontiguousarray(p.T if p.ndim == 2 else p))
            for p in flax]


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("d,H", [(128, 4), (256, 4)])
def test_k10_plain_matches_jax_kernel(d, H, rate):
    """K10's plain version against ``fused_transformer_layer`` in interpret
    mode (its masks are interpret-hashable as they are): the output, dx and
    all twelve parameter gradients through ``jax.vjp``."""
    ff, block = 2 * d, 12
    x, valid, flax = _layer_inputs(d, ff, d + int(rate * 10))
    g = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    fn = lambda xx, *ps: jtl.fused_transformer_layer(
        xx, jnp.asarray(valid), SEED, *ps, H, rate, "relu", rate > 0.0,
        block, True)
    want, vjp = jax.vjp(fn, jnp.asarray(x), *map(jnp.asarray, flax))
    params = _torch_params(flax)
    got = transformer_layer_plain(torch.from_numpy(x), torch.from_numpy(valid),
                                  params, H, block, rate, SEED).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=OUT_TOL, rtol=0)
    grads = transformer_layer_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(valid), params, H, block,
        torch.from_numpy(g), rate, SEED)
    theirs = vjp(jnp.asarray(g))
    for i, (mine, ref) in enumerate(zip(grads, theirs)):
        ref = np.asarray(ref)
        mine = mine.numpy()
        assert _rel(mine.T if mine.ndim == 2 else mine, ref) <= GRAD_TOL, i
    if rate:
        rest = transformer_layer_plain(torch.from_numpy(x),
                                       torch.from_numpy(valid), params, H,
                                       block).numpy()
        assert np.abs(got - rest).max() > 0.1


# ---- the route table ------------------------------------------------------

UNPACKED = [  # (backend, nodes + CLS, d): (graphs a row, route)
    ("auto", 33, 256, 3, "k4"), ("auto", 33, 64, 3, "plain"),
    ("auto", 65, 256, 1, "plain"), ("auto", 257, 256, 1, "k4"),
    ("auto", 257, 64, 1, "plain"), ("auto", 449, 256, 1, "plain"),
    ("auto", 513, 64, 1, "k5"),
    ("packed", 33, 256, 3, "plain"), ("packed_smalls", 33, 256, 3, "k9"),
    ("packed_smalls", 49, 64, 2, "k9"), ("packed_fused", 49, 256, 2, "k4"),
    ("packed_fused", 49, 64, 2, "plain"),
    ("packed_layer", 33, 256, 3, "k10"), ("packed_layer", 49, 128, 2, "k10"),
    ("packed_layer", 33, 64, 3, "plain"), ("packed_layer", 129, 256, 1,
                                           "plain"),
    ("smalls", 33, 256, 1, "k9"), ("smalls", 449, 64, 1, "k9"),
    ("flash", 49, 256, 1, "k5"), ("flash", 257, 64, 1, "k5"),
    ("chunked", 49, 256, 1, "chunked"), ("chunked", 600, 64, 1, "chunked"),
    ("dense", 33, 256, 1, "plain"), ("dense", 257, 256, 1, "plain"),
    ("packed", 129, 256, 1, "plain"), ("packed_smalls", 129, 256, 1, "plain"),
    ("packed_fused", 257, 256, 1, "plain")]
SEG = [  # (backend, row width, d): route
    ("auto", 128, 128, "k2"), ("packed_fused", 384, 128, "k2"),
    ("auto", 512, 128, "k3"), ("flash", 512, 128, "k3"),
    ("flash", 384, 128, "k5"), ("auto", 256, 64, "k5"),
    ("auto", 128, 64, "plain"), ("flash", 128, 128, "plain"),
    ("smalls", 128, 128, "plain"), ("packed_layer", 128, 128, "plain"),
    ("dense", 384, 128, "plain"), ("packed_fused", 512, 128, "plain")]
CALLED = {"k2": "attention_seg", "k3": "flash_hil_seg",
          "k4": "attention_dense", "k5": "flash_attention",
          "k9": "attention_smalls", "k10": "transformer_layer",
          "chunked": "attention_dense_plain", "plain": "attention_dense_plain"}


def _spy(monkeypatch) -> list:
    calls = []
    for name in set(CALLED.values()) | {"attention_seg_plain"}:
        fn = getattr(ttr, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(ttr, name, wrapped)
    return calls


@pytest.mark.parametrize("backend,S,d,gb,route", UNPACKED)
def test_route_table_unpacked(backend, S, d, gb, route, monkeypatch):
    """Each backend's route for unpacked rows of S tokens (the JAX
    package's TPU branch), and the one wrapper the encoder calls for it."""
    assert ttr.graphs_per_row(S, backend) == gb
    block = S if gb > 1 else 0
    assert ttr.attention_route(backend, gb * S, d, block) == route
    calls = _spy(monkeypatch)
    enc = ttr.set_attn_backend(ttr.TransformerNodeEncoder(d, 2, d, 1),
                               backend).eval()
    with torch.no_grad():
        out = enc(torch.randn(2, S - 1, d), torch.ones(2, S - 1,
                                                       dtype=torch.bool))
    assert out.shape == (2, S, d) and torch.isfinite(out).all()
    assert calls == [CALLED[route]]


@pytest.mark.parametrize("backend,W,d,route", SEG)
def test_route_table_seg(backend, W, d, route, monkeypatch):
    """Each backend's route for GraphTrans's packed rows of W tokens, and
    the one wrapper the encoder calls for it."""
    assert ttr.attention_route(backend, W, d, seg=True) == route
    calls = _spy(monkeypatch)
    enc = ttr.set_attn_backend(ttr.TransformerNodeEncoder(d, 4, d, 1),
                               backend).eval()
    seg = (torch.arange(W) // 40).int()[None]
    seg[:, -5:] = -1
    with torch.no_grad():
        out = enc(torch.randn(1, W, d), seg=seg,
                  cls_mask=torch.zeros(1, W, dtype=torch.bool))
    assert torch.isfinite(out).all()
    assert calls == [{"plain": "attention_seg_plain"}.get(route,
                                                          CALLED[route])]


def test_set_attn_backend_names_and_models_apart():
    """The nine names of the JAX package's ``set_attn_backend``; anything
    else raises; a backend belongs to its model alone."""
    assert ttr.BACKENDS == ("auto", "flash", "smalls", "chunked", "dense",
                            "packed", "packed_smalls", "packed_fused",
                            "packed_layer")
    a = ttr.TransformerNodeEncoder(128, 2, 128, 1)
    b = ttr.TransformerNodeEncoder(128, 2, 128, 1)
    for name in ttr.BACKENDS:
        assert ttr.set_attn_backend(a, name) is a and a.attn_backend == name
    assert b.attn_backend == "auto"
    with pytest.raises(ValueError, match="packed_flash"):
        ttr.set_attn_backend(a, "packed_flash")


# ---- the encoder and the train step against the JAX package ---------------

D, H = 128, 2


def _hp(dropout=0.0):
    return argparse.Namespace(
        model_type="transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, d_model=D, nhead=H, dim_feedforward=2 * D,
        transformer_dropout=dropout, transformer_activation="relu",
        num_encoder_layers=2, max_input_len=1000, transformer_norm_input=True,
        max_seq_len=None, precision="f32", lr=1e-4, weight_decay=0.01,
        grad_clip=1.0, scheduler=None, epochs=1)


def _mol_batch(seed=11):
    """7 molecules (8 graph slots, rows of 33 tokens: 3 graphs a packed row
    of 99) in the flat layout."""
    graphs = ts.make_mol_dataset(num_graphs=7, num_tasks=6, min_nodes=3,
                                 max_nodes=30, seed=seed)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", dense_cap=32)
    return (jb.collate(graphs, 8, 256, 1024, **kw),
            tb.collate(graphs, 8, 256, 1024, **kw).to("cpu"))


def _noisy(v, seed):
    rng = np.random.default_rng(seed)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    return jax.tree_util.tree_map(noise, jax.device_get(v["params"]))


def _jax_backend(mp, backend) -> list:
    """Put the JAX module on ``backend`` with its kernels in interpret
    mode; returns the list that counts its K9 or K10 calls."""
    mp.setattr(jtr, "_ATTN_BACKEND", backend)
    mp.setattr(jtr, "_PFUSED_INTERPRET", True)
    calls = []
    orig_k9, orig_k10 = jas.attention_smallS, jtl.fused_transformer_layer

    def k9(q, k, v, kvm, seed, rate=0.0, training=False, interpret=False,
           block=0):
        calls.append("k9")
        return orig_k9(q, k, v, kvm, seed, rate, training, True, block)

    def k10(*a):
        calls.append("k10")
        return orig_k10(*a)

    mp.setattr(jas, "attention_smallS", k9)
    mp.setattr(jtl, "fused_transformer_layer", k10)
    return calls


@pytest.mark.parametrize("backend,jax_calls", [
    ("smalls", ["k9", "k9"]), ("packed_smalls", []),
    ("packed_layer", ["k10", "k10"])])
def test_encoder_matches_jax_under_backend(backend, jax_calls, monkeypatch):
    """The whole Transformer-only forward (2 layers, d 128, rows of 33)
    under each backend against ``TransformerModule.apply(training=False)``
    under the same backend: smalls through K9 in interpret mode, packed_layer
    through K10 in interpret mode (whose variable tree is the unfused one's,
    so the same converted weights load), packed_smalls through the JAX
    package's off-TPU route for it, the dense block mask. The port's route
    is K9 or K10 (their plain versions on the CPU)."""
    jbatch, batch = _mol_batch()
    jmodel = MODELS["transformer"].build(6, _hp(), JAtomEncoder(D), None)
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    params = _noisy(v, 5)
    calls = _jax_backend(monkeypatch, backend)
    if backend == "packed_layer":
        vf = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
        shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
        assert shapes(vf["params"]) == shapes(v["params"])
        calls.clear()
    want = np.asarray(jmodel.apply({"params": params}, jbatch, None, False))
    assert calls == jax_calls
    tmodel = TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000, True)
    load_flax_variables(tmodel, params, {})
    ttr.set_attn_backend(tmodel, backend).eval()
    tcalls = _spy(monkeypatch)
    with torch.no_grad():
        got = tmodel(batch).numpy()
    assert tcalls == [{"packed_layer": "transformer_layer"}.get(
        backend, "attention_smalls")] * 2
    gm = batch.graph_mask.numpy()
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


def test_packed_layer_train_step_matches_jax(monkeypatch):
    """One forward and backward in training mode (dropout 0.3) under
    packed_layer against ``BaseTrainer.make_grad_fn`` with K10 in interpret
    mode, both sides given the same per-layer seeds: the loss and every
    gradient."""
    seeds = [SEED, 2**31 - 7]
    jbatch, batch = _mol_batch(12)
    hp = _hp(RATE)
    jmodel = MODELS["transformer"].build(6, hp, JAtomEncoder(D), None)
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    params = _noisy(v, 8)
    _jax_backend(monkeypatch, "packed_layer")
    orig = jtl.fused_transformer_layer
    drawn = iter(seeds)

    def seeded(x, valid, seed, *rest):
        return orig(x, valid, next(drawn), *rest)

    monkeypatch.setattr(jtl, "fused_transformer_layer", seeded)
    grad_fn = BaseTrainer.make_grad_fn(jmodel, jlosses.binary_multitask_loss,
                                       hp)
    jgrads, _, jloss = jax.device_get(grad_fn(
        TrainState.create(params, {}, None), jbatch, jax.random.key(2)))
    model = TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000, True,
                              transformer_dropout=RATE)
    load_flax_variables(model, params, {})
    ttr.set_attn_backend(model, "packed_layer").train()
    gen = Generators.seeded(0, "cpu")
    gen.kernel_seed = iter(seeds).__next__
    loss = binary_multitask_loss(model(batch, gen), batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=0)
    want = load_flax_variables(
        TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000, True),
        jgrads, {}).state_dict()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        ref = want[name].numpy()
        assert _rel(p.grad.numpy(), ref) <= GRAD_TOL, name
    same = TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000, True,
                             transformer_dropout=RATE)
    load_flax_variables(same, params, {})
    other = binary_multitask_loss(same.train()(batch, Generators.seeded(
        0, "cpu")), batch)
    assert abs(other.item() - loss.item()) > 1e-4   # auto: other masks


# ---- the entry points -----------------------------------------------------


def test_entry_points_take_the_root_parsers_backends():
    """``--attn_backend`` of predict and main: the root main.py's choices
    and default; packed_fused and packed_layer stay programmatic."""
    import main as root_main

    def choices(parser):
        act = next(a for a in parser._actions if a.dest == "attn_backend")
        return act.choices, act.default

    want = choices(root_main.build_parser())
    assert tuple(want[0]) == ttr.CLI_BACKENDS and want[1] == "auto"
    for parser in (predict.build_parser(), tmain.build_parser()):
        got = choices(parser)
        assert tuple(got[0]) == tuple(want[0]) and got[1] == want[1]
    with pytest.raises(SystemExit):
        predict.build_parser().parse_args(["--attn_backend", "packed_layer"])


def test_predict_and_main_apply_the_backend(tmp_path, capsys, monkeypatch):
    """predict serves and main trains the molpcba Transformer-only yml at
    narrow widths on the CPU under ``--attn_backend smalls``: every layer
    of every batch goes through K9's wrapper; one model's backend does not
    reach another."""
    calls = []
    orig = ttr.attention_smalls

    def spy(*a, **k):
        calls.append(a[0].shape[1])
        return orig(*a, **k)

    monkeypatch.setattr(ttr, "attention_smalls", spy)
    argv = ["--configs", str(MOL_CONFIG), "--data_root", SNAPSHOT, "--seed",
            "0", "--device", "cpu", "--d_model", "128",
            "--num_encoder_layers", "1", "--attn_backend", "smalls"]
    out = tmp_path / "p.jsonl"
    res = predict.main([*argv, "--split", "valid", "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert res["records"] == len(recs) == 24
    assert calls == [49] * res["batches"]
    calls.clear()
    trained = tmain.main([*argv, "--epochs", "1"])
    assert calls and set(calls) == {49}
    assert np.isfinite(trained["epochs"][0]["loss"])
    args = predict.parse_with_config(predict.build_parser(), argv)
    splits, num_tasks, _ = predict.load_splits(args)
    a = predict.build_model(args, num_tasks, "cpu")
    args.attn_backend = "auto"
    b = predict.build_model(args, num_tasks, "cpu")
    assert a.transformer.attn_backend == "smalls"
    assert b.transformer.attn_backend == "auto"
