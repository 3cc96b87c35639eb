"""The port's Transformer-only GraphTrans (model_type transformer) against
the JAX package: K4's and K5's plain versions against the Pallas kernels in
interpret mode, ``nodes_to_dense``, the route each row width takes, and the
whole molpcba and code2 forwards with converted weights through the JAX
package's CPU routes and its interpret-mode kernels; then the entry
points."""

import argparse
import importlib
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
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, AtomEncoder as JAtomEncoder)
from graphtrans_tpu.ops import dense as jdense  # noqa: E402
from graphtrans_tpu.ops.pallas import attention_packed as jap  # noqa: E402
from graphtrans_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.models import build_model  # noqa: E402
from graphtrans_tpu_torch.models.transformer import (  # noqa: E402
    TransformerModule)
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import (  # noqa: E402
    ASTNodeEncoder, AtomEncoder)
from graphtrans_tpu_torch.ops.dense import nodes_to_dense  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_dense_plain, flash_attention_plain, key_padding_segs)
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import _tier_graphs  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

# the module (the package exports its wrapper under the same name)
tfa_mod = importlib.import_module(
    "graphtrans_tpu_torch.ops.kernels.flash_attention")

REPO = pathlib.Path(__file__).resolve().parents[1]
MOL_CONFIG = REPO / "configs/molpcba/transformer/pooling=cls.yml"
CODE2_CONFIG = REPO / "configs/code2/transformer/pooling=cls.yml"
SNAPSHOT = str(REPO / "data_snapshots")
ATT_TOL = 1e-5    # attention alone: f32, sums in another order
TOL = 1e-4        # logits: f32 LN chains; flax LayerNorm uses E[x^2]-E[x]^2
D, H = 128, 2     # d % 128 == 0 keeps the JAX K4 route; heads of 64
TYPES, ATTRS, SEQ = 20, 100, 5


def _qkv(B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, 3 * D)).astype(np.float32)


def _heads(qkv):
    """[B, S, 3d] -> q, k, v [B*H, S, hd] (the JAX kernel's layout)."""
    B, S, _ = qkv.shape
    return [t.reshape(B, S, H, D // H).transpose(0, 2, 1, 3)
            .reshape(B * H, S, D // H) for t in np.split(qkv, 3, axis=-1)]


def _unheads(o, B):
    S = o.shape[1]
    return np.asarray(o).reshape(B, H, S, D // H).transpose(0, 2, 1, 3) \
        .reshape(B, S, D)


@pytest.mark.parametrize("S,block", [(99, 33), (98, 49), (257, 0)])
def test_k4_plain_matches_jax_kernel(S, block):
    """K4's plain version against ``attention_packed_qkv`` in interpret
    mode, B = 5 (not a multiple of the kernel's row tile): padding queries
    inside a live block attend its valid keys; a block (block 0: a row)
    with no valid key gives exact zeros."""
    B = 5
    qkv = _qkv(B, S, S)
    rng = np.random.default_rng(S + 1)
    valid = rng.random((B, S)) < 0.7
    dead = slice(block, 2 * block) if block else slice(0, S)
    valid[1, dead] = False
    want = np.asarray(jap.attention_packed_qkv(
        jnp.asarray(qkv), jnp.asarray(valid), 0, H, 0.0, False, True, block))
    got = attention_dense_plain(torch.from_numpy(qkv),
                                torch.from_numpy(valid), H, block).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)
    assert not got[1, dead].any()
    live = np.ones((B, S), bool)
    live[1, dead] = False
    assert (np.abs(got[live]).sum(-1) > 0).all()
    assert (~valid & live).any()       # padding queries in live blocks


def _segs(B, S, form, rng):
    if form == "key_padding":
        valid = np.ones((B, S), bool)
        valid[0, 300:-1] = False       # a padded graph row, CLS last
        valid[1] = False               # a fully masked row
        return np.zeros((B, S), np.int32), np.where(valid, 0, -1).astype(
            np.int32), valid
    seg = np.full((B, S), -1, np.int32)
    seg[0, :200], seg[0, 200:450] = 0, 1
    seg[2, 10:500] = 3
    return seg, seg, None


@pytest.mark.parametrize("form", ["key_padding", "seg"])
def test_k5_plain_matches_jax_kernel(form, monkeypatch):
    """K5's plain version against ``flash_attention`` and
    ``flash_attention_seg`` in interpret mode at S = 520 (heads reshaped to
    the JAX kernel's [B*H, S, hd]); a query with no key gives exact zeros,
    and the plain version taken a row at a time equals it whole."""
    B, S = 3, 520
    qkv = _qkv(B, S, 7)
    segq, segk, valid = _segs(B, S, form, np.random.default_rng(0))
    q, k, v = (jnp.asarray(t) for t in _heads(qkv))
    per_head = lambda a: jnp.asarray(np.repeat(a, H, axis=0))
    if form == "key_padding":
        o = jfa.flash_attention(q, k, v, per_head(valid), 0, 0.0, False, True)
        tq, tk = key_padding_segs(torch.from_numpy(valid))
        assert (tq.numpy() == segq).all() and (tk.numpy() == segk).all()
    else:
        o = jfa.flash_attention_seg(q, k, v, per_head(segq), 0, 0.0, False,
                                    True)
    want = _unheads(o, B)
    args = (torch.from_numpy(qkv), torch.from_numpy(segq),
            torch.from_numpy(segk), H)
    got = flash_attention_plain(*args).numpy()
    np.testing.assert_allclose(got, want, atol=ATT_TOL, rtol=0)
    none = (segq[:, :, None] == segk[:, None, :]) & (segk >= 0)[:, None, :]
    none = ~none.any(-1)
    assert none.any() and not got[none].any()
    monkeypatch.setattr(tfa_mod, "PLAIN_SCORE_BYTES", 1)
    np.testing.assert_array_equal(flash_attention_plain(*args).numpy(), got)


@pytest.mark.parametrize("strided", [False, True])
def test_nodes_to_dense_matches_jax(strided):
    """Exact, with a graph past max_input_len (its last 40 nodes kept) in
    the flat layout; the strided layout is a reshape."""
    graphs = ts.make_mol_dataset(num_graphs=5, num_tasks=3, min_nodes=3,
                                 max_nodes=30 if strided else 50, seed=4)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    if strided:
        kw = dict(node_stride=32, dense_edge_cap=128)
        caps, S = (6, 6 * 32, 512), 32
    else:
        kw = dict(max_input_len=40, dense_cap=48)
        caps, S = (6, 512, 512), 40
        assert max(g["x"].shape[0] for g in graphs) > S
    want_b = jb.collate(graphs, *caps, num_tasks=3, y_dtype="float32", **kw)
    got_b = tb.collate(graphs, *caps, num_tasks=3, y_dtype="float32", **kw)
    h = np.random.default_rng(1).standard_normal(
        (caps[1], 16)).astype(np.float32)
    want = jdense.nodes_to_dense(h, want_b.node_graph, want_b.node_pos,
                                 want_b.node_mask, 6, S, want_b.node_stride)
    t = got_b.to("cpu")
    got = nodes_to_dense(torch.from_numpy(h), t.node_graph, t.node_pos,
                         t.node_mask, 6, S, t.node_stride)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


ROUTES = [  # (S with CLS, d): (graphs a row, route)
    (33, 256, 3, "k4"), (49, 256, 2, "k4"), (33, 32, 3, "plain"),
    (65, 256, 1, "plain"), (129, 256, 1, "k4"), (257, 256, 1, "k4"),
    (257, 32, 1, "plain"), (449, 256, 1, "plain"), (513, 256, 1, "k5"),
    (1001, 256, 1, "k5"), (1001, 32, 1, "k5")]


@pytest.mark.parametrize("S,d,gb,route", ROUTES)
def test_route_table(S, d, gb, route, monkeypatch):
    """The route the JAX package takes on a TPU for each row width under
    the default backend (auto), and the wrapper the port's encoder calls
    for it (every backend: test_torch_port_attn_backend.py)."""
    assert ttr.graphs_per_row(S) == gb
    block = S if gb > 1 else 0
    assert ttr.attention_route("auto", gb * S, d, block) == route
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        monkeypatch.setattr(ttr, name, wrapped)

    for name in ("attention_dense", "flash_attention",
                 "attention_dense_plain"):
        spy(name, getattr(ttr, name))
    enc = ttr.TransformerNodeEncoder(d, 2, 2 * d, 1).eval()
    valid = torch.ones(2, S - 1, dtype=torch.bool)
    with torch.no_grad():
        out = enc(torch.randn(2, S - 1, d), valid)
    assert out.shape == (2, S, d)
    assert calls == [{"k4": "attention_dense", "k5": "flash_attention",
                      "plain": "attention_dense_plain"}[route]]


def _hp(d_model, layers, max_input_len=1000, max_seq_len=None):
    return argparse.Namespace(
        model_type="transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, d_model=d_model, nhead=H,
        dim_feedforward=2 * d_model, transformer_dropout=0.0,
        transformer_activation="relu", num_encoder_layers=layers,
        max_input_len=max_input_len, transformer_norm_input=True,
        max_seq_len=max_seq_len)


def _noisy(v, seed):
    rng = np.random.default_rng(seed)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    return jax.tree_util.tree_map(noise, jax.device_get(v["params"]))


def _mol_case():
    """7 molecules (8 graph slots, not a multiple of the 3 graphs of 33
    tokens a packed row holds) in the flat layout."""
    graphs = ts.make_mol_dataset(num_graphs=7, num_tasks=6, min_nodes=3,
                                 max_nodes=30, seed=11)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", dense_cap=32)
    jbatch = jb.collate(graphs, 8, 256, 1024, **kw)
    batch = tb.collate(graphs, 8, 256, 1024, **kw)
    jmodel = MODELS["transformer"].build(6, _hp(D, 2), JAtomEncoder(D), None)
    tmodel = TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000,
                               True).eval()
    return jbatch, batch, jmodel, tmodel


def _code2_case():
    """Four ASTs, one past max_input_len 600 (rows of 601 take K5), with
    per-position heads."""
    graphs, num_tasks = _tier_graphs((700, 30, 250, 9), seed=3)
    kw = dict(num_tasks=num_tasks, max_seq_len=SEQ, y_dtype="int32",
              max_input_len=600, dense_cap=768)
    jbatch = jb.collate(graphs, 5, 1024, 4096, **kw)
    batch = tb.collate(graphs, 5, 1024, 4096, **kw)
    jmodel = MODELS["transformer"].build(
        num_tasks, _hp(D, 1, 600, SEQ),
        JASTNodeEncoder(D, num_nodetypes=TYPES, num_nodeattributes=ATTRS,
                        max_depth=20), None)
    tmodel = TransformerModule(num_tasks, ASTNodeEncoder(D, TYPES, ATTRS), D,
                               H, 2 * D, 1, 600, True,
                               max_seq_len=SEQ).eval()
    return jbatch, batch, jmodel, tmodel


@pytest.fixture(scope="module", params=["mol", "code2"])
def case(request):
    jbatch, batch, jmodel, tmodel = (_mol_case() if request.param == "mol"
                                     else _code2_case())
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    params = _noisy(v, 5)
    load_flax_variables(tmodel, params, {})
    return dict(kind=request.param, jbatch=jbatch, batch=batch.to("cpu"),
                jmodel=jmodel, tmodel=tmodel, params=params)


def _jax_kernel_route(kind, monkeypatch) -> list:
    """Route the JAX module through its TPU kernels in interpret mode:
    molpcba through ``packed_fused`` (gb-packed rows, K4 with a block),
    code2 through flash (as tests/test_flash_attention.py does). Returns
    the list that counts the kernel's calls."""
    calls = []
    if kind == "mol":
        monkeypatch.setattr(jtr, "_ATTN_BACKEND", "packed_fused")
        monkeypatch.setattr(jtr, "_PFUSED_INTERPRET", True)
        orig = jap.attention_packed_qkv

        def counted(*a):
            calls.append(a[-1])                  # the block
            return orig(*a)

        monkeypatch.setattr(jap, "attention_packed_qkv", counted)
        return calls
    orig = jfa.flash_attention

    def interp(q, k, v, kvm, seed, rate=0.0, training=False, interpret=False):
        calls.append(q.shape[1])
        return orig(q, k, v, kvm, seed, rate, training, True)

    monkeypatch.setattr(jfa, "flash_attention", interp)
    monkeypatch.setattr(jtr, "_ATTN_BACKEND", "flash")
    return calls


@pytest.mark.parametrize("jax_route", ["cpu", "kernel"])
def test_logits_match_jax(case, jax_route, monkeypatch):
    """The whole forward against ``TransformerModule.apply(training=
    False)``: through the JAX package's CPU route (dense; chunked at S >=
    512), and through its TPU kernels in interpret mode (molpcba: the
    gb-packed K4 rows of ``packed_fused``; code2: flash)."""
    b = case["batch"]
    if case["kind"] == "mol":
        assert min(b.max_nodes_dense, 1000) + 1 == 33
    else:
        assert min(b.max_nodes_dense, 600) + 1 == 601
    calls = (_jax_kernel_route(case["kind"], monkeypatch)
             if jax_route == "kernel" else None)
    want = np.asarray(case["jmodel"].apply({"params": case["params"]},
                                           case["jbatch"], None, False))
    if calls is not None:       # each encoder layer ran the kernel
        assert calls == [33 if case["kind"] == "mol" else 601] * len(
            case["tmodel"].transformer.layers)
    with torch.no_grad():
        got = case["tmodel"](b).numpy()
    gm = b.graph_mask.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


def test_converter_consumes_every_leaf(case):
    params = case["params"]
    load_flax_variables(case["tmodel"], params, {})
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(case["tmodel"], extra, {})
    missing = dict(params, transformer={
        k: v for k, v in params["transformer"].items() if k != "layer_0"})
    with pytest.raises(KeyError, match="layer_0"):
        load_flax_variables(case["tmodel"], missing, {})


@pytest.mark.parametrize("config,split,records,width", [
    (MOL_CONFIG, "valid", 24, 48), (CODE2_CONFIG, "valid", 24, 512),
    (CODE2_CONFIG, "test", 24, 448)])
def test_predict_transformer_on_cpu(tmp_path, config, split, records, width):
    """Both ymls through the serving entry at narrow widths: one record per
    graph, the flat layout at the split's own dense width."""
    out = tmp_path / "p.jsonl"
    argv = ["--configs", str(config), "--data_root", SNAPSHOT, "--split",
            split, "--d_model", "32", "--gnn_emb_dim", "32",
            "--num_encoder_layers", "2", "--out", str(out), "--device", "cpu"]
    args = predict.parse_with_config(predict.build_parser(), argv)
    splits, num_tasks, _ = predict.load_splits(args)
    layout = predict.serving_layout(splits, args, num_tasks)
    assert layout["dense_cap"] == width and "seq_pack_w" not in layout
    res = predict.main(argv)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert res["records"] == len(recs) == records
    assert sorted(r["graph_id"] for r in recs) == list(range(records))
    if config == MOL_CONFIG:
        assert all(len(r["logits"]) == 128 and np.isfinite(r["logits"]).all()
                   for r in recs)
    else:
        assert all(len(r["tokens"]) == SEQ for r in recs)
        assert 0.0 <= res["F1"] <= 1.0


def test_later_slices_raise():
    """Training the family is ported (test_torch_port_transformer_train.py),
    in bf16 too under the default backend (test_torch_port_tf_bf16.py);
    bf16 under another backend and non-CLS pooling on it name their
    slices, and a code2 encoder narrower than the transformer is
    refused."""
    with pytest.raises(NotImplementedError, match="slice 10"):
        tmain.main(["--configs", str(MOL_CONFIG), "--data_root", SNAPSHOT,
                    "--epochs", "1", "--device", "cpu", "--precision",
                    "bf16", "--attn_backend", "smalls"])
    args = predict.parse_with_config(predict.build_parser(), [
        "--configs", str(MOL_CONFIG), "--graph_pooling", "mean"])
    with pytest.raises(NotImplementedError, match="slice 11"):
        build_model(args, 128)
    with pytest.raises(NotImplementedError, match="slice 11"):
        tmain.main(["--configs", str(MOL_CONFIG), "--data_root", SNAPSHOT,
                    "--epochs", "1", "--device", "cpu", "--graph_pooling",
                    "mean"])
    args = predict.parse_with_config(predict.build_parser(), [
        "--configs", str(CODE2_CONFIG), "--d_model", "64"])
    with pytest.raises(ValueError, match="gnn_emb_dim"):
        build_model(args, 10, data=argparse.Namespace(
            num_nodetypes=TYPES, num_nodeattributes=ATTRS, max_seq_len=SEQ))
