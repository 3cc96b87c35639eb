"""The port's ogbg-code2 serving path against the JAX package: vocabulary,
edge augmentation, F1, the snapshot's preprocessing, three-tier packing and
the flat collate, and the whole GCN-virtual GraphTrans forward with its
per-position heads, with converted weights; then the entry points."""

import argparse
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.data import code as jcode  # noqa: E402
from graphtrans_tpu.data import evaluators as jev  # noqa: E402
from graphtrans_tpu.data import synthetic as js  # noqa: E402
from graphtrans_tpu.data import vocab as jv  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, LinearEdgeEncoder as JLinearEdge)
from graphtrans_tpu.ops import pack as jp  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import code as tcode  # noqa: E402
from graphtrans_tpu_torch.data import evaluators as tev  # noqa: E402
from graphtrans_tpu_torch.data import loader as tl  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.data import vocab as tv  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import (  # noqa: E402
    GNNTransformer)
from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder  # noqa: E402
from graphtrans_tpu_torch.ops import pack as tp  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_model import _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/code2/gnn-transformer/JK=cat/pooling=cls+norm_input.yml"
SNAPSHOT = str(REPO / "data_snapshots")
TOL = 1e-4  # logits: f32 BN/LN chains; flax LayerNorm uses E[x^2]-E[x]^2
VOCAB, TYPES, ATTRS, SEQ = 30, 20, 100, 5


def _assert_graphs_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert sorted(ga) == sorted(gb)
        for k in ga:
            if k == "edge_attr" and ga[k] is None:
                assert gb[k] is None
                continue
            np.testing.assert_array_equal(np.asarray(ga[k]),
                                          np.asarray(gb[k]), err_msg=k)
            if isinstance(ga[k], np.ndarray):
                assert ga[k].dtype == gb[k].dtype, k


def test_vocab_augment_and_f1_match_jax():
    kw = dict(num_graphs=30, vocab_size=12, seq_len_max=7, min_nodes=3,
              max_nodes=40, seed=2)
    raw_j, raw_t = js.make_code_dataset(**kw), ts.make_code_dataset(**kw)
    _assert_graphs_equal(raw_j, raw_t)
    _assert_graphs_equal(
        js.make_code_dataset(num_graphs=6, seed=1, size_dist="code2"),
        ts.make_code_dataset(num_graphs=6, seed=1, size_dist="code2"))
    seqs = [g["y_seq"] for g in raw_t]
    for num_vocab in (3, 8, 100):
        assert tv.get_vocab_mapping(seqs, num_vocab) == \
            jv.get_vocab_mapping(seqs, num_vocab)
    v2i, i2v = tv.get_vocab_mapping(seqs, 5)
    for s in seqs + [[], ["never_seen"] * 9]:
        arr = tv.encode_seq_to_arr(s, v2i, SEQ)
        np.testing.assert_array_equal(arr, jv.encode_seq_to_arr(s, v2i, SEQ))
        assert tv.decode_arr_to_seq(arr, i2v) == jv.decode_arr_to_seq(arr, i2v)
    _assert_graphs_equal([jv.augment_edge(g) for g in raw_j],
                         [tv.augment_edge(g) for g in raw_t])
    rng = np.random.default_rng(0)
    pred = [list(rng.choice(["a", "b", "c", "d"], rng.integers(0, 4)))
            for _ in range(20)]
    ref = [list(rng.choice(["a", "b", "c"], rng.integers(0, 3)))
           for _ in range(20)]
    assert tev.eval_f1_seq(ref, pred) == jev.eval_f1_seq(ref, pred)
    assert tev.eval_f1_seq([], []) == jev.eval_f1_seq([], [])


@pytest.mark.parametrize("root", [SNAPSHOT, "no_such_root"])
def test_code_splits_match_jax_preprocess(root):
    """The snapshot (read with gzip and csv here, pandas there) and the
    synthetic fallback give the same graphs, splits, vocabulary and
    encoder sizes as ``CodeUtil.preprocess``."""
    args = argparse.Namespace(data_root=root, dataset="ogbg-code2",
                              num_vocab=5000, max_seq_len=SEQ,
                              synthetic_num_graphs=40, synthetic_seed=3,
                              gnn_emb_dim=8)
    want = jcode.CodeUtil().preprocess(args)
    got = tcode.load_code_splits(root, "ogbg-code2", 5000, SEQ, 40, 3)
    assert got.num_tasks == want.num_tasks
    for split in ("train", "valid", "test"):
        _assert_graphs_equal(want.splits[split], got.splits[split])
    enc = want.node_encoder_cls()
    assert (got.num_nodetypes, got.num_nodeattributes) == (
        enc.num_nodetypes, enc.num_nodeattributes)
    arr = got.splits["valid"][0]["y_arr"]
    assert got.arr_to_seq(arr) == want.arr_to_seq(arr)
    if root == SNAPSHOT:
        sizes = [len(got.splits[s]) for s in ("train", "valid", "test")]
        assert sizes == [192, 24, 24]
        assert max(g["x"].shape[0] for g in got.splits["train"]) > 1000


def _tier_graphs(sizes, seed=0):
    """code2-like graphs of the given node counts, edges augmented, y_arr
    encoded, ids set."""
    graphs = []
    for k, n in enumerate(sizes):
        g = ts.make_code_dataset(num_graphs=1, vocab_size=VOCAB,
                                 seq_len_max=7, min_nodes=n, max_nodes=n,
                                 seed=seed + k)[0]
        graphs.append(g)
    v2i, _ = tv.get_vocab_mapping([g["y_seq"] for g in graphs], VOCAB)
    out = []
    for i, g in enumerate(graphs):
        g = tv.augment_edge(g)
        g["y_arr"] = tv.encode_seq_to_arr(g["y_seq"], v2i, SEQ)
        out.append(dict(g, _id=i))
    return out, len(v2i)


# one graph past max_input_len=1000 and at least one in each tier
SIZES = (1100, 500, 200, 400, 60, 9, 130)


@pytest.mark.parametrize("caps", [(0, 0, 0), (2, 3, 4)])
def test_build_pack_fields_tiers_matches_jax(caps):
    n = np.array(SIZES + (0,), np.int64)
    mask = n > 0
    offs = np.concatenate([[0], np.cumsum(n)[:-1]])
    N = int(n.sum()) + 16
    want = jp.build_pack_fields_tiers(n, mask, offs, N, (1024, 384, 128),
                                      1000, caps)
    got = tp.build_pack_fields_tiers(n, mask, offs, N, (1024, 384, 128),
                                     1000, caps)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]),
                                      err_msg=k)
    assert got["pack_rows"] >= 1 and got["pack2_rows"] >= 1
    assert got["pack3_rows"] >= 1
    # the 1100-node graph keeps its last 1000 nodes, then its CLS slot
    first = np.nonzero(got["pack_inv"] < got["pack_rows"] * 1024)[0]
    assert len(first) == 1000 + 500 + 400 and first[0] == 100
    assert tp.build_pack_fields_tiers(n, mask, offs, N, (1024, 384, 128),
                                      1000, (1, 1, 1)) is None
    for bad in ((384, 384, 128), (128, 384)):
        with pytest.raises(ValueError, match="decreasing"):
            tp.build_pack_fields_tiers(n, mask, offs, N, bad, 1000,
                                       (0,) * len(bad))


def _collate_kw(w):
    return dict(num_tasks=VOCAB + 2, max_seq_len=SEQ, y_dtype="int32",
                seq_pack_w=w, seq_pack_w2=384, seq_pack_w3=128)


@pytest.mark.parametrize("w", [512, 1024])
def test_flat_collate_matches_jax(w):
    graphs, _ = _tier_graphs(SIZES)
    caps = (9, 3072, 8192)
    want = jb.collate(graphs, *caps, **_collate_kw(w))
    got = tb.collate(graphs, *caps, **_collate_kw(w))
    for f in dataclasses.fields(got):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
            assert np.asarray(a).dtype == b.dtype, f.name
        else:
            assert a == b or (a is None and b is None), f.name
    assert got.node_stride == 0 and got.pack3_w == 128
    assert got.y_arr.shape == (9, SEQ) and got.node_depth.max() > 0
    with pytest.raises(tb.PackOverflow):
        tb.collate(graphs, *caps, **_collate_kw(w), seq_pack_rows=1)


def test_loader_tiers_and_row_caps():
    assert tl.pack_widths(1051, 1000) == (1024, 384, 128)
    assert tl.pack_widths(395, 1000) == (512, 384, 128)
    assert tl.pack_widths(300, 1000) == (384,)
    assert tl.pack_widths(60, 1000) == (128,)
    graphs, _ = _tier_graphs(SIZES * 3)
    node_cap, edge_cap = tl.dataset_caps(graphs, 8)
    rows = tl.sample_pack_rows(graphs, 8, node_cap, edge_cap,
                               (1024, 384, 128), 1000)
    assert len(rows) == 3 and all(r % 4 == 0 and r > 0 for r in rows)
    # a cap of one row per tier splits batches until each fits
    kw = _collate_kw(1024)
    kw.update(seq_pack_rows=1, seq_pack_rows2=1, seq_pack_rows3=1)
    ids = [int(i) for b in tl.iterate_batches(graphs, 8, node_cap, edge_cap,
                                              **kw)
           for i in b.graph_ids[b.graph_mask]]
    assert ids == list(range(len(graphs)))


# (emb, d_model, widest tier, JAX attention through the interpret-mode
# Pallas kernels: K2 for the 384 and 128 tiers, flash_hil for the widest)
CONFIGS = {"xla_32": (32, 32, 512, False), "pallas_128": (32, 128, 1024, True)}


def _hp(emb, d_model):
    return argparse.Namespace(
        model_type="gnn-transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=True, gnn_dropout=0.0, gnn_num_layer=2,
        gnn_emb_dim=emb, gnn_JK="cat", gnn_residual=False, d_model=d_model,
        nhead=4, dim_feedforward=2 * d_model, transformer_dropout=0.0,
        transformer_activation="relu", num_encoder_layers=1,
        max_input_len=1000, transformer_norm_input=True,
        num_encoder_layers_masked=0, transformer_prenorm=False,
        max_seq_len=SEQ, pos_encoder=False, pretrained_gnn=None,
        freeze_gnn=None, graph_input_dim=None, precision="f32")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    emb, d_model, w, pallas = CONFIGS[request.param]
    graphs, num_tasks = _tier_graphs(SIZES, seed=7)
    caps = (9, 3072, 8192)
    kw = dict(_collate_kw(w), num_tasks=num_tasks)
    jbatch = jb.collate(graphs, *caps, **kw)
    batch = tb.collate(graphs, *caps, **kw)
    jmodel = MODELS["gnn-transformer"].build(
        num_tasks, _hp(emb, d_model),
        JASTNodeEncoder(emb, num_nodetypes=TYPES, num_nodeattributes=ATTRS,
                        max_depth=20), lambda e: JLinearEdge(e))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(5)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    tmodel = GNNTransformer(num_tasks, 2, emb, True, d_model, 4, 2 * d_model,
                            1, True, gnn_type="gcn",
                            node_encoder=ASTNodeEncoder(emb, TYPES, ATTRS),
                            max_seq_len=SEQ).eval()
    load_flax_variables(tmodel, params, stats)
    return dict(pallas=pallas, jmodel=jmodel, jbatch=jbatch, tmodel=tmodel,
                variables={"params": params, "batch_stats": stats},
                batch=batch.to("cpu"), emb=emb)


@pytest.fixture
def jax_routes(case, monkeypatch):
    """Both interpret flags: rows of <= 384 take K2's Pallas kernel and
    wider rows flash_hil's, as on the TPU (with the flash flag alone the
    384 tier would take flash_attention_seg)."""
    monkeypatch.setattr(jtr, "_PFUSED_INTERPRET", case["pallas"])
    monkeypatch.setattr(jtr, "_FLASH_INTERPRET", case["pallas"])


def test_gcn_conv_matches_jax(case, jax_routes):
    rng = np.random.default_rng(1)
    b = case["batch"]
    h = rng.standard_normal((b.num_node_slots, case["emb"])).astype(np.float32)
    h[~b.node_mask.numpy()] = 0
    want = np.asarray(case["jmodel"].apply(
        case["variables"], case["jbatch"], h,
        method=lambda m, bb, hh: m.gnn_node.convs[1](bb, hh, False)))
    with torch.no_grad():
        got = case["tmodel"].gnn_node.convs[1](b, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_code2_logits_match_jax(case, jax_routes):
    """[G, 5, vocab] logits of the whole forward: AST encoder, GCN-virtual
    stack on the flat layout, the encoder once per tier, CLS read from the
    tiers' concat, per-position heads."""
    b = case["batch"]
    assert b.pack_w in (512, 1024) and b.pack2_w == 384 and b.pack3_w == 128
    want = np.asarray(case["jmodel"].apply(case["variables"], case["jbatch"],
                                           None, False))
    with torch.no_grad():
        got = case["tmodel"](b).numpy()
    gm = b.graph_mask.numpy()
    assert got.shape == want.shape == (9, SEQ, case["tmodel"].head.heads[0]
                                       .out_features)
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


def test_converter_consumes_every_code2_leaf(case):
    params = case["variables"]["params"]
    stats = case["variables"]["batch_stats"]
    missing = dict(params, head={k: v for k, v in params["head"].items()
                                 if k != "head_4"})
    with pytest.raises(KeyError, match="head_4"):
        load_flax_variables(case["tmodel"], missing, stats)


def _predict_argv(tmp_path, *extra):
    return ["--configs", str(CONFIG), "--data_root", SNAPSHOT, "--split",
            "test", "--batch_size", "16", "--gnn_emb_dim", "32",
            "--d_model", "32", "--out", str(tmp_path / "code2.jsonl"),
            *extra]


def test_predict_code2_writes_tokens_and_f1(tmp_path, capsys):
    res = predict.main(_predict_argv(tmp_path, "--device", "cpu"))
    recs = [json.loads(line)
            for line in (tmp_path / "code2.jsonl").read_text().splitlines()]
    assert res["records"] == len(recs) == 24
    assert sorted(r["graph_id"] for r in recs) == list(range(24))
    assert all(len(r["tokens"]) == SEQ and isinstance(r["seq"], list)
               for r in recs)
    assert 0.0 <= res["F1"] <= 1.0
    assert "test F1" in capsys.readouterr().out


def test_predict_code2_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(_predict_argv(tmp_path))


def test_main_code2_names_slice_4():
    """code2 training is ported (test_torch_port_code2_train.py), in bf16
    too under every backend (test_torch_port_code2_bf16.py,
    test_torch_port_backends_bf16_code2.py); bf16 on the card at a head
    width that no bf16 instance of its routes takes (64: K2 and K3 take
    32) is a later slice's and raises naming it, and without CUDA the
    entry raises unless asked for the CPU."""
    with pytest.raises(NotImplementedError, match="slice 10"):
        tmain.main(["--configs", str(CONFIG), "--data_root", SNAPSHOT,
                    "--epochs", "1", "--precision", "bf16",
                    "--attn_backend", "flash", "--nhead", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmain.main(["--configs", str(CONFIG), "--data_root", SNAPSHOT,
                        "--epochs", "1"])


def test_new_modules_import_nothing_of_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "graphtrans_tpu")
    pkg = REPO / "graphtrans_tpu_torch"
    files = [pkg / p for p in (
        "data/vocab.py", "data/evaluators.py", "data/code.py",
        "ops/segment.py", "ops/kernels/spmm.py", "ops/kernels/flash_hil.py")]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in banned, f"{f}: {name}"
