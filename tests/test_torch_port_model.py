"""The port's serving model against the JAX package (GINConv, the GNN stack
and the whole GraphTrans forward, with converted weights), its entry point,
and its independence from JAX."""

import argparse
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from graphtrans_tpu.data.batch import collate as jax_collate  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import AtomEncoder, BondEncoder  # noqa: E402
from graphtrans_tpu.ops import dense_mp as jdm  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data.batch import collate  # noqa: E402
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import load_flax_variables  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml"
TOL = 1e-4  # f32 BN/LN chains; flax LayerNorm uses E[x^2]-E[x]^2

# (emb, d_model, GIN layers, encoder layers, JAX routes through the
# interpret-mode Pallas kernels)
CONFIGS = {"pallas_128": (128, 128, 2, 1, True),
           "xla_40": (40, 32, 3, 2, False)}


def _hp(emb, d_model, gnn_layers, enc_layers):
    return argparse.Namespace(
        model_type="gnn-transformer", graph_pooling="cls", gnn_type="gin",
        gnn_virtual_node=True, gnn_dropout=0.3, gnn_num_layer=gnn_layers,
        gnn_emb_dim=emb, gnn_JK="cat", gnn_residual=False, d_model=d_model,
        nhead=4, dim_feedforward=2 * d_model, transformer_dropout=0.3,
        transformer_activation="relu", num_encoder_layers=enc_layers,
        max_input_len=1000, transformer_norm_input=True,
        num_encoder_layers_masked=0, transformer_prenorm=False,
        max_seq_len=None, pos_encoder=False, pretrained_gnn=None,
        freeze_gnn=None, graph_input_dim=None, precision="f32")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """8 graphs in the strided, seq-packed layout; the JAX model with every
    parameter and BN statistic randomised from numpy; the port model with
    the converted weights."""
    emb, d_model, gl, el, pallas = CONFIGS[request.param]
    graphs = make_mol_dataset(num_graphs=8, num_tasks=6, min_nodes=3,
                              max_nodes=30, seed=11)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", node_stride=32,
              dense_edge_cap=96, seq_pack_w=128)
    jbatch = jax_collate(graphs, 9, 9 * 32, 512, **kw)
    batch = collate(graphs, 9, 9 * 32, 512, **kw)
    hp = _hp(emb, d_model, gl, el)
    jmodel = MODELS["gnn-transformer"].build(
        6, hp, AtomEncoder(emb), lambda e: BondEncoder(e))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(5)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    tmodel = GNNTransformer(6, gl, emb, True, d_model, 4, 2 * d_model, el,
                            True).eval()
    load_flax_variables(tmodel, params, stats)
    return dict(pallas=pallas, jmodel=jmodel, jbatch=jbatch,
                variables={"params": params, "batch_stats": stats},
                tmodel=tmodel, batch=batch.to("cpu"), emb=emb)


def _random_stats(stats, rng):
    """BN running means ~ N(0, 0.3), variances ~ U(0.5, 1.5)."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


@pytest.fixture
def jax_routes(case, monkeypatch):
    """Route the JAX model through its interpret-mode Pallas kernels where
    the case asks for them (their d % 128 condition holds there)."""
    monkeypatch.setattr(jdm, "_FUSED_TABLES_INTERPRET", case["pallas"])
    monkeypatch.setattr(jtr, "_PFUSED_INTERPRET", case["pallas"])


def _apply(case, fn, *args):
    return np.asarray(case["jmodel"].apply(case["variables"], *args,
                                           method=fn))


def test_gin_conv_matches_jax(case, jax_routes):
    rng = np.random.default_rng(1)
    b = case["batch"]
    h = rng.standard_normal((b.num_node_slots, case["emb"])).astype(np.float32)
    h[~b.node_mask.numpy()] = 0
    want = _apply(case, lambda m, bb, hh: m.gnn_node.convs[1](bb, hh, False),
                  case["jbatch"], h)
    with torch.no_grad():
        got = case["tmodel"].gnn_node.convs[1](b, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_gnn_node_embedding_matches_jax(case, jax_routes):
    want = _apply(case, lambda m, bb: m.gnn_node(bb, None, False),
                  case["jbatch"])
    with torch.no_grad():
        got = case["tmodel"].gnn_node(case["batch"]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_flagship_logits_match_jax(case, jax_routes):
    want = np.asarray(case["jmodel"].apply(case["variables"], case["jbatch"],
                                           None, False))
    with torch.no_grad():
        got = case["tmodel"](case["batch"]).numpy()
    gm = case["batch"].graph_mask.numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


def test_converter_consumes_every_leaf(case):
    params = case["variables"]["params"]
    stats = case["variables"]["batch_stats"]
    d_model = case["tmodel"].head.head.in_features
    fresh = GNNTransformer(6, len(case["tmodel"].gnn_node.convs), case["emb"],
                           True, d_model, 4, 2 * d_model,
                           len(case["tmodel"].transformer_encoder.layers),
                           True)
    load_flax_variables(fresh, params, stats)
    extra = dict(params, stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(fresh, extra, stats)
    missing = {k: v for k, v in params.items() if k != "head"}
    with pytest.raises(KeyError, match="head"):
        load_flax_variables(fresh, missing, stats)


def test_predict_writes_one_record_per_graph(tmp_path):
    out = tmp_path / "preds.jsonl"
    res = predict.main(["--configs", str(CONFIG),
                        "--data_root", str(REPO / "data_snapshots"),
                        "--split", "valid", "--batch_size", "16",
                        "--gnn_emb_dim", "32", "--d_model", "32",
                        "--gnn_num_layer", "2", "--num_encoder_layers", "1",
                        "--out", str(out), "--seed", "3", "--device", "cpu"])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert res == {"records": 24, "batches": 2, "out": str(out)}
    assert sorted(r["graph_id"] for r in recs) == list(range(24))
    assert all(len(r["logits"]) == 128 and np.isfinite(r["logits"]).all()
               for r in recs)


def test_predict_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--configs", str(CONFIG), "--data_root",
                      str(REPO / "data_snapshots"),
                      "--out", str(tmp_path / "p.jsonl")])


_BANNED = ("jax", "jaxlib", "flax", "optax", "graphtrans_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "graphtrans_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in _BANNED, f"{f}: imports {name}"


def test_import_leaves_jax_unloaded():
    code = ("import graphtrans_tpu_torch, graphtrans_tpu_torch.predict, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
