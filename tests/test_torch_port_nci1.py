"""The port's NCI1 path against the JAX package on the CPU: K6's plain
version against ``fused_dense_agg`` in interpret mode (forward and the
custom VJP), the TU data (synthetic graphs, files, the seeded split, the
strided collate), the loss and metric, the strided GCNConv, the whole
NCI1 GraphTrans forward and train step with converted weights, the
Transformer-only NCI1 forward, the config stages, and the entry points."""

import argparse
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.data import evaluators as jev  # noqa: E402
from graphtrans_tpu.data import synthetic as js  # noqa: E402
from graphtrans_tpu.data import tu as jtu  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    LinearNodeEncoder as JLinearNode, ZeroEdgeEncoder as JZeroEdge)
from graphtrans_tpu.ops.pallas import dense_agg as jda  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import evaluators as tev  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.data import tu as ttu  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import (  # noqa: E402
    GNNTransformer, build_gnn_transformer)
from graphtrans_tpu_torch.models.transformer import (  # noqa: E402
    TransformerModule)
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import (  # noqa: E402
    LinearNodeEncoder, ZeroEdgeEncoder)
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    dense_agg, dense_agg_bwd, dense_agg_plain)
from graphtrans_tpu_torch.train.losses import classification_loss  # noqa: E402
from graphtrans_tpu_torch.utils.config import parse_with_config  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_model import _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / ("configs/NCI1/gnn-transformer/no-virtual/"
                 "gd=128+gdp=0.1+tdp=0.1+l=3+cosine.yml")
TF_CONFIG = REPO / "configs/NCI1/transformer/pooling=cls.yml"
K6_TOL = 1e-5     # K6 alone: f32, one add and one product a message
TOL = 1e-4        # logits and loss: f32 BN/LN chains
GRAD_TOL = 5e-4   # gradients, of max(1, max |reference|)
NARROW = ["--gnn_emb_dim", "32", "--d_model", "32", "--gnn_num_layer", "2",
          "--num_encoder_layers", "1"]


# ---- K6 ---------------------------------------------------------------------


def _k6_inputs(G, Sm=16, Em=40, d=32, seed=0):
    rng = np.random.default_rng(seed + G)
    n = rng.integers(1, Sm + 1, G)
    src = (rng.random((G, Em)) * n[:, None]).astype(np.int32)
    dst = (rng.random((G, Em)) * n[:, None]).astype(np.int32)
    emask = rng.random((G, Em)) < 0.7
    emask[-1] = False                            # a padding graph slot
    src[~emask] = dst[~emask] = 0                # as collate pads them
    x = rng.standard_normal((G, Sm, d)).astype(np.float32)
    emb = rng.standard_normal((G, Em, d)).astype(np.float32)
    w = rng.standard_normal((G, Em)).astype(np.float32)
    gout = rng.standard_normal((G, Sm, d)).astype(np.float32)
    return x, src, dst, emask, emb, w, gout


def _pad16(a):
    pad = (-a.shape[0]) % jda.GT
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


@pytest.mark.parametrize("G", [32, 37])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_k6_plain_matches_jax_kernel(G, relu, with_w):
    """``dense_agg``'s CPU route (the plain version) against
    ``fused_dense_agg(..., interpret=True)``: the forward, and dx, demb and
    dw through the custom VJP against ``dense_agg_bwd`` (autograd through
    the plain version). At G 37 the JAX side is padded to 48 graphs, as
    ``ops/dense_mp.py`` pads for the TPU's grid; the port takes G as it
    is."""
    x, src, dst, emask, emb, w, gout = _k6_inputs(G)
    jin = [jnp.asarray(_pad16(a)) for a in (x, src, dst, emask, emb, w,
                                            gout)]
    jw = jin[5] if with_w else None

    def f(a, e, ww):
        return jda.fused_dense_agg(a, jin[1], jin[2], jin[3], e, ww, relu,
                                   True)

    want = np.asarray(f(jin[0], jin[4], jw))[:G]
    if with_w:
        jg = jax.grad(lambda a, e, ww: jnp.sum(f(a, e, ww) * jin[6]),
                      argnums=(0, 1, 2))(jin[0], jin[4], jw)
    else:
        jg = jax.grad(lambda a, e: jnp.sum(f(a, e, None) * jin[6]),
                      argnums=(0, 1))(jin[0], jin[4])
    t = [torch.from_numpy(a) for a in (x, src, dst, emask, emb, w, gout)]
    tw = t[5] if with_w else None
    got = dense_agg(t[0], t[1], t[2], t[3], t[4], tw, relu).numpy()
    np.testing.assert_allclose(got, want, atol=K6_TOL, rtol=0)
    grads = dense_agg_bwd(t[0], t[1], t[2], t[3], t[4], tw, t[6], relu)
    assert (grads[2] is None) == (not with_w)
    for name, g, r in zip(("dx", "demb", "dw"), grads, jg):
        r = np.asarray(r)[:G]
        np.testing.assert_allclose(
            g.numpy(), r, atol=K6_TOL * max(1.0, np.abs(r).max()), rtol=0,
            err_msg=name)
    assert not grads[1].numpy()[~emask].any()    # masked slots: demb 0


def test_k6_wrapper_runs_its_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; the
    plain version equals a loop over the edges."""
    x, src, dst, emask, emb, w, _ = _k6_inputs(5, Sm=6, Em=9, d=4)
    t = [torch.from_numpy(a) for a in (x, src, dst, emask, emb, w)]
    before = dense_agg.launches
    got = dense_agg(*t).numpy()
    assert dense_agg.launches == before
    want = np.zeros_like(x)
    for g in range(5):
        for e in range(9):
            if emask[g, e]:
                want[g, dst[g, e]] += w[g, e] * np.maximum(
                    x[g, src[g, e]] + emb[g, e], 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got, dense_agg_plain(*t).numpy())


# ---- TU data, loss and metric -----------------------------------------------


def _graphs_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert sorted(ga) == sorted(gb)
        for k in ga:
            if ga[k] is None:
                assert gb[k] is None, k
                continue
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
            assert ga[k].dtype == gb[k].dtype, k


def _write_tu(root: pathlib.Path, name="NCI1"):
    """Three graphs in the TU text format (1-based ids, labels 1 and -1)."""
    d = root / name
    d.mkdir(parents=True)
    edges = [(1, 2), (2, 1), (2, 3), (3, 2), (4, 5), (5, 4), (6, 7), (7, 6),
             (7, 8), (8, 7), (6, 8), (8, 6)]
    (d / f"{name}_A.txt").write_text(
        "".join(f"{a}, {b}\n" for a, b in edges))
    (d / f"{name}_graph_indicator.txt").write_text(
        "".join(f"{g}\n" for g in (1, 1, 1, 2, 2, 3, 3, 3)))
    (d / f"{name}_graph_labels.txt").write_text("1\n-1\n1\n")
    (d / f"{name}_node_labels.txt").write_text(
        "".join(f"{v}\n" for v in (0, 3, 1, 2, 2, 0, 1, 3)))


@pytest.mark.parametrize("files", [False, True])
def test_tu_splits_match_jax_preprocess(tmp_path, files):
    """The synthetic fallback and a TU file set give the graphs, classes
    and seeded 80/10/10 split of ``TUUtil.preprocess``."""
    if files:
        _write_tu(tmp_path)
        loaded = ttu.load_tu_dataset(str(tmp_path), "NCI1")
        _graphs_equal(jtu.load_tu_dataset(str(tmp_path), "NCI1")[0],
                      loaded[0])
        assert loaded[1] == 2 and loaded[0][1]["y"][0] == 0
        assert loaded[0][2]["x"].shape == (3, 4)
    args = argparse.Namespace(data_root=str(tmp_path), dataset="NCI1",
                              synthetic_num_graphs=50, synthetic_seed=3,
                              gnn_emb_dim=8)
    want = jtu.TUUtil.preprocess(args, seed=12344)
    got = ttu.load_tu_splits(str(tmp_path), "NCI1", 50, 3, 12344)
    assert got.num_tasks == want.num_tasks
    for split in ("train", "valid", "test"):
        _graphs_equal(want.splits[split], got.splits[split])
    assert got.num_node_labels == (4 if files else 16)
    if not files:
        _graphs_equal(js.make_tu_dataset(num_graphs=30, seed=5),
                      ts.make_tu_dataset(num_graphs=30, seed=5))


def _tu_graphs(n, seed=7):
    return [dict(g, _id=i) for i, g in
            enumerate(ts.make_tu_dataset(num_graphs=n, seed=seed))]


def _collate_kw(Em=160):
    return dict(num_tasks=2, y_dtype="int32", node_stride=48,
                dense_edge_cap=Em, seq_pack_w=128)


def test_strided_tu_collate_matches_jax():
    """``edge_attr`` None with float one-hot node features: the strided
    batch (int class ids, a zero edge-attribute column) equals the JAX
    package's."""
    graphs = _tu_graphs(11)
    caps = (12, 12 * 48, 2048)
    want = jb.collate(graphs, *caps, **_collate_kw())
    got = tb.collate(graphs, *caps, **_collate_kw())
    for f in dataclasses.fields(got):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
            assert np.asarray(a).dtype == b.dtype, f.name
        else:
            assert a == b or (a is None and b is None), f.name
    assert got.y.dtype == np.int32 and got.y.shape == (12,)
    assert got.node_feat.dtype == np.float32
    assert got.edge_attr_dense.shape == (12, 160, 1)


def test_classification_loss_and_accuracy_match_jax():
    b = tb.collate(_tu_graphs(9), 12, 12 * 48, 2048, **_collate_kw())
    pred = np.random.default_rng(2).normal(0, 2, (12, 2)).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jlosses.classification_loss(p, b))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = classification_loss(tp, b.to("cpu"))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7, rtol=0)
    assert not tp.grad.numpy()[~b.graph_mask].any()
    yt, yp = np.array([0, 1, 1, 0, 1]), np.array([0, 1, 0, 0, 0])
    assert tev.eval_acc(yt, yp) == jev.eval_acc(yt, yp) == {"acc": 0.6}
    assert tev.eval_acc(yt[:0], yp[:0]) == jev.eval_acc(yt[:0], yp[:0])


# ---- the model --------------------------------------------------------------


def _hp(emb, d_model, layers, enc_layers):
    return argparse.Namespace(
        model_type="gnn-transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, gnn_dropout=0.0, gnn_num_layer=layers,
        gnn_emb_dim=emb, gnn_JK="last", gnn_residual=False, d_model=d_model,
        nhead=4, dim_feedforward=2 * d_model, transformer_dropout=0.0,
        transformer_activation="relu", num_encoder_layers=enc_layers,
        max_input_len=1000, transformer_norm_input=True,
        num_encoder_layers_masked=0, transformer_prenorm=False,
        max_seq_len=None, pos_encoder=False, pretrained_gnn=None,
        freeze_gnn=None, graph_input_dim=None, precision="f32",
        lr=1e-4, weight_decay=1e-4, grad_clip=None, scheduler=None,
        epochs=1)


# (emb, d_model, GCN layers, encoder layers): narrow, and the yml's widths
WIDTHS = {"narrow": (32, 32, 2, 1), "yml": (128, 128, 5, 3)}


def _make(emb, d_model, layers, enc_layers):
    return GNNTransformer(
        2, layers, emb, False, d_model, 4, 2 * d_model, enc_layers, True,
        gnn_type="gcn", node_encoder=LinearNodeEncoder(16, emb),
        gnn_JK="last", edge_encoder=lambda: ZeroEdgeEncoder(emb))


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def case(request):
    """11 synthetic TU graphs (one padding slot) in the strided layout; the
    JAX model with noisy variables and random BN statistics, and the port
    with the same weights."""
    emb, d_model, layers, enc_layers = WIDTHS[request.param]
    graphs = _tu_graphs(11, seed=13)
    caps = (12, 12 * 48, 2048)
    jbatch = jb.collate(graphs, *caps, **_collate_kw())
    batch = tb.collate(graphs, *caps, **_collate_kw()).to("cpu")
    hp = _hp(emb, d_model, layers, enc_layers)
    jmodel = MODELS["gnn-transformer"].build(2, hp, JLinearNode(emb),
                                             JZeroEdge)
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(5)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    make = lambda: _make(emb, d_model, layers, enc_layers)
    tmodel = load_flax_variables(make(), params, stats).eval()
    return dict(name=request.param, jmodel=jmodel, jbatch=jbatch,
                batch=batch, hp=hp, params=params, stats=stats,
                tmodel=tmodel, make=make, emb=emb)


@pytest.mark.parametrize("case", ["narrow"], indirect=True)
def test_strided_gcn_conv_matches_jax(case):
    """One GCN layer on the strided layout: the output, and the gradients
    of a random projection of it for the input rows and the layer's
    weights."""
    b = case["batch"]
    rng = np.random.default_rng(1)
    h = rng.standard_normal((b.num_node_slots, case["emb"])).astype(
        np.float32)
    h[~b.node_mask.numpy()] = 0
    g = rng.standard_normal(h.shape).astype(np.float32)
    variables = {"params": case["params"], "batch_stats": case["stats"]}
    conv = lambda m, bb, hh: m.gnn_node.convs[1](bb, hh, False)

    def proj(params, hh):
        out = case["jmodel"].apply(dict(variables, params=params),
                                   case["jbatch"], hh, method=conv)
        return jnp.sum(out * g), out

    (_, want), (gp, gh) = jax.value_and_grad(proj, argnums=(0, 1),
                                             has_aux=True)(case["params"], h)
    tconv = case["tmodel"].gnn_node.convs[1]
    th = torch.from_numpy(h).requires_grad_()
    out = tconv(b, th)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    (out * torch.from_numpy(g)).sum().backward()
    jc = gp["gnn_node"]["conv_1"]
    for got, ref in ((th.grad, gh), (tconv.lin.weight.grad,
                                     np.asarray(jc["TDense_0"]["kernel"]).T),
                     (tconv.lin.bias.grad, jc["TDense_0"]["bias"]),
                     (tconv.root_emb.grad, jc["root_emb"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=GRAD_TOL * max(1, np.abs(ref).max()))


def test_nci1_logits_match_jax(case):
    """[G, 2] logits of the whole forward: linear node encoder, GCN on the
    strided layout (K6's CPU route; the JAX model off the TPU takes its
    one-hot route, which ``tests/test_pallas.py`` holds to K6), JK=last,
    packed rows of 128, CLS read-out, the class head."""
    b = case["batch"]
    assert b.pack_w == 128 and b.node_stride == 48
    want = np.asarray(case["jmodel"].apply(
        {"params": case["params"], "batch_stats": case["stats"]},
        case["jbatch"], None, False))
    with torch.no_grad():
        got = case["tmodel"](b).numpy()
    gm = b.graph_mask.numpy()
    assert got.shape == want.shape == (12, 2)
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["narrow"], indirect=True)
def test_nci1_train_step_loss_and_grads_match_jax(case):
    """One train step's loss (cross-entropy) and every gradient against
    ``BaseTrainer.make_grad_fn``, dropout off, batch statistics on."""
    grad_fn = jax.jit(BaseTrainer.make_grad_fn(
        case["jmodel"], jlosses.classification_loss, case["hp"]))
    jgrads, _, jloss = jax.device_get(grad_fn(
        TrainState.create(case["params"], case["stats"], None),
        case["jbatch"], jax.random.key(2)))
    twin = case["make"]()
    twin.load_state_dict(case["tmodel"].state_dict())
    twin.train()
    b = case["batch"]
    loss = classification_loss(twin(b, Generators.seeded(0, "cpu")), b)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=0)
    want = {k: v.numpy() for k, v in load_flax_variables(
        case["make"](), jgrads, case["stats"]).state_dict().items()}
    for name, p in twin.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=0,
            atol=GRAD_TOL * max(1.0, np.abs(want[name]).max()), err_msg=name)


def test_converter_maps_the_nci1_tree(case):
    """No edge-encoder leaves (the zero encoder has none), the node
    encoder's Dense, and a bridge from JK=last's width."""
    p = case["params"]
    assert "edge_encoder" not in p["gnn_node"]["conv_0"]
    assert p["gnn2transformer"]["kernel"].shape[0] == case["emb"]
    with pytest.raises(KeyError, match="node_encoder"):
        load_flax_variables(case["make"](), dict(p, node_encoder={}),
                            case["stats"])


def test_tf_nci1_logits_match_jax():
    """The Transformer-only NCI1 model (``LinearNodeEncoder(d_model)``,
    rows of 48 + CLS, two graphs a packed row) against the JAX model."""
    graphs = _tu_graphs(7, seed=21)
    kw = dict(num_tasks=2, y_dtype="int32", dense_cap=48)
    jbatch = jb.collate(graphs, 8, 512, 2048, **kw)
    batch = tb.collate(graphs, 8, 512, 2048, **kw).to("cpu")
    hp = argparse.Namespace(
        model_type="transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, d_model=128, nhead=4, dim_feedforward=256,
        transformer_dropout=0.0, transformer_activation="relu",
        num_encoder_layers=1, max_input_len=1000,
        transformer_norm_input=False, max_seq_len=None)
    jmodel = MODELS["transformer"].build(2, hp, JLinearNode(128), JZeroEdge)
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                   + rng.normal(0, 0.02, a.shape)).astype(np.float32),
        jax.device_get(v["params"]))
    tmodel = load_flax_variables(TransformerModule(
        2, LinearNodeEncoder(16, 128), 128, 4, 256, 1, 1000, False), params,
        {}).eval()
    want = np.asarray(jmodel.apply({"params": params}, jbatch, None, False))
    with torch.no_grad():
        got = tmodel(batch).numpy()
    gm = batch.graph_mask.numpy()
    np.testing.assert_allclose(got[gm], want[gm], atol=TOL, rtol=0)


# ---- configs and entry points -----------------------------------------------


def test_config_stages_rank_cli_over_yml_over_dataset():
    """TU's defaults fill what the yml leaves out (batch 128, weight decay
    1e-4, 5 GCN layers from the parser, JK last); the yml beats them
    (gnn_dropout 0.1, not TU's 0.5; lr 1e-4); the command line beats the
    yml."""
    args = parse_with_config(tmain.build_parser(), ["--configs",
                                                    str(CONFIG)])
    assert (args.dataset, args.batch_size, args.weight_decay) == (
        "NCI1", 128, 1e-4)
    assert (args.gnn_dropout, args.lr, args.epochs, args.runs) == (
        0.1, 1e-4, 100, 20)
    assert (args.gnn_num_layer, args.gnn_JK, args.gnn_emb_dim) == (
        5, "last", 128)
    args = parse_with_config(tmain.build_parser(), [
        "--configs", str(CONFIG), "--gnn_dropout", "0.2", "--batch_size",
        "16"])
    assert (args.gnn_dropout, args.batch_size) == (0.2, 16)
    args = parse_with_config(predict.build_parser(), ["--dataset", "NCI1"])
    assert (args.batch_size, args.gnn_emb_dim) == (128, 128)
    with pytest.raises(NotImplementedError, match="slice 12"):
        tmain.main(["--configs", str(CONFIG), "--device", "cpu"])


def test_build_takes_the_nci1_yml():
    args = parse_with_config(predict.build_parser(), [
        "--configs", str(CONFIG), "--runs", "1"])
    model = build_gnn_transformer(args, 2, data=ttu.TUData({}, 2, 37))
    g = model.gnn_node
    assert len(g.convs) == 5 and not g.virtual_node and g.JK == "last"
    assert isinstance(g.convs[0].edge_encoder, ZeroEdgeEncoder)
    assert g.atom_encoder.lin.in_features == 37
    assert model.gnn2transformer.in_features == 128
    assert model.head.head.out_features == 2
    assert len(model.transformer_encoder.layers) == 3
    assert not list(g.convs[0].edge_encoder.parameters())


def test_predict_and_main_nci1_on_the_cpu(tmp_path, capsys):
    """predict writes one record of two logits per test graph and an
    accuracy in [0, 1]; main trains 2 epochs with finite losses and
    writes last_model.pt, which predict --weights serves."""
    out = tmp_path / "nci1.jsonl"
    res = predict.main(["--configs", str(CONFIG), "--runs", "1", "--device",
                        "cpu", "--out", str(out), *NARROW])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert res["records"] == len(recs) == 40
    assert sorted(r["graph_id"] for r in recs) == list(range(40))
    assert all(len(r["logits"]) == 2 for r in recs)
    assert 0.0 <= res["acc"] <= 1.0
    assert "test acc" in capsys.readouterr().out
    run = tmain.main(["--configs", str(CONFIG), "--runs", "1", "--device",
                      "cpu", "--epochs", "2", "--save_path", str(tmp_path),
                      *NARROW])
    assert [r["steps"] for r in run["epochs"]] == [3, 3]
    assert all(np.isfinite(r["loss"]) for r in run["epochs"])
    served = predict.main(["--configs", str(CONFIG), "--runs", "1",
                           "--device", "cpu", "--split", "valid",
                           "--weights", run["saved"], "--out",
                           str(tmp_path / "v.jsonl"), *NARROW])
    assert served["records"] == 40 and 0.0 <= served["acc"] <= 1.0


def test_tf_nci1_entry_points_on_the_cpu(tmp_path):
    narrow = ["--d_model", "128", "--num_encoder_layers", "1", "--runs", "1",
              "--device", "cpu"]
    res = predict.main(["--configs", str(TF_CONFIG), "--out",
                        str(tmp_path / "tf.jsonl"), *narrow])
    assert res["records"] == 40 and 0.0 <= res["acc"] <= 1.0
    run = tmain.main(["--configs", str(TF_CONFIG), "--epochs", "1",
                      *narrow])
    assert np.isfinite(run["epochs"][0]["loss"])


def test_nci1_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--configs", str(CONFIG), "--out",
                      str(tmp_path / "p.jsonl")])
