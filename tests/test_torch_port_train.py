"""The port's training path against the JAX package on the CPU: the pieces
(pack_gather's gradient, MaskedBatchNorm in training, the loss, clipping,
the cosine schedule, the shuffled batch order, ByteDropout) and the whole
train step, for loss, gradients, BN running statistics and the parameters
after one and three AdamW steps; and the training entry point."""

import argparse
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from graphtrans_tpu.data.batch import collate as jax_collate  # noqa: E402
from graphtrans_tpu.data.loader import GraphLoader  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import AtomEncoder, BondEncoder  # noqa: E402
from graphtrans_tpu.nn.norm import MaskedBatchNorm as JaxBN  # noqa: E402
from graphtrans_tpu.ops import dense_mp as jdm  # noqa: E402
from graphtrans_tpu.ops import pack as jpack  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.optim import build_optimizer as jax_optimizer  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data.batch import bucket_size, collate  # noqa: E402
from graphtrans_tpu_torch.data.loader import (  # noqa: E402
    iterate_batches, shuffled_order)
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import ByteDropout, Generators  # noqa: E402
from graphtrans_tpu_torch.nn.norm import MaskedBatchNorm  # noqa: E402
from graphtrans_tpu_torch.ops.pack import build_pack_fields, pack_gather  # noqa: E402
from graphtrans_tpu_torch.train.losses import binary_multitask_loss  # noqa: E402
from graphtrans_tpu_torch.train.optim import (  # noqa: E402
    PlateauScheduler, build_optimizer, clip_by_global_norm_, cosine_decay)
from graphtrans_tpu_torch.trainers.base_trainer import (  # noqa: E402
    make_train_step, train)
from graphtrans_tpu_torch.utils.flax_weights import load_flax_variables  # noqa: E402
from tests.test_torch_port_model import CONFIGS, _hp, _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml"
LOSS_TOL = 1e-4   # f32 BN/LN chains (flax LayerNorm uses E[x^2]-E[x]^2)
GRAD_TOL = 5e-4   # gradients of the same chains
LR = 1e-4         # the published config's lr


def _np(t):
    return t.detach().numpy()


def test_pack_gather_grad_matches_jax():
    num_nodes = np.array([5, 40, 0, 31, 12], np.int64)
    mask = num_nodes > 0
    offs = np.concatenate([[0], np.cumsum(num_nodes)[:-1]])
    N = int(num_nodes.sum()) + 6
    f = build_pack_fields(num_nodes, mask, offs, N, 64, 30)   # truncates
    rng = np.random.default_rng(0)
    src = rng.standard_normal((N + 1, 8)).astype(np.float32)
    src[-1] = 0
    g = rng.standard_normal((f["pack_rows"] * 64, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jpack.pack_gather(
        s, jnp.asarray(f["pack_node"]), jnp.asarray(f["pack_inv"])),
        jnp.asarray(src))
    t_src = torch.from_numpy(src).requires_grad_()
    out = pack_gather(t_src, torch.from_numpy(f["pack_node"]),
                      torch.from_numpy(f["pack_inv"]))
    np.testing.assert_array_equal(_np(out), src[f["pack_node"]])
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t_src.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_masked_batch_norm_training_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((40, 12)) * 3 + 1).astype(np.float32)
    mask = rng.random(40) < 0.7
    x[~mask] = 0
    mean0 = rng.normal(0, 0.3, 12).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    scale = rng.normal(1, 0.1, 12).astype(np.float32)
    bias = rng.normal(0, 0.1, 12).astype(np.float32)
    want, mut = JaxBN(12).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), jnp.asarray(mask), use_running_average=False,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(12)
    load = {"weight": scale, "bias": bias, "running_mean": mean0,
            "running_var": var0}
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in load.items()})
    got = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    assert not _np(got)[~mask].any()
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-5, rtol=0)
    before = bn.running_mean.clone()                 # eval: running stats
    bn.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.equal(before, bn.running_mean)


def test_binary_multitask_loss_matches_jax():
    graphs = make_mol_dataset(num_graphs=6, num_tasks=5, seed=2)
    b = collate(graphs, 8, 8 * 48, 512, num_tasks=5, y_dtype="float32")
    pred = np.random.default_rng(3).normal(0, 4, (8, 5)).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jlosses.binary_multitask_loss(p, b))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = binary_multitask_loss(tp, b.to("cpu"))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), atol=1e-7,
                               rtol=0)
    assert np.isnan(b.y[b.graph_mask]).any() and (b.y[~b.graph_mask] != 0).any()


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = clip_by_global_norm_(params, max_norm)
    np.testing.assert_allclose(norm.item(),
                               np.sqrt(sum((g * g).sum() for g in grads)),
                               rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(init_value=1e-3, decay_steps=12)
    args = argparse.Namespace(lr=1e-3, weight_decay=0.0, grad_clip=None,
                              scheduler="cosine", epochs=3)
    opt = build_optimizer(torch.nn.Linear(2, 2), args, steps_per_epoch=4)
    for step in range(14):      # optax evaluates the schedule in float32
        assert abs(1e-3 * cosine_decay(step, 12) - float(sched(step))) < 1e-9
        np.testing.assert_allclose(opt.lr, float(sched(step)), rtol=1e-5,
                                   atol=1e-12)
        opt.step()
    with pytest.raises(NotImplementedError, match="slice 12"):
        build_optimizer(torch.nn.Linear(2, 2),
                        argparse.Namespace(**dict(vars(args),
                                                  scheduler="onecycle")), 4)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_scheduler_matches_jax(mode):
    from graphtrans_tpu.train.optim import PlateauScheduler as JaxPlateau

    metrics = np.random.default_rng(10).random(60).cumsum() % 3
    want = JaxPlateau(1e-3, mode=mode, patience=3)
    got = PlateauScheduler(1e-3, mode=mode, patience=3)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]
    assert got.state_dict() == want.state_dict()


def test_shuffled_batches_match_graph_loader():
    """Two epochs of the shuffled order, cut by the same caps (an edge cap
    small enough to close batches early), give the JAX loader's batches."""
    graphs = make_mol_dataset(num_graphs=45, num_tasks=3, seed=6)
    bs, seed = 8, 17
    stride = bucket_size(max(g["x"].shape[0] for g in graphs), 16)
    em = bucket_size(max(g["edge_index"].shape[1] for g in graphs), 8)
    edge_cap = 384
    jl = GraphLoader(graphs, bs, shuffle=True, seed=seed, num_tasks=3,
                     y_dtype="float32", fixed_caps=(0, edge_cap),
                     use_native=False, dense_layout=True,
                     dense_caps=(stride, em))
    layout = dict(batch_size=bs, node_cap=(bs + 1) * stride,
                  edge_cap=edge_cap, num_tasks=3, y_dtype="float32",
                  node_stride=stride, dense_edge_cap=em)
    for epoch in range(2):
        want = [list(b.graph_ids[b.graph_mask]) for b in jl]
        got = [list(b.graph_ids[b.graph_mask]) for b in iterate_batches(
            graphs, order=shuffled_order(len(graphs), seed, epoch),
            **layout)]
        assert got == want
        assert any(len(b) < bs for b in got[:-1])       # early closes


def test_byte_dropout():
    x = torch.randn(64, 128)
    gen = Generators.seeded(0, "cpu")
    assert ByteDropout(0.3).eval()(x, gen) is x
    assert ByteDropout(0.0).train()(x, None) is x
    y = ByteDropout(0.3).train()(x, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 179 / 256) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / (179 / 256), rtol=1e-6,
                               atol=0)
    again = ByteDropout(0.3).train()(x, Generators.seeded(0, "cpu"))
    assert torch.equal(again, y)
    s = Generators.seeded(5, "cpu")
    seeds = [s.kernel_seed() for _ in range(3)]
    assert len(set(seeds)) == 3 and all(0 <= v < 2**31 - 1 for v in seeds)


# ---- the whole train step ---------------------------------------------


def _flax_to_state(args, params, batch_stats) -> dict:
    """A flax tree (params, gradients or updated state) in the port's
    state-dict layout, through a ``GNNTransformer(*args)``."""
    twin = GNNTransformer(*args)
    load_flax_variables(twin, params, batch_stats)
    return {k: v.numpy() for k, v in twin.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def step_case(request):
    """One collated batch; the JAX model's train step (BaseTrainer with
    AdamW from the JAX package's build_optimizer) and the port's, from the
    same randomised variables, dropout off."""
    emb, d_model, gl, el, pallas = CONFIGS[request.param]
    graphs = make_mol_dataset(num_graphs=8, num_tasks=6, min_nodes=3,
                              max_nodes=30, seed=21)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", node_stride=32,
              dense_edge_cap=96, seq_pack_w=128)
    jbatch = jax_collate(graphs, 9, 9 * 32, 512, **kw)
    batch = collate(graphs, 9, 9 * 32, 512, **kw).to("cpu")
    hp = _hp(emb, d_model, gl, el)
    hp.gnn_dropout = hp.transformer_dropout = 0.0
    hp.lr, hp.weight_decay, hp.grad_clip = LR, 0.01, 1.0
    hp.scheduler, hp.epochs = None, 1
    jmodel = MODELS["gnn-transformer"].build(
        6, hp, AtomEncoder(emb), lambda e: BondEncoder(e))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(8)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    args = (6, gl, emb, True, d_model, 4, 2 * d_model, el, True)
    tmodel = GNNTransformer(*args)
    load_flax_variables(tmodel, params, stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdm, "_FUSED_TABLES_INTERPRET", pallas)
        mp.setattr(jtr, "_PFUSED_INTERPRET", pallas)
        grad_fn = jax.jit(BaseTrainer.make_grad_fn(
            jmodel, jlosses.binary_multitask_loss, hp))
        jgrads, jbs, jloss = jax.device_get(grad_fn(
            TrainState.create(params, stats, None), jbatch,
            jax.random.key(2)))
    return dict(pallas=pallas, jmodel=jmodel, jbatch=jbatch, batch=batch,
                hp=hp, params=params, stats=stats, tmodel=tmodel, args=args,
                jgrads=jgrads, jbs=jbs, jloss=jloss)


@pytest.fixture
def jax_routes(step_case, monkeypatch):
    monkeypatch.setattr(jdm, "_FUSED_TABLES_INTERPRET", step_case["pallas"])
    monkeypatch.setattr(jtr, "_PFUSED_INTERPRET", step_case["pallas"])


def test_train_step_loss_grads_and_stats_match_jax(step_case):
    """Loss, every gradient and the BN running statistics of one forward
    and backward in training mode, against BaseTrainer.make_grad_fn."""
    c = step_case
    jgrads, jbs, jloss = c["jgrads"], c["jbs"], c["jloss"]
    twin = GNNTransformer(*c["args"])
    twin.load_state_dict(c["tmodel"].state_dict())
    twin.train()
    loss = binary_multitask_loss(twin(c["batch"], Generators.seeded(0, "cpu")),
                                 c["batch"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_TOL,
                               rtol=0)
    want = _flax_to_state(c["args"], jgrads, c["stats"])
    for name, p in twin.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=GRAD_TOL,
                                   rtol=0, err_msg=name)
    stats = _flax_to_state(c["args"], c["params"], jbs)
    for name, buf in twin.named_buffers():   # E[x^2]-E[x]^2 in f32
        np.testing.assert_allclose(buf.numpy(), stats[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_train_step_params_match_jax_after_1_and_3_steps(step_case,
                                                         jax_routes):
    """Params and BN statistics after 1 and 3 AdamW steps (weight decay
    0.01, global-norm clip 1.0). Adam divides each gradient by its own
    root-mean-square, so a gradient that is zero but for rounding (the
    bias of a Linear that feeds a BatchNorm, which removes any shift) turns
    into an update of up to +-lr whose sign is the rounding's. So every
    entry must agree within 2*lr per step, and every entry whose first
    gradient is not below 1e-5 within 1e-6 plus 1% of lr per step."""
    c = step_case
    g1 = _flax_to_state(c["args"], c["jgrads"], c["stats"])
    tx, _ = jax_optimizer(c["hp"], 1)
    jstate = TrainState.create(c["params"], c["stats"], tx.init(c["params"]))
    jstep = BaseTrainer.make_train_step(
        c["jmodel"], jlosses.binary_multitask_loss, tx, c["hp"], donate=False)
    model = GNNTransformer(*c["args"])
    model.load_state_dict(c["tmodel"].state_dict())
    opt = build_optimizer(model, c["hp"], 1)
    step = make_train_step(model, binary_multitask_loss, opt,
                           Generators.seeded(0, "cpu"))
    for k in (1, 2, 3):
        jstate, jloss = jstep(jstate, c["jbatch"], jax.random.key(3))
        loss = step(c["batch"])
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   atol=LOSS_TOL, rtol=0)
        if k == 2:
            continue
        want = _flax_to_state(c["args"], jax.device_get(jstate.params),
                              jax.device_get(jstate.batch_stats))
        for name, t in model.named_parameters():
            diff = np.abs(t.detach().numpy() - want[name])
            assert diff.max() <= 2 * LR * k + 1e-6, name
            firm = np.abs(g1[name]) >= 1e-5
            np.testing.assert_array_less(
                np.where(firm, diff, 0), 1e-6 + 0.01 * LR * k, err_msg=name)
        for name, t in model.named_buffers():
            # a BN's batch mean sees the biases that rounding moved (up to
            # 2*lr per earlier step), at momentum 0.1 per step; variances
            # of ~10 keep f32's relative precision
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-5,
                                       atol=1e-5 + 0.1 * LR * k * (k - 1),
                                       err_msg=name)


def test_train_loop_skips_degenerate_batches():
    graphs = make_mol_dataset(num_graphs=5, num_tasks=2, seed=9)
    kw = dict(num_tasks=2, y_dtype="float32", node_stride=48,
              dense_edge_cap=144, seq_pack_w=128)
    batches = [collate(graphs[:1], 3, 3 * 48, 512, **kw),
               collate(graphs[1:4], 4, 4 * 48, 512, **kw)]
    seen = []
    stats = {}
    mean = train(lambda b: seen.append(b) or torch.tensor(2.0), batches,
                 "cpu", stats=stats)
    assert mean == 2.0 and len(seen) == 1
    assert stats["steps"] == 1 and stats["graphs"] == 3


# ---- the entry point ------------------------------------------------------

NARROW = ["--gnn_emb_dim", "32", "--d_model", "32", "--gnn_num_layer", "2",
          "--num_encoder_layers", "1"]


def test_main_trains_and_predict_serves_its_weights(tmp_path, capsys):
    res = tmain.main(["--configs", str(CONFIG), "--data_root",
                      str(REPO / "data_snapshots"), "--epochs", "2",
                      "--batch_size", "64", "--seed", "0", "--device", "cpu",
                      "--save_path", str(tmp_path), *NARROW])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["epoch"] for r in lines] == [1, 2]
    for r in lines:
        assert r["steps"] == 3 and np.isfinite(r["loss"]) and r["loss"] > 0
        assert r["lr"] == 1e-4 and r["device"] == "cpu"     # plateau: --lr
    assert res["epochs"] == lines
    weights = tmp_path / "last_model.pt"
    assert res["saved"] == str(weights)
    out = tmp_path / "preds.jsonl"
    served = predict.main(["--configs", str(CONFIG), "--data_root",
                           str(REPO / "data_snapshots"), "--split", "test",
                           "--batch_size", "64", "--weights", str(weights),
                           "--out", str(out), "--device", "cpu", *NARROW])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert served["records"] == 24 == len(recs)
    assert all(np.isfinite(r["logits"]).all() for r in recs)
    fresh = predict.main(["--configs", str(CONFIG), "--data_root",
                          str(REPO / "data_snapshots"), "--split", "test",
                          "--batch_size", "64", "--seed", "0",
                          "--out", str(tmp_path / "fresh.jsonl"),
                          "--device", "cpu", *NARROW])
    first = json.loads((tmp_path / "fresh.jsonl").read_text().splitlines()[0])
    assert fresh["records"] == 24 and first["logits"] != recs[0]["logits"]


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--configs", str(CONFIG), "--data_root",
                    str(REPO / "data_snapshots"), "--epochs", "1"])


@pytest.mark.parametrize("flag,slice_", [
    (["--aug", "flag"], "slice 12"), (["--runs", "3"], "slice 12"),
    (["--resume", "x"], "slice 12"), (["--sp"], "slice 13"),
    (["--dp_shards", "4"], "slice 13"), (["--scheduler", "onecycle"],
                                         "slice 12")])
def test_main_turns_away_later_slices(flag, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        tmain.main(["--configs", str(CONFIG), "--data_root",
                    str(REPO / "data_snapshots"), "--epochs", "1",
                    "--device", "cpu", *NARROW, *flag])
