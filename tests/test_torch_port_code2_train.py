"""The port's ogbg-code2 training path against the JAX package on the CPU:
the sequence loss, the whole GCN-virtual train step (loss, every gradient,
BN running statistics, parameters after one and three AdamW steps) on a
flat batch with three packing tiers and a graph past ``max_input_len``,
through the XLA routes and through the interpret-mode K2 and flash_hil
kernels; then the training entry point on the code2 snapshot."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, LinearEdgeEncoder as JLinearEdge)
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.optim import build_optimizer as jax_optimizer  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import (  # noqa: E402
    GNNTransformer, build_gnn_transformer)
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder  # noqa: E402
from graphtrans_tpu_torch.nn.init import init_weights  # noqa: E402
from graphtrans_tpu_torch.train.losses import seq_token_loss  # noqa: E402
from graphtrans_tpu_torch.train.optim import build_optimizer  # noqa: E402
from graphtrans_tpu_torch.trainers.base_trainer import make_train_step  # noqa: E402
from graphtrans_tpu_torch.utils.config import parse_with_config  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import (  # noqa: E402
    ATTRS, CONFIG, CONFIGS, SEQ, SIZES, SNAPSHOT, TYPES, _collate_kw, _hp,
    _tier_graphs)
from test_torch_port_model import _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

LOSS_TOL = 1e-4   # f32 BN/LN chains (flax LayerNorm uses E[x^2]-E[x]^2)
GRAD_TOL = 5e-4   # gradients of the same chains
LR = 1e-4         # the published config's lr


def test_seq_token_loss_matches_jax():
    graphs, num_tasks = _tier_graphs((40, 9, 130, 60), seed=3)
    b = jb.collate(graphs, 6, 512, 2048, **dict(_collate_kw(512),
                                                num_tasks=num_tasks))
    assert b.y_arr.shape == (6, SEQ) and (~b.graph_mask).sum() == 2
    pred = np.random.default_rng(4).normal(0, 3, (6, SEQ, num_tasks)).astype(
        np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jlosses.seq_token_loss(p, b))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = seq_token_loss(tp, tb.collate(graphs, 6, 512, 2048, **dict(
        _collate_kw(512), num_tasks=num_tasks)).to("cpu"))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               atol=1e-7, rtol=0)
    assert not tp.grad.numpy()[~b.graph_mask].any()   # padding graphs


# ---- the whole train step --------------------------------------------------


def _model(num_tasks, emb, d_model):
    return GNNTransformer(num_tasks, 2, emb, True, d_model, 4, 2 * d_model,
                          1, True, gnn_type="gcn",
                          node_encoder=ASTNodeEncoder(emb, TYPES, ATTRS),
                          max_seq_len=SEQ)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def step_case(request):
    """One flat batch (tiers 512 or 1024, 384, 128; a 1100-node graph);
    the JAX model's gradients (BaseTrainer.make_grad_fn with the sequence
    loss) from randomised variables, dropout off."""
    emb, d_model, w, pallas = CONFIGS[request.param]
    graphs, num_tasks = _tier_graphs(SIZES, seed=11)
    caps = (9, 3072, 8192)
    kw = dict(_collate_kw(w), num_tasks=num_tasks)
    jbatch = jb.collate(graphs, *caps, **kw)
    batch = tb.collate(graphs, *caps, **kw).to("cpu")
    hp = _hp(emb, d_model)
    hp.lr, hp.weight_decay, hp.grad_clip = LR, 0.01, 1.0
    hp.scheduler, hp.epochs = None, 1
    jmodel = MODELS["gnn-transformer"].build(
        num_tasks, hp,
        JASTNodeEncoder(emb, num_nodetypes=TYPES, num_nodeattributes=ATTRS,
                        max_depth=20), lambda e: JLinearEdge(e))
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(9)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    make = lambda: _model(num_tasks, emb, d_model)
    tmodel = load_flax_variables(make(), params, stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_PFUSED_INTERPRET", pallas)
        mp.setattr(jtr, "_FLASH_INTERPRET", pallas)
        grad_fn = jax.jit(BaseTrainer.make_grad_fn(
            jmodel, jlosses.seq_token_loss, hp))
        jgrads, jbs, jloss = jax.device_get(grad_fn(
            TrainState.create(params, stats, None), jbatch,
            jax.random.key(2)))
    return dict(pallas=pallas, jmodel=jmodel, jbatch=jbatch, batch=batch,
                hp=hp, params=params, stats=stats, tmodel=tmodel, make=make,
                jgrads=jgrads, jbs=jbs, jloss=jloss)


def _to_state(make, params, batch_stats) -> dict:
    """A flax tree (params, gradients or updated state) in the port's
    state-dict layout."""
    twin = load_flax_variables(make(), params, batch_stats)
    return {k: v.numpy() for k, v in twin.state_dict().items()}


def test_code2_train_step_loss_grads_and_stats_match_jax(step_case):
    c = step_case
    b = c["batch"]
    assert b.pack_w in (512, 1024) and b.pack2_w == 384 and b.pack3_w == 128
    twin = c["make"]()
    twin.load_state_dict(c["tmodel"].state_dict())
    twin.train()
    loss = seq_token_loss(twin(b, Generators.seeded(0, "cpu")), b)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(c["jloss"]), atol=LOSS_TOL,
                               rtol=0)
    want = _to_state(c["make"], c["jgrads"], c["stats"])
    for name, p in twin.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=GRAD_TOL,
                                   rtol=0, err_msg=name)
    stats = _to_state(c["make"], c["params"], c["jbs"])
    for name, buf in twin.named_buffers():   # E[x^2]-E[x]^2 in f32
        np.testing.assert_allclose(buf.numpy(), stats[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_code2_train_step_params_match_jax_after_1_and_3_steps(step_case,
                                                               monkeypatch):
    """Params and BN statistics after 1 and 3 AdamW steps (weight decay
    0.01, global-norm clip 1.0), under the rule of the molpcba step test
    (``test_torch_port_train.py``): every entry within 2*lr per step, and
    every entry whose first gradient is not below 1e-5 within 1e-6 plus 1%
    of lr per step (Adam turns a rounding-level gradient into an update of
    up to lr, of the rounding's sign)."""
    c = step_case
    monkeypatch.setattr(jtr, "_PFUSED_INTERPRET", c["pallas"])
    monkeypatch.setattr(jtr, "_FLASH_INTERPRET", c["pallas"])
    g1 = _to_state(c["make"], c["jgrads"], c["stats"])
    tx, _ = jax_optimizer(c["hp"], 1)
    jstate = TrainState.create(c["params"], c["stats"], tx.init(c["params"]))
    jstep = BaseTrainer.make_train_step(
        c["jmodel"], jlosses.seq_token_loss, tx, c["hp"], donate=False)
    model = c["make"]()
    model.load_state_dict(c["tmodel"].state_dict())
    opt = build_optimizer(model, c["hp"], 1)
    step = make_train_step(model, seq_token_loss, opt,
                           Generators.seeded(0, "cpu"))
    for k in (1, 2, 3):
        jstate, jloss = jstep(jstate, c["jbatch"], jax.random.key(3))
        loss = step(c["batch"])
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   atol=LOSS_TOL, rtol=0)
        if k == 2:
            continue
        want = _to_state(c["make"], jax.device_get(jstate.params),
                         jax.device_get(jstate.batch_stats))
        for name, t in model.named_parameters():
            diff = np.abs(t.detach().numpy() - want[name])
            assert diff.max() <= 2 * LR * k + 1e-6, name
            firm = np.abs(g1[name]) >= 1e-5
            np.testing.assert_array_less(
                np.where(firm, diff, 0), 1e-6 + 0.01 * LR * k, err_msg=name)
        for name, t in model.named_buffers():
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-5,
                                       atol=1e-5 + 0.1 * LR * k * (k - 1),
                                       err_msg=name)


# ---- the train loader and the entry point ---------------------------------


def test_code2_train_batches_match_graph_loader():
    """Two shuffled epochs of the code2 snapshot's train split in ``main``'s
    layout (the split's tiers 1024/384/128, row caps sampled from the seed,
    an overflowing batch split) give the JAX GraphLoader's batches."""
    from graphtrans_tpu.data.loader import GraphLoader

    args = parse_with_config(tmain.build_parser(), [
        "--configs", str(CONFIG), "--data_root", SNAPSHOT, "--batch_size",
        "16", "--seed", "3"])
    splits, num_tasks, _ = predict.load_splits(args)
    graphs = splits["train"]
    layout = predict.serving_layout(splits, args, num_tasks, 16,
                                    split="train", seed=3)
    jl = GraphLoader(graphs, 16, shuffle=True, seed=3, num_tasks=num_tasks,
                     max_seq_len=SEQ, y_dtype="int32", max_input_len=1000,
                     fixed_caps=(layout["node_cap"], layout["edge_cap"]),
                     use_native=False, seq_pack=True)
    for epoch in range(2):
        want = [(list(b.graph_ids[b.graph_mask]), b.pack_rows, b.pack2_rows,
                 b.pack3_rows) for b in jl]
        got = [(list(b.graph_ids[b.graph_mask]), b.pack_rows, b.pack2_rows,
                b.pack3_rows) for b in tmain.iterate_batches(
                    graphs, order=tmain.shuffled_order(len(graphs), 3, epoch),
                    **layout)]
        assert got == want
    assert (layout["seq_pack_w"], layout["seq_pack_w2"],
            layout["seq_pack_w3"]) == (1024, 384, 128)
    assert tuple(jl._pack_rows_cap) == (layout["seq_pack_rows"],
                                        layout["seq_pack_rows2"],
                                        layout["seq_pack_rows3"])


NARROW = ["--gnn_emb_dim", "32", "--d_model", "32", "--gnn_num_layer", "2",
          "--num_encoder_layers", "1"]


def test_main_code2_trains_and_predict_serves_its_weights(tmp_path, capsys):
    """Two epochs on the code2 snapshot's train split (tiers 1024/384/128,
    attention dropout 0.3 in every tier), finite losses, every parameter
    moved; predict serves the saved weights."""
    argv = ["--configs", str(CONFIG), "--data_root", SNAPSHOT,
            "--batch_size", "16", "--seed", "0", "--device", "cpu", *NARROW]
    res = tmain.main([*argv, "--epochs", "2", "--save_path", str(tmp_path)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["epoch"] for r in lines] == [1, 2] and res["epochs"] == lines
    for r in lines:
        assert r["steps"] >= 12 and np.isfinite(r["loss"]) and r["loss"] > 0
        assert r["lr"] == 1e-4 and r["device"] == "cpu"
    args = parse_with_config(tmain.build_parser(), argv)
    assert args.transformer_dropout == 0.3
    splits, num_tasks, code = predict.load_splits(args)
    fresh = init_weights(build_gnn_transformer(args, num_tasks, data=code),
                         torch.Generator().manual_seed(0))
    trained = torch.load(res["saved"], weights_only=True)
    still = [n for n, p in fresh.named_parameters()
             if torch.equal(p, trained[n])]
    assert not still, still
    out = tmp_path / "code2.jsonl"
    served = predict.main(["--configs", str(CONFIG), "--data_root", SNAPSHOT,
                           "--split", "test", "--batch_size", "16",
                           "--weights", res["saved"], "--out", str(out),
                           "--device", "cpu", *NARROW])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert served["records"] == len(recs) == len(splits["test"])
    assert all(len(r["tokens"]) == SEQ for r in recs)
    assert 0.0 <= served["F1"] <= 1.0

