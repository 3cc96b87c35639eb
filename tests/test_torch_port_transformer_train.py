"""Training the port's Transformer-only GraphTrans (model_type transformer)
against the JAX package on the CPU: K4's and K5's plain versions with
attention dropout (the same masks) against the Pallas kernels in interpret
mode, forward and gradients; K11's plain version against ``byte_dropout``
in interpret mode; the whole train step against ``BaseTrainer`` (loss,
every gradient, parameters after one and three AdamW steps); then the
training entry point on both ymls."""

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
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, AtomEncoder as JAtomEncoder)
from graphtrans_tpu.ops.pallas import attention_packed as jap  # noqa: E402
from graphtrans_tpu.ops.pallas import dropout as jdrop  # noqa: E402
from graphtrans_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from graphtrans_tpu.ops.pallas import prng as jprng  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.optim import build_optimizer as jax_optimizer  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import (  # noqa: E402
    BaseTrainer, apply_update)
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch import predict  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.models.transformer import (  # noqa: E402
    TransformerModule)
from graphtrans_tpu_torch.nn import dropout as tdrop  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import (  # noqa: E402
    ASTNodeEncoder, AtomEncoder)
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_dense_bwd_plain, attention_dense_plain, byte_dropout_plain,
    flash_attention_bwd_plain, flash_attention_plain, key_padding_segs)
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    hash_bits)
from graphtrans_tpu_torch.train.losses import (  # noqa: E402
    binary_multitask_loss, seq_token_loss)
from graphtrans_tpu_torch.train.optim import build_optimizer  # noqa: E402
from graphtrans_tpu_torch.trainers.base_trainer import make_train_step  # noqa: E402
from graphtrans_tpu_torch.utils.config import parse_with_config  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import _tier_graphs  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
MOL_CONFIG = REPO / "configs/molpcba/transformer/pooling=cls.yml"
CODE2_CONFIG = REPO / "configs/code2/transformer/pooling=cls.yml"
SNAPSHOT = str(REPO / "data_snapshots")
OUT_TOL = 2e-5    # attention outputs: f32, sums in another order
GRAD_TOL = 5e-4   # gradients of the same chains
LOSS_TOL = 1e-4   # f32 LN chains; flax LayerNorm uses E[x^2]-E[x]^2
LR = 1e-4         # the published configs' lr
RATE, SEED = 0.3, 1234567
TYPES, ATTRS, SEQ = 20, 100, 5


def _heads(t, H):
    """[B, S, d] -> [B*H, S, hd] (the JAX kernels' layout)."""
    B, S, d = t.shape
    return np.asarray(t).reshape(B, S, H, d // H).transpose(0, 2, 1, 3) \
        .reshape(B * H, S, d // H)


# ---- K4 and K5 with attention dropout --------------------------------------


@pytest.mark.parametrize("B,S,d,H,block", [(10, 99, 128, 4, 33),
                                           (5, 257, 256, 4, 0)])
def test_k4_dropout_matches_jax_kernel(B, S, d, H, block):
    """K4's plain version at rate 0.3 against ``attention_packed_qkv`` in
    interpret mode (the same mask: K2's tiling with r the packed row, over
    more than one program of rows), forward and dqkv through ``jax.vjp``;
    a block without a valid key gives zeros and zero dq."""
    rng = np.random.default_rng(S)
    qkv = rng.standard_normal((B, S, 3 * d)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    dead = slice(block, 2 * block) if block else slice(0, S)
    valid[1, dead] = False
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jap.attention_packed_qkv(
        t, jnp.asarray(valid), SEED, H, RATE, True, True, block),
        jnp.asarray(qkv))
    args = (torch.from_numpy(qkv), torch.from_numpy(valid), H, block)
    got = attention_dense_plain(*args, RATE, SEED).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=OUT_TOL, rtol=0)
    dqkv = attention_dense_bwd_plain(*args[:3], torch.from_numpy(g), block,
                                     RATE, SEED).numpy()
    np.testing.assert_allclose(dqkv, np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=GRAD_TOL, rtol=0)
    assert not got[1, dead].any() and not dqkv[1, dead, :d].any()
    assert np.abs(got - attention_dense_plain(*args).numpy()).max() > 0.1


def _jax_keep(shape, rate, seed):
    """The JAX flash kernel's keep mask drawn from its package's
    interpret-mode hash instead of the TPU PRNG."""
    thresh = jnp.uint32(min(max(1.0 - rate, 0.0), 1.0) * 0xFFFFFFFF)
    bits = jprng.random_bits_u32(shape, seed, interpret=True)
    return (bits < thresh).astype(jnp.float32)


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("form", ["key_padding", "seg"])
def test_k5_dropout_matches_jax_kernel(form, rate, monkeypatch):
    """K5's plain version against ``flash_attention`` and
    ``flash_attention_seg`` in interpret mode at S = 520 (three 256-query
    tiles), with the kernel's ``_dropout_keep`` drawn from the package's
    interpret-mode hash; forward, dq, dk and dv through ``jax.vjp``."""
    monkeypatch.setattr(jfa, "_dropout_keep", _jax_keep)
    B, S, d, H = 2, 520, 64, 2
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((B, S, 3 * d)).astype(np.float32)
    g = rng.standard_normal((B, S, d)).astype(np.float32)
    if form == "key_padding":
        valid = np.ones((B, S), bool)
        valid[0, 300:-1] = False
        segq, segk = (t.numpy() for t in key_padding_segs(
            torch.from_numpy(valid)))
        call = lambda q, k, v: jfa.flash_attention(
            q, k, v, jnp.asarray(np.repeat(valid, H, 0)), SEED, rate, True,
            True)
    else:
        segq = np.full((B, S), -1, np.int32)
        segq[0, :200], segq[0, 200:450], segq[1, 10:500] = 0, 1, 3
        segk = segq
        call = lambda q, k, v: jfa.flash_attention_seg(
            q, k, v, jnp.asarray(np.repeat(segq, H, 0)), SEED, rate, True,
            True)
    q, k, v = (jnp.asarray(_heads(t, H)) for t in np.split(qkv, 3, -1))
    want, vjp = jax.vjp(call, q, k, v)
    args = (torch.from_numpy(qkv), torch.from_numpy(segq),
            torch.from_numpy(segk), H)
    got = flash_attention_plain(*args, rate, SEED).numpy()
    np.testing.assert_allclose(_heads(got, H), np.asarray(want),
                               atol=OUT_TOL, rtol=0)
    dqkv = flash_attention_bwd_plain(*args, torch.from_numpy(g), rate,
                                     SEED).numpy()
    for mine, theirs in zip(np.split(dqkv, 3, -1),
                            vjp(jnp.asarray(_heads(g, H)))):
        np.testing.assert_allclose(_heads(mine, H), np.asarray(theirs),
                                   atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, -5, 123456789])
def test_torch_hash_matches_jax_interpret_hash(seed):
    """The port's torch hash, bit for bit, over a 256 x 256 tile (the
    position layout of K5's tiles) under a seed of each kind."""
    i = torch.arange(256)[:, None]
    pos = i * 256 + torch.arange(256)[None, :]
    got = hash_bits(pos, torch.tensor(seed % 2**32)).numpy()
    want = np.asarray(jprng._hash_bits_u32((256, 256), jnp.int32(seed)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


# ---- K11 -------------------------------------------------------------------


def test_byte_dropout_matches_jax_kernel():
    """K11's plain version against ``byte_dropout(interpret=True)`` on a
    ragged [2100, 256] (three programs of 1024 rows, the last short),
    forward and backward (the same mask on the cotangent)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2100, 256)).astype(np.float32)
    g = rng.standard_normal((2100, 256)).astype(np.float32)
    t = int(round(RATE * 256))
    want, vjp = jax.vjp(lambda a: jdrop.byte_dropout(a, SEED, t, True),
                        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = byte_dropout_plain(tx, SEED, t)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy() == 0,
                                  np.asarray(want) == 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(
        jnp.asarray(g))[0]), rtol=1e-6, atol=0)
    assert abs((got != 0).float().mean().item() - (256 - t) / 256) < 0.01


def test_byte_dropout_module_takes_k11_behind_the_switch(monkeypatch):
    """``ByteDropout`` routes to K11 only with ``FUSED`` set, and then only
    a tensor of at least ``MIN_SIZE`` elements whose last dim is a multiple
    of 128 (each draw takes one host seed); off, the bytes come from the
    device generator as before."""
    drop = tdrop.ByteDropout(RATE).train()
    big, small = torch.randn(2048, 128), torch.randn(2048, 96)
    gen = tdrop.Generators.seeded(3, "cpu")
    off = drop(big, gen)
    monkeypatch.setattr(tdrop, "FUSED", True)
    assert tdrop.fused_route(big) and not tdrop.fused_route(small)
    assert not tdrop.fused_route(torch.randn(16, 128))
    gen = tdrop.Generators.seeded(3, "cpu")
    on = drop(big, gen)
    seed = tdrop.Generators.seeded(3, "cpu").kernel_seed()
    assert torch.equal(on, byte_dropout_plain(big, seed, 77))
    assert not torch.equal(on, off)


# ---- the whole train step, against BaseTrainer at dropout 0 ---------------


def _hp(d_model, nhead, layers, max_input_len=1000, max_seq_len=None):
    return argparse.Namespace(
        model_type="transformer", graph_pooling="cls", gnn_type="gcn",
        gnn_virtual_node=False, d_model=d_model, nhead=nhead,
        dim_feedforward=2 * d_model, transformer_dropout=0.0,
        transformer_activation="relu", num_encoder_layers=layers,
        max_input_len=max_input_len, transformer_norm_input=True,
        max_seq_len=max_seq_len, precision="f32", lr=LR, weight_decay=0.01,
        grad_clip=1.0, scheduler=None, epochs=1)


def _mol_step_case():
    """8 molecules (rows of 3 graphs of 33 tokens at d 128: K4's route)."""
    D, H = 128, 4
    graphs = ts.make_mol_dataset(num_graphs=7, num_tasks=6, min_nodes=3,
                                 max_nodes=30, seed=12)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", dense_cap=32)
    hp = _hp(D, H, 2)
    jmodel = MODELS["transformer"].build(6, hp, JAtomEncoder(D), None)
    make = lambda: TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 2, 1000,
                                     True)
    return (jb.collate(graphs, 8, 256, 1024, **kw),
            tb.collate(graphs, 8, 256, 1024, **kw), hp, jmodel, make,
            binary_multitask_loss, jlosses.binary_multitask_loss)


def _code2_step_case():
    """Four ASTs, one of 600 nodes (rows of 601 tokens: K5's route)."""
    D, H = 64, 2
    graphs, num_tasks = _tier_graphs((600, 30, 250, 9), seed=5)
    kw = dict(num_tasks=num_tasks, max_seq_len=SEQ, y_dtype="int32",
              max_input_len=600, dense_cap=608)
    hp = _hp(D, H, 1, 600, SEQ)
    jmodel = MODELS["transformer"].build(
        num_tasks, hp, JASTNodeEncoder(D, num_nodetypes=TYPES,
                                       num_nodeattributes=ATTRS,
                                       max_depth=20), None)
    make = lambda: TransformerModule(num_tasks, ASTNodeEncoder(D, TYPES, ATTRS),
                                     D, H, 2 * D, 1, 600, True,
                                     max_seq_len=SEQ)
    return (jb.collate(graphs, 5, 1024, 4096, **kw),
            tb.collate(graphs, 5, 1024, 4096, **kw), hp, jmodel, make,
            seq_token_loss, jlosses.seq_token_loss)


def _jax_route(mp, name):
    """molpcba "k4": the JAX package's packed_fused route, K4 in interpret
    mode; "xla": its CPU route (dense; chunked at S >= 512)."""
    if name == "k4":
        mp.setattr(jtr, "_ATTN_BACKEND", "packed_fused")
        mp.setattr(jtr, "_PFUSED_INTERPRET", True)


@pytest.fixture(scope="module", params=["mol-xla", "mol-k4", "code2-xla"])
def step_case(request):
    kind, route = request.param.split("-")
    jbatch, batch, hp, jmodel, make, loss, jloss_fn = (
        _mol_step_case() if kind == "mol" else _code2_step_case())
    S = min(batch.max_nodes_dense, hp.max_input_len) + 1
    assert S == (33 if kind == "mol" else 601)
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    rng = np.random.default_rng(8)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    with pytest.MonkeyPatch.context() as mp:
        _jax_route(mp, route)
        grad_fn = jax.jit(BaseTrainer.make_grad_fn(jmodel, jloss_fn, hp))
        jgrads, _, jloss = jax.device_get(grad_fn(
            TrainState.create(params, {}, None), jbatch, jax.random.key(2)))
    return dict(jbatch=jbatch, batch=batch.to("cpu"), hp=hp, make=make,
                loss=loss, grad_fn=grad_fn, params=params, jgrads=jgrads,
                jloss=jloss,
                tmodel=load_flax_variables(make(), params, {}))


def _to_state(make, params) -> dict:
    twin = load_flax_variables(make(), params, {})
    return {k: v.numpy() for k, v in twin.state_dict().items()}


def test_transformer_train_step_loss_and_grads_match_jax(step_case):
    """Loss and every gradient of one forward and backward in training
    mode against ``BaseTrainer.make_grad_fn``."""
    c = step_case
    twin = c["make"]()
    twin.load_state_dict(c["tmodel"].state_dict())
    twin.train()
    loss = c["loss"](twin(c["batch"], tdrop.Generators.seeded(0, "cpu")),
                     c["batch"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(c["jloss"]), atol=LOSS_TOL,
                               rtol=0)
    want = _to_state(c["make"], c["jgrads"])
    for name, p in twin.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_transformer_train_step_params_match_jax_after_1_and_3_steps(
        step_case):
    """Params after 1 and 3 AdamW steps (weight decay 0.01, global-norm
    clip 1.0) under the rule of the GraphTrans step tests: every entry
    within 2*lr per step, and every entry whose first gradient is not below
    1e-5 within 1e-6 plus 1% of lr per step. The JAX side is
    ``BaseTrainer.make_train_step``'s body: the fixture's compiled gradient
    function (on its route), then ``apply_update``."""
    c = step_case
    g1 = _to_state(c["make"], c["jgrads"])
    tx, _ = jax_optimizer(c["hp"], 1)
    jstate = TrainState.create(c["params"], {}, tx.init(c["params"]))
    update = jax.jit(lambda st, g, bs, loss: apply_update(st, g, bs, loss,
                                                          tx, "gnn_node"))
    model = c["make"]()
    model.load_state_dict(c["tmodel"].state_dict())
    step = make_train_step(model, c["loss"], build_optimizer(model, c["hp"], 1),
                           tdrop.Generators.seeded(0, "cpu"))
    for k in (1, 2, 3):
        # the state as the fixture traced it (no optimizer state), so the
        # compiled route is reused
        grads, bs, jloss = c["grad_fn"](
            TrainState.create(jstate.params, {}, None), c["jbatch"],
            jax.random.key(3))
        jstate, jloss = update(jstate, grads, bs, jloss)
        loss = step(c["batch"])
        np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_TOL,
                                   rtol=0)
        if k == 2:
            continue
        want = _to_state(c["make"], jax.device_get(jstate.params))
        for name, t in model.named_parameters():
            diff = np.abs(t.detach().numpy() - want[name])
            assert diff.max() <= 2 * LR * k + 1e-6, name
            firm = np.abs(g1[name]) >= 1e-5
            np.testing.assert_array_less(
                np.where(firm, diff, 0), 1e-6 + 0.01 * LR * k, err_msg=name)


# ---- the entry point --------------------------------------------------------


@pytest.mark.parametrize("config,fused,narrow", [
    (MOL_CONFIG, True, ["--d_model", "128", "--num_encoder_layers", "1"]),
    (CODE2_CONFIG, False, ["--d_model", "32", "--gnn_emb_dim", "32",
                           "--num_encoder_layers", "1", "--batch_size", "64",
                           "--max_input_len", "255"])])
def test_main_trains_transformer_and_predict_serves_it(tmp_path, capsys,
                                                       monkeypatch, config,
                                                       fused, narrow):
    """Both ymls through the training entry at narrow widths with attention
    dropout 0.3 for 2 epochs (molpcba: K4's route at d 128, with K11
    switched on; code2 with rows cut to 256: the plain route's ByteDropout
    on the probabilities): finite losses, every parameter moved, and
    ``predict --weights`` serves what it saved."""
    monkeypatch.setattr(tdrop, "FUSED", fused)
    argv = ["--configs", str(config), "--data_root", SNAPSHOT, "--seed", "0",
            "--device", "cpu", *narrow]
    res = tmain.main([*argv, "--epochs", "2", "--save_path", str(tmp_path)])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["epoch"] for r in lines] == [1, 2] and res["epochs"] == lines
    assert all(r["steps"] > 0 and np.isfinite(r["loss"]) and r["loss"] > 0
               for r in lines)
    args = parse_with_config(tmain.build_parser(), argv)
    assert args.transformer_dropout == 0.3
    splits, num_tasks, code = predict.load_splits(args)
    init = tmain.build_run(args, num_tasks, "cpu", 1, code)[0]
    trained = torch.load(res["saved"], weights_only=True)
    still = [n for n, p in init.named_parameters()
             if torch.equal(p, trained[n])]
    assert not still
    out = tmp_path / "p.jsonl"
    served = predict.main([*argv, "--split", "valid", "--weights",
                           res["saved"], "--out", str(out)])
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert served["records"] == len(splits["valid"]) == len(recs)
    if code is None:
        assert all(np.isfinite(r["logits"]).all() for r in recs)
    else:
        assert all(len(r["tokens"]) == SEQ for r in recs)
