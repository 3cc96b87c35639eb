"""The code2 GraphTrans bf16 step under ``--attn_backend flash`` on the CPU
against the JAX package: one bf16 train step of the code2 GraphTrans model
without the virtual node (GCN, emb 128, d_model 128, heads of 32; packing
tiers 512, 384 and 128) whose tiers take K3, K5's segment form and the
plain route, against ``BaseTrainer.make_grad_fn`` with precision bf16
under the JAX package's flash backend with its kernels in interpret mode;
and ``main --precision bf16 --attn_backend flash`` on the code2 GraphTrans
yml at narrow widths. The bf16 CUDA kernels are held against these plain
versions on the card in test_torch_port_cuda.py.

Tolerances are test_torch_port_code2_bf16.py's: STEP_TOL (2e-2 on the loss
and logits, 5e-2 on the gradients) against the JAX bf16 step, and the
port's distance from it within RATIO_XLA (1.5) times that step's own
distance from its f32 step, since in interpret mode the JAX K3's and K5's
Precision.DEFAULT products are exact float32 where the TPU's MXU (and the
port, following the TPU) rounds p and dS to bf16, and the JAX GCN sum on
the CPU sums in bf16 where the port's K7 sums in float32
(test_torch_port_code2_bf16.py's module note). The model without the
virtual node is the one that test file holds to the JAX bf16 step
directly."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    ASTNodeEncoder as JASTNodeEncoder, LinearEdgeEncoder as JLinearEdge)
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer  # noqa: E402
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder  # noqa: E402
from graphtrans_tpu_torch.train.losses import seq_token_loss  # noqa: E402
from graphtrans_tpu_torch.train.precision import cast_params  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import _collate_kw, _hp, _tier_graphs  # noqa: E402
from test_torch_port_code2_bf16 import (  # noqa: E402
    BF, CODE2_YMLS, EMB, D_MODEL, NARROW, RATIO_XLA, SIZES, STEP_TOL, _close,
    _dist, _jax_step, _to_state)
from test_torch_port_model import _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_code2_bf16_step_under_flash_matches_jax():
    """One bf16 forward and backward of the code2 GraphTrans model without
    the virtual node under ``flash``: its tiers of 512, 384 and 128 tokens
    take K3, K5's segment form (heads of 32) and the plain route, as the
    JAX package's TPU branch takes them; loss, logits, every gradient and
    the BatchNorm statistics within STEP_TOL of the JAX bf16 step under
    the same backend (K3 and K5 in interpret mode), and the port's distance
    within RATIO_XLA of the JAX bf16 step's own distance from its f32
    step."""
    graphs, num_tasks = _tier_graphs(SIZES, seed=13)
    caps = (9, 2048, 6144)
    kw = dict(_collate_kw(512), num_tasks=num_tasks)
    jbatch = jb.collate(graphs, *caps, **kw)
    batch = tb.collate(graphs, *caps, **kw).to("cpu")
    assert (batch.pack_w, batch.pack2_w, batch.pack3_w) == (512, 384, 128)
    hp = _hp(EMB, D_MODEL)
    hp.gnn_virtual_node = False
    jmodel = MODELS["gnn-transformer"].build(
        num_tasks, hp,
        JASTNodeEncoder(EMB, num_nodetypes=20, num_nodeattributes=100,
                        max_depth=20), lambda e: JLinearEdge(e))
    v = jax.jit(lambda: jmodel.init({"params": jax.random.key(0),
                                     "dropout": jax.random.key(1)}, jbatch,
                                    None, False))()
    rng = np.random.default_rng(9)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    make = lambda: GNNTransformer(
        num_tasks, 2, EMB, False, D_MODEL, 4, 2 * D_MODEL, 1, True,
        gnn_type="gcn", node_encoder=ASTNodeEncoder(EMB, 20, 100),
        max_seq_len=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_ATTN_BACKEND", "flash")
        mp.setattr(jtr, "_FLASH_INTERPRET", True)
        jlogits, bgrads, jbs, bloss = _jax_step(jmodel, hp, params, stats,
                                                jbatch, "bf16")
        _, fgrads, _, floss = _jax_step(jmodel, hp, params, stats, jbatch,
                                        "f32", logits=False)
    model = load_flax_variables(make(), params, stats)
    ttr.set_attn_backend(model, "flash")
    model.train()
    routes = []
    orig = ttr.attention_route
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "attention_route", lambda *a, **k: routes.append(
            orig(*a, **k)) or routes[-1])
        logits = torch.func.functional_call(
            model, cast_params(model, BF), (batch, Generators.seeded(0, "cpu")))
    loss = seq_token_loss(logits, batch)
    loss.backward()
    assert routes == ["k3", "k5", "plain"]
    assert loss.dtype == torch.float32 and logits.dtype == BF
    fwd_tol, grad_tol = STEP_TOL
    _close(loss, bloss, fwd_tol, "loss")
    _close(logits, jlogits, fwd_tol, "logits")
    bf = _to_state(make, bgrads, stats)
    f32 = _to_state(make, fgrads, stats)
    port_d, jax_d = [_dist(loss, bloss)], [_dist(bloss, floss)]
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _close(p.grad, bf[name], grad_tol, name)
        port_d.append(_dist(p.grad, bf[name]))
        jax_d.append(_dist(bf[name], f32[name]))
    want_stats = _to_state(make, params, jbs)
    for name, buf in model.named_buffers():
        _close(buf, want_stats[name], grad_tol, name)
    ratio = max(port_d) / max(jax_d)
    assert ratio <= RATIO_XLA, (
        f"the port's bf16 step is {max(port_d):.3e} from the JAX package's "
        f"bf16 step, which is {max(jax_d):.3e} from its f32 step: ratio "
        f"{ratio:.3f}")


def test_main_trains_code2_graphtrans_in_bf16_under_flash(capsys):
    """``main --precision bf16 --attn_backend flash`` trains the code2
    GraphTrans yml on the snapshot for one epoch at narrow widths (d_model
    128, heads of 32; the train split's tiers 1024, 384 and 128 on K3,
    K5's segment form and the plain route): finite, positive losses, the
    precision on the epoch line."""
    res = tmain.main(["--configs", str(REPO / CODE2_YMLS[1]), "--data_root",
                      str(REPO / "data_snapshots"), "--epochs", "1",
                      "--batch_size", "16", "--seed", "0", "--device", "cpu",
                      "--precision", "bf16", "--attn_backend", "flash",
                      *NARROW])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1 and res["epochs"] == lines
    r = lines[0]
    assert r["steps"] >= 1 and np.isfinite(r["loss"]) and r["loss"] > 0
    assert r["precision"] == "bf16"
