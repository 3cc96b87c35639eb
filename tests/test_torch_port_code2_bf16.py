"""The code2 bf16 step (``--precision bf16``) on the CPU against the JAX
package: K2's long, K3's and K7's plain bf16 versions against the Pallas
kernels in bf16 in interpret mode (K7-bwd's against ``jax.vjp`` of the
same float32 function on the JAX package's XLA route, cast as the kernel
casts: the Pallas kernel has no backward), one bf16 train step of the
code2 GraphTrans (GCN with and without the virtual node, emb 128,
d_model 128, tiers 512, 384 and 128) against ``BaseTrainer.make_grad_fn``
with precision bf16, the dtypes
of its activations, and ``main --precision bf16`` on both code2
GraphTrans ymls. The bf16 CUDA kernels are held against these plain
versions on the card in test_torch_port_cuda.py.

Tolerances are test_torch_port_bf16.py's: outputs within 7.8e-3 and
gradients within 1.6e-2 of max(1, max|ref|) for the kernels' plain
versions, 2e-2 (loss, logits) and 5e-2 (gradients, BatchNorm statistics)
for the step. Where the port rounds elsewhere than the JAX package on the
CPU its distance is bounded instead by RATIO_XLA times the JAX package's
own bf16-to-f32 distance: in interpret mode the JAX K3's Precision.DEFAULT
products are exact float32, where the TPU's MXU (and the port, following
the TPU) rounds p and dS to bf16 (ROADMAP.md section 3, "K3's rounding in
bf16"); and at any width the JAX package's CPU route for the GCN sum is
``ops/scatter.py``'s, which sums in bf16, where the port's K7 sums in
float32 and rounds once (section 3, "K7's rounding in bf16").

The step runs both code2 GraphTrans models. Without the virtual node
(the no-virtual yml) the port is held to the JAX bf16 step within
STEP_TOL and RATIO_XLA. With it (the JK=cat yml) the JAX bf16 step on the
CPU is itself 0.13 of the gradients' scale from its f32 step: its virtual
node's per-graph pool (``jax.ops.segment_sum`` on bf16 data) and the
transpose of its broadcast (``vn[node_graph]``) are scatters that XLA's
CPU backend rounds to bf16 at every add, so a 400-node graph's sums lose
some 2 %, which the virtual node's BatchNorm over a few graph rows
magnifies; torch's ``index_add_`` on bf16 data accumulates in float32 on
the CPU (and on the card under deterministic algorithms) and rounds once.
There the port is held to the JAX f32 step within STEP_TOL and to the JAX
bf16 step within RATIO_XLA of that step's own distance from its f32 step
(ROADMAP.md section 3, "The virtual node's sums in bf16")."""

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
    ASTNodeEncoder as JASTNodeEncoder, LinearEdgeEncoder as JLinearEdge)
from graphtrans_tpu.ops import scatter as jscatter  # noqa: E402
from graphtrans_tpu.ops.pallas import spmm as jspmm  # noqa: E402
from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu.ops.pallas.flash_hil import flash_hil_seg_qkv  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import (  # noqa: E402
    BaseTrainer, make_param_cast)
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import ASTNodeEncoder  # noqa: E402
from graphtrans_tpu_torch.nn import conv as tconv  # noqa: E402
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_seg, attention_seg_bwd_plain, attention_seg_plain,
    flash_hil_seg, flash_hil_seg_bwd_plain, flash_hil_seg_plain, spmm,
    spmm_bwd_plain, spmm_plain)
from graphtrans_tpu_torch.train.losses import seq_token_loss  # noqa: E402
from graphtrans_tpu_torch.train.precision import cast_params  # noqa: E402
from graphtrans_tpu_torch.utils.config import (  # noqa: E402
    check_ported, parse_with_config)
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_attention import _case as k2_case  # noqa: E402
from test_torch_port_code2 import _collate_kw, _hp, _tier_graphs  # noqa: E402
from test_torch_port_model import _random_stats  # noqa: E402
from test_torch_port_spmm import _case as k7_case  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CODE2_YMLS = ["configs/code2/gnn-transformer/JK=cat/pooling=cls+norm_input.yml",
              "configs/code2/gnn-transformer/no-virtual/"
              "pooling=cls+norm_input.yml"]
BF = torch.bfloat16
OUT_TOL = 7.8e-3    # two bf16 ulps at 1
GRAD_TOL = 1.6e-2   # four
STEP_TOL = (2e-2, 5e-2)   # the model step: loss and logits, gradients
RATIO_XLA = 1.5     # the port's distance over the JAX bf16-to-f32 one
SEED = 2**31 - 5    # K3's per-tile seeds wrap past int32
# d_model 128: at a width off 128 code2's rows take K5 (slice 10, part 3)
NARROW = ["--gnn_emb_dim", "32", "--d_model", "128", "--gnn_num_layer", "2",
          "--num_encoder_layers", "1"]


def _f32(a) -> np.ndarray:
    """A JAX or torch array of any float dtype as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dist(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _close(got, want, tol, what):
    dist = _dist(got, want)
    assert dist <= tol, f"{what}: {dist:.3e} of max(1, max|ref|) > {tol}"


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF)


# ---- the kernels' plain bf16 versions --------------------------------------


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.3, 123457)])
def test_k2_long_plain_bf16_matches_jax_interpret_kernel(rate, seed):
    """K2's forward and dqkv in bf16 on rows of 256 (its long instance on
    the card), 4 heads of 32, against attention_packed_seg_qkv in bf16 in
    interpret mode, with and without dropout (the same counter-hash mask);
    padding tokens exactly 0; the wrapper on CPU tensors is the plain
    version, uncounted."""
    qkv, seg = k2_case(R=4, W=256, d=128, seed=21)
    g = np.random.default_rng(22).standard_normal((4, 256, 128)).astype(
        np.float32)
    f = lambda t: attention_packed_seg_qkv(t, jnp.asarray(seg), seed, 4,
                                           rate, True, True)
    want, vjp = jax.vjp(f, jnp.asarray(qkv, jnp.bfloat16))
    (want_d,) = vjp(jnp.asarray(g, jnp.bfloat16))
    t_seg = torch.from_numpy(seg)
    got = attention_seg_plain(_bf(qkv), t_seg, 4, rate, seed)
    assert got.dtype == BF
    _close(got, want, OUT_TOL, "out")
    assert not _f32(got)[seg < 0].any()
    before = dict(attention_seg.instances)
    assert torch.equal(attention_seg(_bf(qkv), t_seg, 4, rate, seed), got)
    assert attention_seg.instances == before
    dqkv = attention_seg_bwd_plain(_bf(qkv), t_seg, 4, _bf(g), rate, seed)
    assert dqkv.dtype == BF
    _close(dqkv, want_d, GRAD_TOL, "dqkv")
    assert not _f32(dqkv)[seg < 0].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k3_plain_bf16_matches_jax_interpret_kernel(rate):
    """K3's forward and dqkv in bf16 on code2's tier of 512 (a segment of
    390 tokens, single tokens, padding), against flash_hil_seg_qkv in bf16
    in interpret mode with the schedule's dropout: within OUT_TOL and
    GRAD_TOL though the interpret kernel rounds neither p nor dS (its
    DEFAULT products are exact float32 on the CPU), where the port rounds
    both as the TPU does; padding tokens exactly 0."""
    rng = np.random.default_rng(512)
    qkv = rng.standard_normal((2, 512, 384)).astype(np.float32)
    seg = np.full((2, 512), -1, np.int32)
    seg[0, :390], seg[0, 390], seg[0, 391:451] = 0, 1, 2
    seg[1, :500] = 3 + np.arange(500) // 50
    g = rng.standard_normal((2, 512, 128)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: flash_hil_seg_qkv(
        x, jnp.asarray(seg), SEED, 4, rate, True, True),
        jnp.asarray(qkv, jnp.bfloat16))
    (want_d,) = vjp(jnp.asarray(g, jnp.bfloat16))
    t_seg = torch.from_numpy(seg)
    got = flash_hil_seg_plain(_bf(qkv), t_seg, 4, rate, SEED)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want, OUT_TOL, "out")
    before = dict(flash_hil_seg.instances)
    assert torch.equal(flash_hil_seg(_bf(qkv), t_seg, 4, rate, SEED), got)
    assert flash_hil_seg.instances == before
    dqkv = flash_hil_seg_bwd_plain(_bf(qkv), t_seg, 4, _bf(g), rate, SEED)
    assert dqkv.dtype == BF
    _close(dqkv, want_d, GRAD_TOL, "dqkv")
    assert not _f32(got)[seg < 0].any() and not _f32(dqkv)[seg < 0].any()


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weight", ["f32", "bf16"])
def test_k7_plain_bf16_matches_jax_interpret_kernel(message, weight):
    """K7 in bf16 at d 128 against gather_message_scatter in bf16 in
    interpret mode (the weight widened to float32, float32 sums, x's dtype
    out); dx and d_emb against jax.vjp of the same float32 function on the
    XLA route (``ops/scatter.py``), cast as the kernel casts; nodes
    without a valid edge get zero rows. jnp.maximum's gradient is 0.5 at
    an exact tie, torch's relu's 0, and in bf16 x_src + emb is exactly 0
    in some 1 of 256 channels: the case moves those emb values of the
    valid edges by one bf16 step (both sides get the moved value)."""
    x, emb, src, dst, mask, w = k7_case(seed=3)
    xb, eb = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in (x, emb))
    ties = ((xb[src] + eb) == 0) & mask[:, None]
    emb = np.where(ties, eb * (1 + 2.0**-7), emb).astype(np.float32)
    jw = jnp.asarray(w, jnp.float32 if weight == "f32" else jnp.bfloat16)
    idx = [jnp.asarray(a) for a in (src, dst, mask)]
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want_k = jspmm.gather_message_scatter(bf(x), bf(emb), *idx, x.shape[0],
                                          message=message, edge_weight=jw,
                                          interpret=True)

    def xla(xx, ee):
        return jscatter.gather_message_scatter(
            xx.astype(jnp.float32), ee.astype(jnp.float32), *idx, x.shape[0],
            message=message, edge_weight=jw.astype(jnp.float32)).astype(
                xx.dtype)

    want_x, vjp = jax.vjp(xla, bf(x), bf(emb))
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    jdx, jdemb = vjp(bf(g))
    t = [torch.from_numpy(a) for a in (src, dst, mask)]
    tw = torch.from_numpy(w).to(torch.float32 if weight == "f32" else BF)
    got = spmm_plain(_bf(x), _bf(emb), *t, tw, message)
    assert got.dtype == BF and want_k.dtype == jnp.bfloat16
    _close(got, want_k, OUT_TOL, "out against the interpret kernel")
    _close(got, want_x, OUT_TOL, "out against the XLA route")
    assert not _f32(got)[200:].any()
    before = dict(spmm.instances)
    assert torch.equal(spmm(_bf(x), _bf(emb), *t, tw, message), got)
    assert spmm.instances == before
    dx, demb = spmm_bwd_plain(_bf(x), _bf(emb), *t, _bf(g), tw, message)
    assert dx.dtype == demb.dtype == BF
    _close(dx, jdx, GRAD_TOL, "dx")
    _close(demb, jdemb, GRAD_TOL, "d_emb")
    assert not _f32(demb)[~mask].any()


# ---- the code2 step --------------------------------------------------------

SIZES = (500, 200, 400, 60, 9, 130, 300)   # tiers 512, 384 and 128
EMB, D_MODEL = 128, 128


def _jax_step(jmodel, hp, params, stats, jbatch, precision, logits=True):
    """(logits f32 or None, grads, batch_stats, loss) of the JAX train step
    with ``precision``: logits from the forward in training mode on the
    cast params."""
    hp = argparse.Namespace(**dict(vars(hp), precision=precision))
    cast = make_param_cast(hp)

    @jax.jit
    def forward(p):
        out, _ = jmodel.apply({"params": cast(p), "batch_stats": stats},
                              jbatch, None, True,
                              rngs={"dropout": jax.random.key(2)},
                              mutable=["batch_stats"])
        return out.astype(jnp.float32)

    grad_fn = jax.jit(BaseTrainer.make_grad_fn(
        jmodel, jlosses.seq_token_loss, hp))
    grads, bs, loss = jax.device_get(grad_fn(
        TrainState.create(params, stats, None), jbatch, jax.random.key(2)))
    return (np.asarray(forward(params)) if logits else None), grads, bs, loss


@pytest.fixture(scope="module", params=["virtual", "no-virtual"])
def step_case(request):
    """One flat batch (tiers 512, 384 and 128), randomised variables, and
    the JAX model's step in bf16 and in f32 (dropout off) through its
    interpret-mode K2 and K3, with and without the virtual node."""
    virtual = request.param == "virtual"
    graphs, num_tasks = _tier_graphs(SIZES, seed=13)
    caps = (9, 2048, 6144)
    kw = dict(_collate_kw(512), num_tasks=num_tasks)
    jbatch = jb.collate(graphs, *caps, **kw)
    batch = tb.collate(graphs, *caps, **kw).to("cpu")
    hp = _hp(EMB, D_MODEL)
    hp.gnn_virtual_node = virtual
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
        num_tasks, 2, EMB, virtual, D_MODEL, 4, 2 * D_MODEL, 1, True,
        gnn_type="gcn", node_encoder=ASTNodeEncoder(EMB, 20, 100),
        max_seq_len=5)
    tmodel = load_flax_variables(make(), params, stats)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_PFUSED_INTERPRET", True)
        mp.setattr(jtr, "_FLASH_INTERPRET", True)
        jax_bf = _jax_step(jmodel, hp, params, stats, jbatch, "bf16")
        jax_f32 = _jax_step(jmodel, hp, params, stats, jbatch, "f32",
                            logits=virtual)
    return dict(virtual=virtual, make=make, state=tmodel.state_dict(),
                batch=batch, params=params, stats=stats, jax_bf=jax_bf,
                jax_f32=jax_f32)


def _to_state(make, tree, batch_stats) -> dict:
    """A flax tree in the port's state-dict layout."""
    twin = load_flax_variables(make(), tree, batch_stats)
    return {k: v.numpy() for k, v in twin.state_dict().items()}


def _port_step(c):
    """(model, logits, loss) of the port's bf16 forward and backward in
    training mode on a bf16 copy of the float32 masters."""
    model = c["make"]()
    model.load_state_dict(c["state"])
    model.train()
    logits = torch.func.functional_call(model, cast_params(model, BF),
                                        (c["batch"],
                                         Generators.seeded(0, "cpu")))
    loss = seq_token_loss(logits, c["batch"])
    loss.backward()
    return model, logits, loss


def test_code2_bf16_step_matches_jax(step_case):
    """Loss, logits, every gradient and the BatchNorm running statistics of
    one bf16 forward and backward within STEP_TOL of the JAX package's
    bf16 step (with the virtual node: of its f32 step, module note); and
    the port's distance from the JAX bf16 step (loss and gradients, the
    largest over max(1, max|ref|)) within RATIO_XLA of that step's own
    distance from the f32 step."""
    c = step_case
    fwd_tol, grad_tol = STEP_TOL
    b = c["batch"]
    assert (b.pack_w, b.pack2_w, b.pack3_w) == (512, 384, 128)
    model, logits, loss = _port_step(c)
    jlogits, jgrads, jbs, jloss = c["jax_f32" if c["virtual"] else "jax_bf"]
    _, bgrads, _, bloss = c["jax_bf"]
    _, fgrads, _, floss = c["jax_f32"]
    assert loss.dtype == torch.float32 and logits.dtype == BF
    _close(loss, jloss, fwd_tol, "loss")
    _close(logits, jlogits, fwd_tol, "logits")
    want = _to_state(c["make"], jgrads, c["stats"])
    bf = _to_state(c["make"], bgrads, c["stats"])
    f32 = _to_state(c["make"], fgrads, c["stats"])
    port_d, jax_d = [_dist(loss, bloss)], [_dist(bloss, floss)]
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _close(p.grad, want[name], grad_tol, name)
        port_d.append(_dist(p.grad, bf[name]))
        jax_d.append(_dist(bf[name], f32[name]))
    stats = _to_state(c["make"], c["params"], jbs)
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32, name
        _close(buf, stats[name], grad_tol, name)
    ratio = max(port_d) / max(jax_d)
    assert ratio <= RATIO_XLA, (
        f"the port's bf16 step is {max(port_d):.3e} from the JAX package's "
        f"bf16 step, which is {max(jax_d):.3e} from its f32 step: ratio "
        f"{ratio:.3f}")


def test_code2_bf16_step_dtypes(step_case, monkeypatch):
    """No activation of the step is float32 where the JAX step's is bf16
    (the JAX package once leaked float32 into its whole code2 step through
    the edge encoder's input, ``graphtrans_tpu/nn/init.py:48-53``): every
    module's floating output, every nn.Linear input (the encoders' too) and
    the inputs of K7, K2 and K3 are bf16; the loss and the gradients are
    float32."""
    c = step_case
    seen = []
    model = c["make"]()
    model.load_state_dict(c["state"])
    for name, m in model.named_modules():
        m.register_forward_hook(lambda mod, inp, out, name=name: seen.append(
            (name, [t.dtype for t in inp if torch.is_tensor(t)
                    and t.is_floating_point()] if isinstance(
                        mod, torch.nn.Linear) else [],
             out.dtype if torch.is_tensor(out) else None)))
    for mod, fname in ((tconv, "spmm"), (ttr, "attention_seg"),
                       (ttr, "flash_hil_seg")):
        fn = getattr(mod, fname)
        monkeypatch.setattr(mod, fname, lambda *a, fn=fn, fname=fname, **k: (
            seen.append((fname, [a[0].dtype, a[1].dtype]
                         if fname == "spmm" else [a[0].dtype], None))
            or fn(*a, **k)))
    model.train()
    logits = torch.func.functional_call(model, cast_params(model, BF),
                                        (c["batch"],
                                         Generators.seeded(0, "cpu")))
    loss = seq_token_loss(logits, c["batch"])
    loss.backward()
    names = {s[0] for s in seen}
    assert {"spmm", "attention_seg", "flash_hil_seg"} <= names
    assert {"gnn_node.atom_encoder", "gnn_node.convs.0.edge_encoder.lin",
            "head.heads.4"} <= names
    for name, ins, out in seen:
        assert all(dt == BF for dt in ins), (name, ins)
        assert out in (None, BF, torch.bool, torch.int32, torch.int64), (
            name, out)
    assert loss.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32
               for p in model.parameters())


# ---- the entry point -------------------------------------------------------


@pytest.mark.parametrize("config", CODE2_YMLS)
def test_main_trains_code2_in_bf16(config, capsys):
    """``main --precision bf16`` trains each code2 GraphTrans yml on the
    snapshot at narrow widths (its config passes check_ported in bf16):
    finite, positive losses, the precision on every epoch line."""
    argv = ["--configs", str(REPO / config), "--data_root",
            str(REPO / "data_snapshots"), "--precision", "bf16"]
    check_ported(parse_with_config(tmain.build_parser(), argv))
    res = tmain.main([*argv, "--epochs", "1", "--batch_size", "16",
                      "--seed", "0", "--device", "cpu", *NARROW])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1 and res["epochs"] == lines
    r = lines[0]
    assert r["steps"] >= 12 and np.isfinite(r["loss"]) and r["loss"] > 0
    assert r["precision"] == "bf16"
