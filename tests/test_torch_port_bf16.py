"""The bf16 step (``--precision bf16``) on the CPU against the JAX package:
K1 and K1-bwd's and K2 and K2-bwd's plain bf16 versions against the Pallas
kernels in bf16 in interpret mode, one bf16 train step of the molpcba
GraphTrans against ``BaseTrainer.make_grad_fn`` with precision bf16, the
dtypes of the step (bf16 compute, float32 masters, gradients, AdamW state,
BatchNorm statistics and loss), the paths that still refuse bf16, and the
f32 step's bits. The bf16 CUDA kernels are held against these plain
versions on the card in test_torch_port_cuda.py.

Tolerances. A bf16 value carries 8 significant bits, an ulp of 2**-7 at
1: outputs within 7.8e-3 of max(1, max|ref|) (two ulps at the largest
value: the two sides sum in float32 in other orders and may round a value
that lies near a tie to neighbouring bf16 values), gradients within
1.6e-2 (four ulps: they pass two rounding points). The model step within
2e-2 (loss, logits) and 5e-2 (gradients) of max(1, max|ref|): every bf16
op of either framework rounds its result, XLA on the CPU may keep excess
precision inside a fusion, and BatchNorm and LayerNorm amplify the
differences. Where the JAX package takes its Pallas kernels (width 128)
the port is no farther from its bf16 step than that step is from its f32
step; on its XLA route at width 40, whose aggregation rounds the gather,
the message and the sum to bf16 where the port's K1 rounds as the Pallas
kernel does at every width, within RATIO_XLA of that distance."""

import argparse
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.data.batch import collate as jax_collate  # noqa: E402
from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.nn.encoders import AtomEncoder, BondEncoder  # noqa: E402
from graphtrans_tpu.ops import dense_mp as jdm  # noqa: E402
from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu.ops.pallas.gin_agg import VP, fused_gin_agg  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import (  # noqa: E402
    BaseTrainer, make_param_cast)
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch.data.batch import collate  # noqa: E402
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer  # noqa: E402
from graphtrans_tpu_torch.nn import dropout as tdrop  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import ByteDropout, Generators  # noqa: E402
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.ops import dense_mp  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_seg, attention_seg_bwd_plain, attention_seg_plain, gin_agg,
    gin_agg_bwd_plain, gin_agg_plain)
from graphtrans_tpu_torch.train.losses import binary_multitask_loss  # noqa: E402
from graphtrans_tpu_torch.train.optim import build_optimizer  # noqa: E402
from graphtrans_tpu_torch.train.precision import cast_params  # noqa: E402
from graphtrans_tpu_torch.trainers.base_trainer import make_train_step  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import load_flax_variables  # noqa: E402
from tests.test_torch_port_gin_agg import _case as k1_case  # noqa: E402
from tests.test_torch_port_attention import _case as k2_case  # noqa: E402
from tests.test_torch_port_model import _hp, _random_stats  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml"
BF = torch.bfloat16
OUT_TOL = 7.8e-3    # two bf16 ulps at 1
GRAD_TOL = 1.6e-2   # four
STEP_TOL = (2e-2, 5e-2)   # the model step: loss and logits, gradients
RATIO_XLA = 1.5     # the port's distance over the JAX bf16-to-f32 one there
NARROW = ["--gnn_emb_dim", "32", "--d_model", "32", "--gnn_num_layer", "2",
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


# ---- K1 and K1-bwd -------------------------------------------------------


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_k1_plain_bf16_matches_jax_interpret_kernel(with_w, with_scale):
    """K1's forward and its four gradients in bf16 at d 128, against
    fused_gin_agg in bf16 in interpret mode; dT leaves in T's dtype, dscale
    in float32."""
    c = k1_case(128, seed=11)
    b = c["batch"]
    V = len(c["tbl"])
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    tblp = np.concatenate([c["tbl"], np.zeros((VP - V, 128), np.float32)])
    w = bf(c["w"]) if with_w else None
    sc = jnp.float32(c["scale"]) if with_scale else None

    def f(x, tbl, *rest):
        ww = rest[0] if with_w else None
        s = rest[-1] if with_scale else None
        return fused_gin_agg(x, jnp.asarray(b.edge_src_dense),
                             jnp.asarray(b.edge_dst_dense),
                             jnp.asarray(b.edge_mask_dense),
                             jnp.asarray(c["attr"]), tbl, ww, s, True,
                             with_scale, True)

    primals = [bf(c["x"]), bf(tblp)] + ([w] if with_w else []) + (
        [sc] if with_scale else [])
    want, vjp = jax.vjp(f, *primals)
    gout = np.random.default_rng(12).standard_normal(
        c["x"].shape).astype(np.float32)
    jg = vjp(bf(gout))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    args = (t(c["x"]).to(BF), t(b.edge_src_dense), t(b.edge_dst_dense),
            t(b.edge_mask_dense), t(c["attr"]), t(c["tbl"]).to(BF),
            t(c["w"]).to(BF) if with_w else None,
            t(np.array([c["scale"]])) if with_scale else None)
    got = gin_agg_plain(*args)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want, OUT_TOL, "out")
    before = gin_agg.launches                       # CPU: plain, uncounted
    assert torch.equal(gin_agg(*args), got) and gin_agg.launches == before
    dx, dt, dw, dsc = gin_agg_bwd_plain(*args, t(gout).to(BF))
    assert dx.dtype == dt.dtype == BF
    _close(dx, jg[0], GRAD_TOL, "dx")
    assert not _f32(jg[1])[V:].any()
    _close(dt, _f32(jg[1])[:V], GRAD_TOL, "dT")
    if with_w:
        assert dw.dtype == BF
        _close(dw, jg[2], GRAD_TOL, "dw")
    if with_scale:
        assert dsc.dtype == torch.float32
        _close(dsc, jg[-1], GRAD_TOL, "dscale")


# ---- K2 and K2-bwd -------------------------------------------------------


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.3, 123457)])
def test_k2_plain_bf16_matches_jax_interpret_kernel(rate, seed):
    """K2's forward and dqkv in bf16 at d 128 (4 heads of 32), rows of 128,
    over two dropout tiles, against attention_packed_seg_qkv in bf16 in
    interpret mode, with and without dropout (the same counter-hash
    mask)."""
    qkv, seg = k2_case(R=10, W=128, d=128, seed=13)
    g = np.random.default_rng(14).standard_normal(
        (10, 128, 128)).astype(np.float32)
    f = lambda t: attention_packed_seg_qkv(t, jnp.asarray(seg), seed, 4,
                                           rate, True, True)
    want, vjp = jax.vjp(f, jnp.asarray(qkv, jnp.bfloat16))
    (want_dqkv,) = vjp(jnp.asarray(g, jnp.bfloat16))
    t_qkv = torch.from_numpy(qkv).to(BF)
    t_seg = torch.from_numpy(seg)
    got = attention_seg_plain(t_qkv, t_seg, 4, rate, seed)
    assert got.dtype == BF
    _close(got, want, OUT_TOL, "out")
    assert not _f32(got)[seg < 0].any()
    before = attention_seg.launches
    assert torch.equal(attention_seg(t_qkv, t_seg, 4, rate, seed), got)
    assert attention_seg.launches == before
    dqkv = attention_seg_bwd_plain(t_qkv, t_seg, 4, torch.from_numpy(g).to(BF),
                                   rate, seed)
    assert dqkv.dtype == BF
    _close(dqkv, want_dqkv, GRAD_TOL, "dqkv")
    assert not _f32(dqkv)[seg < 0].any()


def test_byte_dropout_bf16_scale():
    """In bf16 a kept element is scaled by 1/(1 - 77/256) rounded to bf16,
    1.4296875, and rounded once (the JAX module's jnp.asarray(scale,
    x.dtype))."""
    x = torch.randn(64, 128).to(BF)
    y = ByteDropout(0.3).train()(x, Generators.seeded(0, "cpu"))
    kept = y != 0
    assert y.dtype == BF
    want = (x.float() * 1.4296875).to(BF)
    assert torch.equal(y[kept], want[kept])
    assert float(torch.tensor(1 / (1 - 77 / 256), dtype=BF)) == 1.4296875


# ---- the model step ------------------------------------------------------

CONFIGS = {"pallas_128": (128, 128, 2, 1, True),
           "xla_40": (40, 32, 2, 1, False)}


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
        jmodel, jlosses.binary_multitask_loss, hp))
    grads, bs, loss = jax.device_get(grad_fn(
        TrainState.create(params, stats, None), jbatch, jax.random.key(2)))
    return (np.asarray(forward(params)) if logits else None), grads, bs, loss


def _port_step(args, state, batch):
    """(logits, grads by name, BN buffers, loss) of the port's bf16 forward
    and backward in training mode."""
    model = GNNTransformer(*args)
    model.load_state_dict(state)
    model.train()
    out = torch.func.functional_call(model, cast_params(model, BF),
                                     (batch, Generators.seeded(0, "cpu")))
    loss = binary_multitask_loss(out, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return out, grads, dict(model.named_buffers()), loss


def _flax_to_state(args, params, batch_stats) -> dict:
    twin = GNNTransformer(*args)
    load_flax_variables(twin, params, batch_stats)
    return {k: v.numpy() for k, v in twin.state_dict().items()}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def step_case(request):
    """One collated batch, randomised variables, and the JAX model's step
    in bf16 and in f32 (dropout off); the JAX package takes its
    interpret-mode Pallas kernels at width 128, its XLA route at 40."""
    emb, d_model, gl, el, pallas = CONFIGS[request.param]
    graphs = make_mol_dataset(num_graphs=8, num_tasks=6, min_nodes=3,
                              max_nodes=30, seed=31)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", node_stride=32,
              dense_edge_cap=96, seq_pack_w=128)
    jbatch = jax_collate(graphs, 9, 9 * 32, 512, **kw)
    batch = collate(graphs, 9, 9 * 32, 512, **kw).to("cpu")
    hp = _hp(emb, d_model, gl, el)
    hp.gnn_dropout = hp.transformer_dropout = 0.0
    jmodel = MODELS["gnn-transformer"].build(
        6, hp, AtomEncoder(emb), lambda e: BondEncoder(e))
    v = jax.jit(lambda: jmodel.init({"params": jax.random.key(0),
                                     "dropout": jax.random.key(1)}, jbatch,
                                    None, False))()
    rng = np.random.default_rng(9)
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
        jax_bf = _jax_step(jmodel, hp, params, stats, jbatch, "bf16")
        jax_f32 = _jax_step(jmodel, hp, params, stats, jbatch, "f32",
                            logits=False)
    return dict(name=request.param, args=args, state=tmodel.state_dict(),
                batch=batch, params=params, stats=stats, jax_bf=jax_bf,
                jax_f32=jax_f32)


def test_bf16_step_matches_jax(step_case):
    """Loss, logits, every gradient and the BN running statistics of one
    bf16 forward and backward against the JAX package's bf16 step; and the
    port's distance from it (loss and gradients, each over max(1,
    max|ref|), the largest of them) no larger than the JAX package's own
    bf16 step's from its f32 step where the JAX package takes its Pallas
    kernels, whose rounding the port's kernels follow. On its XLA route
    (ROADMAP.md section 3, "K1's rounding in bf16") it rounds the
    aggregation elsewhere: there within RATIO_XLA of it."""
    c = step_case
    fwd_tol, grad_tol = STEP_TOL
    logits, grads, bufs, loss = _port_step(c["args"], c["state"], c["batch"])
    jlogits, jgrads, jbs, jloss = c["jax_bf"]
    _, fgrads, _, floss = c["jax_f32"]
    assert loss.dtype == torch.float32 and logits.dtype == BF
    _close(loss, jloss, fwd_tol, "loss")
    _close(logits, jlogits, fwd_tol, "logits")
    want = _flax_to_state(c["args"], jgrads, c["stats"])
    f32 = _flax_to_state(c["args"], fgrads, c["stats"])
    port_d, jax_d = [_dist(loss, jloss)], [_dist(jloss, floss)]
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        _close(g, want[name], grad_tol, name)
        port_d.append(_dist(g, want[name]))
        jax_d.append(_dist(want[name], f32[name]))
    stats = _flax_to_state(c["args"], c["params"], jbs)
    for name, buf in bufs.items():
        assert buf.dtype == torch.float32, name
        _close(buf, stats[name], grad_tol, name)
    ratio = max(port_d) / max(jax_d)
    assert ratio <= (1.0 if c["name"] == "pallas_128" else RATIO_XLA), (
        f"the port's bf16 step is {max(port_d):.3e} from the JAX package's "
        f"bf16 step, which is {max(jax_d):.3e} from its f32 step: ratio "
        f"{ratio:.3f}")
    print(f"{c['name']}: port-vs-JAX bf16 {max(port_d):.3e}, JAX bf16-vs-f32 "
          f"{max(jax_d):.3e}, ratio {ratio:.3f}")


def test_bf16_step_dtypes(step_case, monkeypatch):
    """Through make_train_step with precision bf16: every nn.Linear input
    and K1's and K2's inputs are bf16 (forward hooks, and recorders around
    the wrappers); the master params, their gradients, AdamW's moments,
    BN's running statistics and the loss are float32; every parameter
    moves."""
    c = step_case
    model = GNNTransformer(*c["args"])
    model.load_state_dict(c["state"])
    seen = []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Linear):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: seen.append(
                    (name, inp[0].dtype, out.dtype)))
    for mod, fname in ((dense_mp, "gin_agg"), (ttr, "attention_seg")):
        fn = getattr(mod, fname)
        monkeypatch.setattr(mod, fname, lambda *a, fn=fn, fname=fname, **k: (
            seen.append((fname, a[0].dtype, None)) or fn(*a, **k)))
    hp = argparse.Namespace(lr=1e-3, weight_decay=0.01, grad_clip=1.0,
                            scheduler=None, epochs=1)
    opt = build_optimizer(model, hp, 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, binary_multitask_loss, opt,
                           Generators.seeded(0, "cpu"), "bf16")
    loss = step(c["batch"])
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    names = {s[0] for s in seen}
    assert "gin_agg" in names and "head.head" in names
    assert ("attention_seg" in names) == (c["name"] == "pallas_128")
    for name, dt, out in seen:
        assert dt == BF, (name, dt)
        assert out in (None, BF), (name, out)
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        st = opt.adamw.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
        assert not torch.equal(p.detach(), before[name]), name
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32, name


def test_f32_step_keeps_its_bits(step_case):
    """make_train_step at f32 (the default) is the plain PyTorch step:
    the same loss and parameters, bit for bit, after two steps, under
    deterministic algorithms (the CPU's threaded index_add_ of a gather's
    backward sums in no fixed order otherwise)."""
    c = step_case
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        _two_f32_steps(c)
    finally:
        torch.use_deterministic_algorithms(was)


def _two_f32_steps(c):
    hp = argparse.Namespace(lr=1e-3, weight_decay=0.01, grad_clip=1.0,
                            scheduler=None, epochs=1)
    models = [GNNTransformer(*c["args"]) for _ in range(2)]
    for m in models:
        m.load_state_dict(c["state"])
    opts = [build_optimizer(m, hp, 1) for m in models]
    step = make_train_step(models[0], binary_multitask_loss, opts[0],
                           Generators.seeded(0, "cpu"))
    gen = Generators.seeded(0, "cpu")
    for _ in range(2):
        loss = step(c["batch"])
        models[1].train()
        opts[1].zero_grad()
        ref = binary_multitask_loss(models[1](c["batch"], gen), c["batch"])
        ref.backward()
        opts[1].step()
        assert torch.equal(loss, ref.detach())
    for (n, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), n


# ---- the entry point -----------------------------------------------------


def test_main_trains_in_bf16(capsys):
    res = tmain.main(["--configs", str(CONFIG), "--data_root",
                      str(REPO / "data_snapshots"), "--epochs", "1",
                      "--batch_size", "64", "--seed", "0", "--device", "cpu",
                      "--precision", "bf16", *NARROW])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1 and res["epochs"] == lines
    r = lines[0]
    assert r["steps"] == 3 and np.isfinite(r["loss"]) and r["loss"] > 0
    assert r["precision"] == "bf16"


def test_main_bf16_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["--configs", str(CONFIG), "--data_root",
                    str(REPO / "data_snapshots"), "--epochs", "1",
                    "--precision", "bf16"])


def _packed_layer(mp):
    """``main`` sets the backend packed_layer (set in process only: the
    command line does not take it)."""
    set_backend = tmain.set_attn_backend
    mp.setattr(tmain, "set_attn_backend",
               lambda model, name: set_backend(model, "packed_layer"))


def _fused_k11(mp):
    """K11 switched on (``nn/dropout.py:FUSED``) for every tensor."""
    mp.setattr(tdrop, "FUSED", True)
    mp.setattr(tdrop, "MIN_SIZE", 1)


@pytest.mark.parametrize("config,flags,patch,part", [
    ("configs/code2/transformer/pooling=cls.yml",
     ["--d_model", "128", "--gnn_emb_dim", "128", "--nhead", "2",
      "--num_encoder_layers", "1", "--max_input_len", "63"], _packed_layer,
     "part 3c"),
    ("configs/NCI1/gnn-transformer/no-virtual/"
     "gd=128+gdp=0.1+tdp=0.1+l=3+cosine.yml", ["--runs", "1"], None,
     "its parts"),
    ("configs/molpcba/transformer/pooling=cls.yml",
     ["--d_model", "128", "--nhead", "2", "--num_encoder_layers", "1"],
     _fused_k11, "part 3c"),
    ("configs/NCI109/gnn-transformer/no-virtual/"
     "gd=128+gdp=0.1+tdp=0.1+l=3+cosine.yml", ["--runs", "1"], None,
     "its parts"),
])
def test_main_bf16_refuses_later_paths(config, flags, patch, part,
                                       monkeypatch):
    """What bf16 does not run yet raises NotImplementedError naming slice
    10: the whole-layer route (``packed_layer``, set in process) on the
    code2 Transformer-only yml and K11 (``FUSED``) on the molpcba one, part
    3c, where they run; NCI1's and NCI109's GraphTrans (the strided GCN,
    K6), part 4, in ``check_ported``. (Every backend of the command line
    trains the molpcba and code2 GraphTrans and the Transformer-only ymls
    in bf16 since slice 10's part 3b: test_torch_port_backends_bf16.py.)"""
    if patch is not None:
        patch(monkeypatch)
    with pytest.raises(NotImplementedError, match="slice 10") as err:
        tmain.main(["--configs", str(REPO / config), "--data_root",
                    str(REPO / "data_snapshots"), "--epochs", "1",
                    "--device", "cpu", "--precision", "bf16", *flags])
    assert part in str(err.value)


@pytest.mark.parametrize("config,flags,slice_", [
    ("configs/molpcba/gin/baseline+batch=256.yml", [], "slice 11"),
    ("configs/NCI1/gnn-transformer/no-virtual/"
     "gin+gdp=0.1+tdp=0.1+l=4+cosine.yml", ["--runs", "1"], "slice 11"),
    ("configs/code2/pna/base.yml", [], "slice 11"),
    ("configs/molpcba/gnn-transformer/JK=cat/pooling=cls+gin+norm_input.yml",
     [], None),
])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_check_ported_names_the_models_slice_first(config, flags, slice_,
                                                   precision):
    """A model the port lacks in f32 too (model_type gnn, GIN on TU graphs,
    PNA) names its own slice, 11, in either precision, not bf16's; the
    molpcba GraphTrans yml passes in both."""
    from graphtrans_tpu_torch.utils.config import (check_ported,
                                                   parse_with_config)

    args = parse_with_config(tmain.build_parser(), [
        "--configs", str(REPO / config), "--precision", precision, *flags])
    if slice_ is None:
        check_ported(args)
        return
    with pytest.raises(NotImplementedError, match=slice_):
        check_ported(args)


def test_bf16_refuses_the_blocked_route_and_other_kernels():
    """In process, where no flag checks: the GCN layer on the blocked
    route (K8, under ``set_block_spmm``) and on the strided layout (NCI1's
    K6), slice 10's part 4, and K10's layer route, its part 3c, raise
    NotImplementedError naming slice 10 on bf16 inputs; the attention
    routes of K9 and ``chunked`` run in bf16 since its part 3b (code2's
    flat GCN, K7, and K3 since its part 2, K4 and K5 since its part 3a)."""
    import types

    from graphtrans_tpu_torch.nn.conv import GCNConv
    from graphtrans_tpu_torch.nn.encoders import (LinearEdgeEncoder,
                                                  ZeroEdgeEncoder)
    from graphtrans_tpu_torch.ops.block_plan import set_block_spmm

    conv = GCNConv(8, LinearEdgeEncoder(8)).to(BF)
    set_block_spmm(conv, "on")
    flat = types.SimpleNamespace(
        node_mask=torch.ones(4, dtype=torch.bool), node_stride=0,
        edge_src=torch.zeros(2, dtype=torch.int32),
        edge_mask=torch.ones(2, dtype=torch.bool), bsp_fwd=object())
    with pytest.raises(NotImplementedError, match=r"slice 10 \(part 4\)"):
        conv(flat, torch.zeros(4, 8, dtype=BF))
    strided = types.SimpleNamespace(node_mask=torch.ones(4, dtype=torch.bool),
                                    node_stride=4)
    with pytest.raises(NotImplementedError, match=r"slice 10 \(part 4\)"):
        GCNConv(8, ZeroEdgeEncoder(8)).to(BF)(strided,
                                              torch.zeros(4, 8, dtype=BF))
    attn = ttr.MultiheadSelfAttention(128, 2).to(BF)
    valid = torch.ones(1, 8, dtype=torch.bool)
    for route in ("k9", "chunked"):
        y = attn(torch.randn(1, 8, 128).to(BF), route, valid=valid)
        assert y.dtype == BF and torch.isfinite(y.float()).all()
    layer = ttr.TransformerEncoderLayer(128, 4, 256).to(BF)
    with pytest.raises(NotImplementedError, match=r"slice 10 \(part 3c\)"):
        layer(torch.zeros(1, 8, 128, dtype=BF), "k10")


@pytest.mark.parametrize("source,entry", [
    ("gin_agg.cu", "gin_agg_fwd"), ("gin_agg.cu", "gin_agg_bwd"),
    ("attention_packed.cu", "attention_seg_fwd"),
    ("attention_packed.cu", "attention_seg_bwd"),
    ("flash_hil.cu", "flash_hil_fwd"), ("flash_hil.cu", "flash_hil_bwd"),
    ("spmm.cu", "spmm_fwd"), ("spmm.cu", "spmm_bwd"),
    ("attention_packed.cu", "attention_dense_fwd"),
    ("flash_attention.cu", "flash_attention_fwd"),
    ("flash_attention.cu", "flash_attention_bwd"),
    ("attention_smalls.cu", "attention_smalls_fwd"),
    ("attention_smalls.cu", "attention_smalls_bwd")])
def test_bf16_entries_take_the_f32_entries_parameters(source, entry):
    """Each bf16 C entry has the f32 entry's parameters, one for one (the
    wrappers give it the f32 entry's argtypes), its float tensors bf16."""
    import re

    text = (REPO / "graphtrans_tpu_torch" / "csrc" / source).read_text()

    def params(name):
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text,
                        re.S)
        return [p.split()[-1].strip("*") for p in sig.group(1).split(",")]

    assert params(entry + "_bf16") == params(entry)
