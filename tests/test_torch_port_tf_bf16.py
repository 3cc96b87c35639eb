"""The Transformer-only model's bf16 step (``--precision bf16`` under
``--attn_backend auto``) on the CPU against the JAX package: K4's and K5's
plain bf16 versions at heads of 64 against the Pallas kernels in bf16 in
interpret mode (forward and gradients, rates 0 and 0.3), the plain route
in bf16 against the JAX module's dense branch, one bf16 train step of the
molpcba and code2 Transformer-only models against
``BaseTrainer.make_grad_fn`` with precision bf16, the dtypes of its
activations, which configs ``check_ported`` lets through in bf16, and
``main --precision bf16`` on both ymls. The bf16 CUDA kernels are held
against these plain versions on the card in test_torch_port_cuda.py.

Tolerances are test_torch_port_code2_bf16.py's: outputs within 7.8e-3 and
gradients within 1.6e-2 of max(1, max|ref|) for the kernels' plain
versions, 2e-2 (loss, logits) and 5e-2 (gradients) for the step. K4's
JAX kernel rounds in interpret mode where it rounds on the TPU (explicit
casts of p and dS), so its plain version is held to it directly. K5's
does not: in interpret mode its Precision.DEFAULT products are exact
float32, where the TPU's MXU (and the port, following the TPU) rounds p
and dS to bf16 (ROADMAP.md section 3, "K3's rounding in bf16", which K5
shares); on code2's rows of 601 the JAX step on the CPU takes its XLA
route (``chunked``), which rounds elsewhere again. There the port's
distance from the JAX bf16 step is bounded by RATIO_XLA times the JAX
package's own bf16-to-f32 distance, as in the code2 GraphTrans step
test."""

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
from graphtrans_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import (  # noqa: E402
    BaseTrainer, make_param_cast)
from graphtrans_tpu_torch import main as tmain  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.models.transformer import (  # noqa: E402
    TransformerModule)
from graphtrans_tpu_torch.nn import dropout as tdrop  # noqa: E402
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import (  # noqa: E402
    ASTNodeEncoder, AtomEncoder)
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_dense, attention_dense_bwd_plain, attention_dense_plain,
    flash_attention, flash_attention_bwd_plain, flash_attention_plain,
    key_padding_segs)
from graphtrans_tpu_torch.train.losses import (  # noqa: E402
    binary_multitask_loss, seq_token_loss)
from graphtrans_tpu_torch.train.precision import cast_params  # noqa: E402
from graphtrans_tpu_torch.utils.config import (  # noqa: E402
    check_ported, parse_with_config)
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_code2 import _tier_graphs  # noqa: E402
from test_torch_port_code2_bf16 import (  # noqa: E402
    BF, GRAD_TOL, OUT_TOL, RATIO_XLA, STEP_TOL, _bf, _close, _dist, _f32)
from test_torch_port_transformer_train import (  # noqa: E402
    _hp, _jax_keep, _jax_route)
from _heap import release_freed_heap  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]
MOL_CONFIG = "configs/molpcba/transformer/pooling=cls.yml"
CODE2_CONFIG = "configs/code2/transformer/pooling=cls.yml"
TF_YMLS = [(MOL_CONFIG, []), (CODE2_CONFIG, []),
           ("configs/NCI1/transformer/pooling=cls.yml", ["--runs", "1"]),
           ("configs/NCI109/transformer/pooling=cls.yml", ["--runs", "1"])]
SNAPSHOT = str(REPO / "data_snapshots")
D, H = 128, 2      # heads of 64, the published configs' width
RATE, SEED = 0.3, 2**31 - 9
TYPES, ATTRS, SEQ = 20, 100, 5


def _heads(t, nhead=H):
    """[B, S, d] -> [B*H, S, hd] (the JAX flash kernel's layout)."""
    B, S, d = t.shape
    return np.asarray(t).reshape(B, S, nhead, d // nhead).transpose(
        0, 2, 1, 3).reshape(B * nhead, S, d // nhead)


def _unheads(o, B, nhead=H):
    o = _f32(o)
    S, hd = o.shape[1], o.shape[2]
    return o.reshape(B, nhead, S, hd).transpose(0, 2, 1, 3).reshape(
        B, S, nhead * hd)


# ---- the kernels' plain bf16 versions --------------------------------------


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("B,S,block", [(7, 99, 33), (3, 257, 0)])
def test_k4_plain_bf16_matches_jax_interpret_kernel(B, S, block, rate):
    """K4's forward and dqkv in bf16 at heads of 64, on packed rows of three
    graph blocks (the tile instance on the card) and on unpacked rows of
    257 (the long one), with padding keys and a block (a row) without a
    valid key, against ``attention_packed_qkv`` in bf16 in interpret mode
    with and without dropout (the same counter-hash mask); a block without
    a key gives exact zeros; the wrapper on CPU tensors is the plain
    version, uncounted."""
    rng = np.random.default_rng(S + block)
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    dead = slice(block, 2 * block) if block else slice(0, S)
    valid[1, dead] = False
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jap.attention_packed_qkv(
        t, jnp.asarray(valid), SEED, H, rate, True, True, block),
        jnp.asarray(qkv, jnp.bfloat16))
    (want_d,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tv = torch.from_numpy(valid)
    got = attention_dense_plain(_bf(qkv), tv, H, block, rate, SEED)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want, OUT_TOL, "out")
    before = dict(attention_dense.instances)
    assert torch.equal(attention_dense(_bf(qkv), tv, H, block, rate, SEED),
                       got)
    assert attention_dense.instances == before
    dqkv = attention_dense_bwd_plain(_bf(qkv), tv, H, _bf(g), block, rate,
                                     SEED)
    assert dqkv.dtype == BF
    _close(dqkv, want_d, GRAD_TOL, "dqkv")
    assert not _f32(got)[1, dead].any() and not _f32(dqkv)[1, dead].any()
    assert not _f32(dqkv)[..., D:][~valid].any()


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_k5_plain_bf16_matches_jax_interpret_kernel(rate, monkeypatch):
    """K5's forward and dq, dk, dv in bf16 at heads of 64 over a row of 520
    tokens with padding keys (a graph's nodes and its CLS column) and a row
    without a valid key, against ``flash_attention`` in bf16 in interpret
    mode with its ``_dropout_keep`` drawn from the interpret-mode hash:
    within OUT_TOL and GRAD_TOL though the interpret kernel rounds neither
    p nor dS (module note); a query without a key gives exact zeros."""
    monkeypatch.setattr(jfa, "_dropout_keep", _jax_keep)
    B, S = 2, 520
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    valid = np.zeros((B, S), bool)
    valid[0, :300], valid[0, -1] = True, True
    q, k, v = (jnp.asarray(_heads(t), jnp.bfloat16)
               for t in np.split(qkv, 3, -1))
    want, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, jnp.asarray(np.repeat(valid, H, 0)), SEED, rate, True,
        True), q, k, v)
    want_d = vjp(jnp.asarray(_heads(g), jnp.bfloat16))
    segs = key_padding_segs(torch.from_numpy(valid))
    got = flash_attention_plain(_bf(qkv), *segs, H, rate, SEED)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, _unheads(want, B), OUT_TOL, "out")
    before = dict(flash_attention.instances)
    assert torch.equal(flash_attention(_bf(qkv), *segs, H, rate, SEED), got)
    assert flash_attention.instances == before
    dqkv = flash_attention_bwd_plain(_bf(qkv), *segs, H, _bf(g), rate, SEED)
    assert dqkv.dtype == BF
    for name, mine, theirs in zip("qkv", dqkv.split(D, -1), want_d):
        _close(mine, _unheads(theirs, B), GRAD_TOL, "d" + name)
    assert not _f32(got)[1].any() and not _f32(dqkv)[1].any()


@pytest.mark.parametrize("S,block", [(99, 33), (200, 0)])
def test_plain_route_bf16_matches_jax_dense_branch(S, block):
    """The encoder's plain route in bf16 on unpacked rows (``_plain``:
    float32 scores and softmax, the probabilities rounded to bf16, the
    product with V in bf16) against the JAX ``MultiheadSelfAttention``'s
    dense branch on its CPU route, both on bf16 parameters and inputs,
    graph-packed rows and a row at block 0."""
    B = 4
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    jm = jtr.MultiheadSelfAttention(D, H)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(valid),
                     False, block=block)["params"]
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(valid), False, block=block)
    attn = ttr.MultiheadSelfAttention(D, H).to(BF)
    with torch.no_grad():
        attn.in_proj.weight.copy_(_bf(np.asarray(
            params["in_proj"].astype(jnp.float32)).T))
        attn.in_proj.bias.copy_(_bf(np.asarray(
            params["in_proj_bias"].astype(jnp.float32))))
        attn.out_proj.weight.copy_(_bf(np.asarray(
            params["out_proj"].astype(jnp.float32)).T))
        attn.out_proj.bias.copy_(_bf(np.asarray(
            params["out_proj_bias"].astype(jnp.float32))))
        got = attn(_bf(x), "plain", valid=torch.from_numpy(valid),
                   block=block)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want, OUT_TOL, "out")


# ---- the Transformer-only step ----------------------------------------------


def _mol_case():
    """7 molecules (8 graph slots; rows of 3 graphs of 33 tokens: K4's tile
    instance), 1 layer."""
    graphs = ts.make_mol_dataset(num_graphs=7, num_tasks=6, min_nodes=3,
                                 max_nodes=30, seed=12)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    kw = dict(num_tasks=6, y_dtype="float32", dense_cap=32)
    hp = _hp(D, H, 1)
    jmodel = MODELS["transformer"].build(6, hp, JAtomEncoder(D), None)
    make = lambda: TransformerModule(6, AtomEncoder(D), D, H, 2 * D, 1, 1000,
                                     True)
    return (jb.collate(graphs, 8, 256, 1024, **kw),
            tb.collate(graphs, 8, 256, 1024, **kw), hp, jmodel, make,
            binary_multitask_loss, jlosses.binary_multitask_loss)


def _code2_case():
    """Four ASTs, one of 600 nodes (rows of 601 tokens: K5), 1 layer."""
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


def _jax_step(jmodel, hp, params, jbatch, jloss_fn, precision):
    """(logits f32 (bf16 only, else None), grads, loss) of the JAX train
    step with ``precision`` (dropout 0): logits from the forward on the
    cast params."""
    hp = type(hp)(**dict(vars(hp), precision=precision))
    cast = make_param_cast(hp)
    logits = None
    if precision == "bf16":
        logits = np.asarray(jax.jit(lambda p: jmodel.apply(
            {"params": cast(p)}, jbatch, None, False).astype(jnp.float32))(
                params))
    grad_fn = jax.jit(BaseTrainer.make_grad_fn(jmodel, jloss_fn, hp))
    grads, _, loss = jax.device_get(grad_fn(
        TrainState.create(params, {}, None), jbatch, jax.random.key(2)))
    return logits, grads, loss


@pytest.fixture(scope="module", params=["mol", "code2"])
def step_case(request):
    """One batch, noised variables, and the JAX model's step in bf16 and in
    f32: molpcba through its interpret-mode K4 (the packed_fused route, as
    the TPU's auto takes it), code2 through its CPU route (chunked at rows
    of 601)."""
    kind = request.param
    jbatch, batch, hp, jmodel, make, loss, jloss_fn = (
        _mol_case() if kind == "mol" else _code2_case())
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    rng = np.random.default_rng(8)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    with pytest.MonkeyPatch.context() as mp:
        _jax_route(mp, "k4" if kind == "mol" else "xla")
        steps = {p: _jax_step(jmodel, hp, params, jbatch, jloss_fn, p)
                 for p in ("bf16", "f32")}
    return dict(kind=kind, batch=batch.to("cpu"), make=make, loss=loss,
                params=params, steps=steps,
                state=load_flax_variables(make(), params, {}).state_dict())


def _to_state(make, tree) -> dict:
    twin = load_flax_variables(make(), tree, {})
    return {k: v.numpy() for k, v in twin.state_dict().items()}


def _port_step(c, hooks=()):
    """(model, logits, loss) of the port's bf16 forward and backward in
    training mode (dropout 0) on a bf16 copy of the float32 masters."""
    model = c["make"]()
    model.load_state_dict(c["state"])
    for hook in hooks:
        hook(model)
    model.train()
    logits = torch.func.functional_call(model, cast_params(model, BF),
                                        (c["batch"],
                                         tdrop.Generators.seeded(0, "cpu")))
    loss = c["loss"](logits, c["batch"])
    loss.backward()
    return model, logits, loss


def test_transformer_bf16_step_matches_jax(step_case):
    """Loss, logits and every gradient of one bf16 forward and backward
    within STEP_TOL of the JAX package's bf16 step; and the port's distance
    from it (loss and gradients, the largest over max(1, max|ref|)) within
    RATIO_XLA of the JAX bf16 step's own distance from its f32 step."""
    c = step_case
    fwd_tol, grad_tol = STEP_TOL
    model, logits, loss = _port_step(c)
    jlogits, bgrads, bloss = c["steps"]["bf16"]
    _, fgrads, floss = c["steps"]["f32"]
    assert loss.dtype == torch.float32 and logits.dtype == BF
    _close(loss, bloss, fwd_tol, "loss")
    _close(logits, jlogits, fwd_tol, "logits")
    bf = _to_state(c["make"], bgrads)
    f32 = _to_state(c["make"], fgrads)
    port_d, jax_d = [_dist(loss, bloss)], [_dist(bloss, floss)]
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _close(p.grad, bf[name], grad_tol, name)
        port_d.append(_dist(p.grad, bf[name]))
        jax_d.append(_dist(bf[name], f32[name]))
    ratio = max(port_d) / max(jax_d)
    assert ratio <= RATIO_XLA, (
        f"the port's bf16 step is {max(port_d):.3e} from the JAX package's "
        f"bf16 step, which is {max(jax_d):.3e} from its f32 step: ratio "
        f"{ratio:.3f}")


def test_transformer_bf16_step_dtypes(step_case, monkeypatch):
    """No activation of the step is float32 where the JAX step's is bf16:
    every module's floating output, every nn.Linear input (the node
    encoder's too) and the inputs of K4 (molpcba) or K5 (code2) are bf16;
    the loss and the gradients are float32."""
    c = step_case
    seen = []

    def hooks(model):
        for name, m in model.named_modules():
            m.register_forward_hook(
                lambda mod, inp, out, name=name: seen.append(
                    (name, [t.dtype for t in inp if torch.is_tensor(t)
                            and t.is_floating_point()]
                     if isinstance(mod, torch.nn.Linear) else [],
                     out.dtype if torch.is_tensor(out) else None)))

    for fname in ("attention_dense", "flash_attention"):
        fn = getattr(ttr, fname)
        monkeypatch.setattr(ttr, fname, lambda *a, fn=fn, fname=fname, **k: (
            seen.append((fname, [a[0].dtype], None)) or fn(*a, **k)))
    model, logits, loss = _port_step(c, (hooks,))
    names = {s[0] for s in seen}
    kernel = "attention_dense" if c["kind"] == "mol" else "flash_attention"
    assert {kernel, "transformer.layers.0.self_attn.in_proj",
            "transformer.final_norm", "node_encoder"} <= names
    for name, ins, out in seen:
        assert all(dt == BF for dt in ins), (name, ins)
        assert out in (None, BF, torch.bool, torch.int32, torch.int64), (
            name, out)
    assert loss.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_k4_bf16_bwd_entry_takes_the_f32_entrys_parameters_and_delta():
    """K4-bwd's bf16 C entry has the f32 entry's parameters, one for one,
    with the bf16 pair's delta scratch before dqkv (the wrapper gives it the
    f32 entry's argtypes and one pointer more)."""
    import re

    text = (REPO / "graphtrans_tpu_torch/csrc/attention_packed.cu"
            ).read_text()

    def params(name):
        sig = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text,
                        re.S)
        return [p.split()[-1].strip("*") for p in sig.group(1).split(",")]

    f32 = params("attention_dense_bwd")
    assert params("attention_dense_bwd_bf16") == (
        f32[:f32.index("dqkv")] + ["delta"] + f32[f32.index("dqkv"):])


# ---- the configs and the entry point ----------------------------------------


@pytest.mark.parametrize("config,flags", TF_YMLS)
def test_check_ported_lets_the_transformer_ymls_through_in_bf16(config,
                                                                flags):
    """Each Transformer-only yml (molpcba, code2, NCI1, NCI109) passes
    ``check_ported`` in bf16 under auto, and raises NotImplementedError
    naming slice 10 under every other backend the command line takes."""
    args = parse_with_config(tmain.build_parser(), [
        "--configs", str(REPO / config), "--precision", "bf16", *flags])
    check_ported(args)
    for backend in ("smalls", "packed_smalls", "flash", "chunked"):
        args = parse_with_config(tmain.build_parser(), [
            "--configs", str(REPO / config), "--precision", "bf16",
            "--attn_backend", backend, *flags])
        with pytest.raises(NotImplementedError, match="slice 10"):
            check_ported(args)


def test_bf16_refuses_k9_k10_and_k11_on_the_transformer_model(monkeypatch):
    """In process, where no flag checks: the Transformer-only model in bf16
    under smalls (K9) and packed_layer (K10), with K11 switched on, and K5
    on packed rows (the flash backend's segment form) raise
    NotImplementedError naming slice 10; under auto the model runs."""
    batch, make = _mol_case()[1], _mol_case()[4]
    batch = batch.to("cpu")
    model = make().to(BF).train()
    gen = tdrop.Generators.seeded(0, "cpu")
    for backend in ("smalls", "packed_smalls", "packed_layer"):
        ttr.set_attn_backend(model, backend)
        with pytest.raises(NotImplementedError, match="slice 10"):
            model(batch, gen)
    ttr.set_attn_backend(model, "auto")
    for m in model.modules():
        if isinstance(m, tdrop.ByteDropout):
            m.rate = 0.3
    assert model(batch, gen).dtype == BF
    attn = ttr.MultiheadSelfAttention(D, H).to(BF)
    with pytest.raises(NotImplementedError, match="slice 10"):
        attn(torch.zeros(1, 8, D, dtype=BF), "k5",
             seg=torch.zeros(1, 8, dtype=torch.int32))
    monkeypatch.setattr(tdrop, "MIN_SIZE", 1)
    monkeypatch.setattr(tdrop, "FUSED", True)
    with pytest.raises(NotImplementedError, match="slice 10"):
        model(batch, gen)


@pytest.mark.parametrize("config,narrow", [
    (MOL_CONFIG, ["--d_model", "128", "--nhead", "2",
                  "--num_encoder_layers", "1"]),
    (CODE2_CONFIG, ["--d_model", "128", "--gnn_emb_dim", "128", "--nhead",
                    "2", "--num_encoder_layers", "1", "--batch_size", "64",
                    "--max_input_len", "255"])])
def test_main_trains_the_transformer_ymls_in_bf16(config, narrow, capsys):
    """``main --precision bf16`` trains each Transformer-only yml on the
    snapshot for one epoch at narrow widths (heads of 64; molpcba on K4's
    packed rows, code2 with rows cut to 256 on K4's unpacked rows), with
    the yml's attention dropout: finite, positive losses, the precision on
    the epoch line."""
    res = tmain.main(["--configs", str(REPO / config), "--data_root",
                      SNAPSHOT, "--precision", "bf16", "--epochs", "1",
                      "--seed", "0", "--device", "cpu", *narrow])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1 and res["epochs"] == lines
    r = lines[0]
    assert r["steps"] >= 1 and np.isfinite(r["loss"]) and r["loss"] > 0
    assert r["precision"] == "bf16"
