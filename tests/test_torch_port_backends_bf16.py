"""The bf16 step under every attention backend of the command line on the
CPU against the JAX package: K9's plain bf16 version at heads of 64
against ``attention_smallS`` in bf16 in interpret mode (forward and
gradients, block 0 and 11, rates 0 and 0.3), K5's plain bf16 segment form
at heads of 32 against ``flash_attention_seg`` in bf16 in interpret mode,
the ``chunked`` route in bf16 against the JAX module's chunked route, and
one bf16 train step of the narrow molpcba Transformer-only model under
each of the six non-auto backends of the command line against
``BaseTrainer.make_grad_fn`` with precision bf16 under the same JAX
backend. The code2 GraphTrans step under ``flash`` is in
test_torch_port_backends_bf16_code2.py; the bf16 CUDA kernels are held
against these plain versions on the card in test_torch_port_cuda.py.

Tolerances are test_torch_port_code2_bf16.py's: outputs within OUT_TOL
(7.8e-3, two bf16 ulps at 1) and gradients within GRAD_TOL (1.6e-2, four)
of max(1, max|ref|) for the kernels' plain versions, STEP_TOL (2e-2 on the
loss and logits, 5e-2 on the gradients) for the step. K9's JAX kernel
rounds in interpret mode where it rounds on the TPU (explicit casts of p
and dS), so its plain version is held to it directly. K5's does not: in
interpret mode its Precision.DEFAULT products are exact float32, where the
TPU's MXU (and the port, following the TPU) rounds p and dS to bf16; its
plain version is held within the same bounds all the same, as K5's key
padding form is in test_torch_port_tf_bf16.py (a rounding of p and dS
moves an output by up to half a bf16 ulp of each term, far inside two
ulps of the largest). The step under a backend whose JAX route on the CPU
rounds elsewhere than the TPU's (``packed_smalls``: the JAX package packs
the rows and takes its XLA route off the TPU; ``flash``: K5 in interpret
mode, exact float32 products) is held within STEP_TOL and, besides, its
distance from the JAX bf16 step within RATIO_XLA (1.5) times that step's
own distance from the JAX f32 step."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.nn import transformer as jtr  # noqa: E402
from graphtrans_tpu.ops.pallas import attention_smallS as jas  # noqa: E402
from graphtrans_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu_torch.nn import dropout as tdrop  # noqa: E402
from graphtrans_tpu_torch.nn import transformer as ttr  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_smalls, attention_smalls_bwd_plain, attention_smalls_plain,
    flash_attention, flash_attention_bwd_plain, flash_attention_plain)
from graphtrans_tpu_torch.train.precision import cast_params  # noqa: E402
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_attn_backend import (  # noqa: E402
    _interpret_keep, _jax_backend)
from test_torch_port_code2_bf16 import (  # noqa: E402
    BF, GRAD_TOL, OUT_TOL, RATIO_XLA, STEP_TOL, _bf, _close, _dist, _f32)
from test_torch_port_tf_bf16 import (  # noqa: E402
    _heads, _mol_case, _to_state, _unheads)
from test_torch_port_transformer_train import _jax_keep  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

D, H = 128, 2      # heads of 64, the published Transformer-only width
RATE, SEED = 0.3, 2**31 - 19


# ---- the kernels' plain bf16 versions --------------------------------------


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("block", [0, 11])
def test_k9_plain_bf16_matches_jax_interpret_kernel(block, rate,
                                                    monkeypatch):
    """K9's forward and dq, dk, dv in bf16 at heads of 64 on rows of 33
    (three graph blocks of 11 with ``block``; 9 rows x 2 heads, two
    programs of 16 pairs) with padding keys and a block (a row) without a
    valid key, against ``attention_smallS`` in bf16 in interpret mode with
    its ``_keep_mask`` on the interpret hash: within OUT_TOL and GRAD_TOL;
    a query without a key gives exact zeros; the wrapper on CPU tensors is
    the plain version, uncounted."""
    monkeypatch.setattr(jas, "_keep_mask", _interpret_keep)
    B, S = 9, 33
    rng = np.random.default_rng(64 + block)
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    dead = slice(block, 2 * block) if block else slice(0, S)
    valid[1, dead] = False
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    q, k, v = (jnp.asarray(_heads(t), jnp.bfloat16)
               for t in np.split(qkv, 3, -1))
    kvm = jnp.asarray(np.repeat(valid, H, 0))
    want, vjp = jax.vjp(lambda q, k, v: jas.attention_smallS(
        q, k, v, kvm, SEED, rate, True, True, block), q, k, v)
    want_d = vjp(jnp.asarray(_heads(g), jnp.bfloat16))
    tv = torch.from_numpy(valid)
    got = attention_smalls_plain(_bf(qkv), tv, H, block, rate, SEED)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, _unheads(want, B), OUT_TOL, "out")
    before = dict(attention_smalls.instances)
    assert torch.equal(attention_smalls(_bf(qkv), tv, H, block, rate, SEED),
                       got)
    assert attention_smalls.instances == before
    dqkv = attention_smalls_bwd_plain(_bf(qkv), tv, H, _bf(g), block, rate,
                                      SEED)
    assert dqkv.dtype == BF
    for name, mine, theirs in zip("qkv", dqkv.split(D, -1), want_d):
        _close(mine, _unheads(theirs, B), GRAD_TOL, "d" + name)
    assert not _f32(got)[1, dead].any() and not _f32(dqkv)[1, dead].any()
    assert not _f32(dqkv)[..., D:][~valid].any()


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_k5_seg_plain_bf16_hd32_matches_jax_interpret_kernel(rate,
                                                             monkeypatch):
    """K5's segment form in bf16 at heads of 32 (GraphTrans's packed rows
    under ``flash``: four heads at d 128) over rows of 384 with graph runs
    of 30-200 tokens, padding at the end and a row without a graph,
    against ``flash_attention_seg`` in bf16 in interpret mode with its
    ``_dropout_keep`` on the interpret hash: within OUT_TOL and GRAD_TOL
    though the interpret kernel rounds neither p nor dS (module note); a
    padding query gives exact zeros."""
    monkeypatch.setattr(jfa, "_dropout_keep", _jax_keep)
    B, S, nh = 3, 384, 4
    rng = np.random.default_rng(32)
    qkv = rng.standard_normal((B, S, 3 * D)).astype(np.float32)
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    seg = np.full((B, S), -1, np.int32)
    seg[0, :30], seg[0, 30:230], seg[0, 230:371] = 0, 1, 2
    seg[1, :150], seg[1, 150:300] = 5, 6
    q, k, v = (jnp.asarray(_heads(t, nh), jnp.bfloat16)
               for t in np.split(qkv, 3, -1))
    segh = jnp.asarray(np.repeat(seg, nh, 0))
    want, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_seg(
        q, k, v, segh, SEED, rate, True, True), q, k, v)
    want_d = vjp(jnp.asarray(_heads(g, nh), jnp.bfloat16))
    ts = torch.from_numpy(seg)
    got = flash_attention_plain(_bf(qkv), ts, ts, nh, rate, SEED)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, _unheads(want, B, nh), OUT_TOL, "out")
    before = dict(flash_attention.instances)
    assert torch.equal(flash_attention(_bf(qkv), ts, ts, nh, rate, SEED), got)
    assert flash_attention.instances == before
    dqkv = flash_attention_bwd_plain(_bf(qkv), ts, ts, nh, _bf(g), rate,
                                     SEED)
    assert dqkv.dtype == BF
    for name, mine, theirs in zip("qkv", dqkv.split(D, -1), want_d):
        _close(mine, _unheads(theirs, B, nh), GRAD_TOL, "d" + name)
    pad = seg < 0
    assert not _f32(got)[pad].any() and not _f32(dqkv)[pad].any()


def _jax_attention(x, valid, block=0, backend="auto"):
    """(output, bf16 params) of the JAX ``MultiheadSelfAttention`` under
    ``backend`` on bf16 parameters and inputs, and the port's module on the
    same parameters."""
    jm = jtr.MultiheadSelfAttention(D, H)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(valid),
                     False, block=block)["params"]
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_ATTN_BACKEND", backend)
        want = jm.apply({"params": params}, jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(valid), False, block=block)
    attn = ttr.MultiheadSelfAttention(D, H).to(BF)
    with torch.no_grad():
        for name, lin in (("in_proj", attn.in_proj),
                          ("out_proj", attn.out_proj)):
            lin.weight.copy_(_bf(np.asarray(
                params[name].astype(jnp.float32)).T))
            lin.bias.copy_(_bf(np.asarray(
                params[name + "_bias"].astype(jnp.float32))))
    return want, attn


def test_chunked_route_bf16_matches_jax_chunked_route():
    """The encoder's ``chunked`` route in bf16 on unpacked rows of 200
    tokens (two of the JAX route's key chunks of 128; a row without a valid
    key): scores from the bf16 q and k summed in float32, the probabilities
    and V in float32, the output rounded once, against the JAX module's
    ``chunked_masked_attention`` on bf16 parameters and inputs, within
    OUT_TOL; and its gradient with respect to the input through the same
    rounding points, against ``jax.vjp`` of the JAX module, within
    GRAD_TOL."""
    B, S = 3, 200
    rng = np.random.default_rng(200)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    valid = rng.random((B, S)) < 0.7
    valid[2] = False
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    want, attn = _jax_attention(x, valid, backend="chunked")
    jm = jtr.MultiheadSelfAttention(D, H)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(valid),
                     False)["params"]
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "_ATTN_BACKEND", "chunked")
        _, vjp = jax.vjp(lambda t: jm.apply(
            {"params": params}, t, jnp.asarray(valid), False),
            jnp.asarray(x, jnp.bfloat16))
        (want_dx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _bf(x).requires_grad_()
    got = attn(xt, "chunked", valid=torch.from_numpy(valid))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    _close(got, want, OUT_TOL, "out")
    got.backward(_bf(g))
    assert xt.grad.dtype == BF
    _close(xt.grad, want_dx, GRAD_TOL, "dx")


# ---- the Transformer-only step under each backend --------------------------


def _jax_flash_interpret(mp):
    """The JAX Transformer-only model's flash route in interpret mode (its
    ``flash_attention`` takes ``interpret`` False from the module)."""
    orig = jfa.flash_attention

    def flash(q, k, v, kvm, seed, rate=0.0, training=False,
              interpret=False):
        return orig(q, k, v, kvm, seed, rate, training, True)

    mp.setattr(jfa, "flash_attention", flash)


# the six non-auto backends of the command line: the port's route on the
# molecules' rows of 33 tokens at d 128, and whether the JAX package's
# route on the CPU rounds where the TPU's does
MOL_BACKENDS = [("smalls", "k9", True), ("packed_smalls", "k9", False),
                ("flash", "k5", False), ("chunked", "chunked", True),
                ("dense", "plain", True), ("packed", "plain", True)]


@pytest.fixture(scope="module")
def mol_case():
    """The molpcba case of test_torch_port_tf_bf16.py (7 molecules, rows of
    33 tokens, d 128, heads of 64, 1 layer) and noised variables."""
    jbatch, batch, hp, jmodel, make, loss, jloss_fn = _mol_case()
    v = jmodel.init({"params": jax.random.key(0)}, jbatch, None, False)
    rng = np.random.default_rng(8)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    return dict(jbatch=jbatch, batch=batch.to("cpu"), hp=hp, jmodel=jmodel,
                make=make, loss=loss, jloss_fn=jloss_fn, params=params,
                state=load_flax_variables(make(), params, {}).state_dict())


def _jax_grads(c, precision):
    """(grads, loss) of the JAX train step with ``precision``."""
    hp = type(c["hp"])(**dict(vars(c["hp"]), precision=precision))
    grad_fn = jax.jit(BaseTrainer.make_grad_fn(c["jmodel"], c["jloss_fn"],
                                               hp))
    grads, _, loss = jax.device_get(grad_fn(
        TrainState.create(c["params"], {}, None), c["jbatch"],
        jax.random.key(2)))
    return grads, loss


@pytest.mark.parametrize("backend,route,same_rounding", MOL_BACKENDS)
def test_transformer_bf16_step_under_backend_matches_jax(
        mol_case, backend, route, same_rounding):
    """One bf16 forward and backward of the narrow molpcba
    Transformer-only model under ``backend`` (set as ``main`` sets it,
    through ``set_attn_backend``, on the model that ``functional_call``
    runs) takes the route of the JAX package's TPU branch, and its loss and
    every gradient are within STEP_TOL of ``make_grad_fn(precision="bf16")``
    under the same JAX backend (K9 in interpret mode under ``smalls``, K5
    under ``flash``); where the JAX route rounds elsewhere (module note) the
    port's distance is also within RATIO_XLA of the JAX bf16 step's from its
    f32 step."""
    c = mol_case
    with pytest.MonkeyPatch.context() as mp:
        calls = _jax_backend(mp, backend)
        mp.setattr(jtr, "_PFUSED_INTERPRET", False)
        _jax_flash_interpret(mp)
        bgrads, bloss = _jax_grads(c, "bf16")
        fgrads, floss = (None, None) if same_rounding else _jax_grads(c,
                                                                     "f32")
    assert calls == (["k9"] if backend == "smalls" else [])
    model = c["make"]()
    model.load_state_dict(c["state"])
    ttr.set_attn_backend(model, backend)
    model.train()
    routes = []
    orig = ttr.attention_route
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttr, "attention_route", lambda *a, **k: routes.append(
            orig(*a, **k)) or routes[-1])
        logits = torch.func.functional_call(
            model, cast_params(model, BF),
            (c["batch"], tdrop.Generators.seeded(0, "cpu")))
    loss = c["loss"](logits, c["batch"])
    loss.backward()
    assert routes == [route] and logits.dtype == BF
    fwd_tol, grad_tol = STEP_TOL
    _close(loss, bloss, fwd_tol, "loss")
    bf = _to_state(c["make"], bgrads)
    port_d, jax_d = [_dist(loss, bloss)], []
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _close(p.grad, bf[name], grad_tol, name)
        port_d.append(_dist(p.grad, bf[name]))
    if not same_rounding:
        f32 = _to_state(c["make"], fgrads)
        jax_d = [_dist(bloss, floss)] + [_dist(bf[n], f32[n]) for n in bf]
        ratio = max(port_d) / max(jax_d)
        assert ratio <= RATIO_XLA, (
            f"the port's bf16 step is {max(port_d):.3e} from the JAX "
            f"package's bf16 step, which is {max(jax_d):.3e} from its f32 "
            f"step: ratio {ratio:.3f}")
