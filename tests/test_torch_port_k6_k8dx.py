"""K6's forward walk and K8-dx's walk on the CPU: K6's forward as its
kernel walks each graph's valid slots sorted by (dst, slot), with and
without edge embeddings (``tests/_port_walks.py``), against the port's
plain version (bit for bit) and ``ops/pallas/dense_agg.py:
fused_dense_agg`` in interpret mode (zeros where the port takes None); the
emb-less plain versions against the zero-emb ones; K6's launch geometry;
K8-dx as its kernel walks the src-major plan's ``SlotOrder``, reading the
dst-major emb copy and weight through ``fwd_slot``, against the
src-major copies, the plain version and the VJP of ``ops/pallas/
block_spmm.py:blocked_gather_message_scatter`` in interpret mode; NCI1's
GCN layer and train step, which make no zero edge tensor, and code2's
blocked train step, which makes no src-major copy, against the JAX
package. The CUDA kernels are held to the same walks' bits on the card in
test_torch_port_cuda.py."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.models import MODELS  # noqa: E402
from graphtrans_tpu.nn.encoders import (  # noqa: E402
    LinearNodeEncoder as JLinearNode, ZeroEdgeEncoder as JZeroEdge)
from graphtrans_tpu.ops.pallas import block_spmm as jk8  # noqa: E402
from graphtrans_tpu.ops.pallas import dense_agg as jda  # noqa: E402
from graphtrans_tpu.train import losses as jlosses  # noqa: E402
from graphtrans_tpu.train.state import TrainState  # noqa: E402
from graphtrans_tpu.trainers.base_trainer import BaseTrainer  # noqa: E402
from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.nn.dropout import Generators  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import ZeroEdgeEncoder  # noqa: E402
from graphtrans_tpu_torch.ops import block_plan as tbp  # noqa: E402
from graphtrans_tpu_torch.ops import dense_mp  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    SlotOrder, blocked_gather_message_scatter,
    blocked_gather_message_scatter_dx, blocked_gather_message_scatter_dx_plain,
    dense_agg, dense_agg_bwd, dense_agg_bwd_plain, dense_agg_plain,
    src_slot_order)
from graphtrans_tpu_torch.train.losses import (  # noqa: E402
    classification_loss, seq_token_loss)
from graphtrans_tpu_torch.utils.flax_weights import (  # noqa: E402
    load_flax_variables)
from test_torch_port_blocked import _blocked_model, model_case  # noqa: E402,F401
from test_torch_port_k8_k6bwd import _bsp_batch, _k6_inputs  # noqa: E402
from test_torch_port_model import _random_stats  # noqa: E402
from test_torch_port_nci1 import (  # noqa: E402
    _collate_kw, _hp, _make, _tu_graphs)
from _heap import release_freed_heap  # noqa: E402,F401
from _port_walks import k6_bwd_walk, k6_fwd_walk, k8_dx_walk  # noqa: E402

FWD_TOL = 1e-5    # of max(1, max|ref|): f32 sums in another order
TOL = 1e-4        # logits and loss: f32 BN/LN chains
GRAD_TOL = 5e-4   # gradients, of max(1, max|ref|)
k6 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.dense_agg")
CAPS = (7, 768, 2048)      # graph slots, node cap (6 blocks), edge cap


def _pad16(a):
    pad = (-a.shape[0]) % jda.GT
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---- K6's forward -----------------------------------------------------------


@pytest.mark.parametrize("G", [32, 37])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("with_emb", [True, False])
def test_k6_fwd_walk_matches_plain_and_jax_kernel(G, relu, with_w,
                                                  with_emb):
    """K6's forward as its kernel walks each graph's valid slots sorted by
    (dst, slot), emulated, with the embeddings and without (the emb-less
    instance): every row written once, rows no valid edge reaches exactly
    0, the plain version's bits (the same terms in slot order, each weight
    product rounded before its add), and within 1e-5 of the interpret-mode
    Pallas kernel (with zeros where the port takes None; G 37 padded to 48
    graphs on the JAX side, as ``ops/dense_mp.py`` pads it)."""
    x, src, dst, emask, emb, w, _ = _k6_inputs(G, seed=11)
    w = w if with_w else None
    emb = emb if with_emb else None
    got, writes = k6_fwd_walk(x, src, dst, emask, emb, w, relu)
    assert (writes == 1).all()
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, src, dst, emask, emb, w)]
    np.testing.assert_array_equal(got, dense_agg_plain(*t, relu).numpy())
    jemb = np.zeros(x.shape[:1] + src.shape[1:] + x.shape[2:], np.float32) \
        if emb is None else emb
    jin = [None if a is None else jnp.asarray(_pad16(a))
           for a in (x, src, dst, emask, jemb, w)]
    want = np.asarray(jda.fused_dense_agg(*jin, relu, True))[:G]
    _close(got, want, FWD_TOL)
    reached = np.zeros(x.shape[:2], bool)
    for g in range(G):
        reached[g, dst[g][emask[g]]] = True
    assert not got[~reached].any()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_w", [False, True])
def test_k6_emb_less_plain_versions_match_zero_emb_and_jax(relu, with_w):
    """emb None is the function of zero embeddings: the plain forward and
    the plain backward's dx and dw give the zero-emb call's bits, and the
    backward gives no demb; both within 1e-5 of the interpret-mode Pallas
    kernel's VJP with zeros; K6-bwd's emb-less walk gives the zero-emb
    walk's bits; the CPU wrappers take the plain versions and count no
    launch."""
    x, src, dst, emask, _, w, gout = _k6_inputs(21, seed=4)
    w = w if with_w else None
    zeros = np.zeros(src.shape + x.shape[2:], np.float32)
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, src, dst, emask, w, gout, zeros)]
    before = (dense_agg.launches, dense_agg_bwd.launches)
    none = dense_agg(*t[:4], None, t[4], relu)
    np.testing.assert_array_equal(
        none.numpy(), dense_agg_plain(*t[:4], t[6], t[4], relu).numpy())
    got = dense_agg_bwd(*t[:4], None, t[4], t[5], relu)
    want = dense_agg_bwd_plain(*t[:4], t[6], t[4], t[5], relu)
    assert got[1] is None and (got[2] is None) == (not with_w)
    assert before == (dense_agg.launches, dense_agg_bwd.launches)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    if with_w:
        np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    walk = [k6_bwd_walk(x, src, dst, emask, e, w, gout, relu)[0]
            for e in (None, zeros)]
    np.testing.assert_array_equal(walk[0], walk[1])
    jin = [None if a is None else jnp.asarray(_pad16(a))
           for a in (x, src, dst, emask, zeros, w, gout)]
    _close(none.numpy(), np.asarray(jda.fused_dense_agg(
        *jin[:6], relu, True))[:21], FWD_TOL)
    argnums = (0, 1) if with_w else (0,)
    jg = jax.grad(lambda a, ww=jin[5]: jnp.sum(jda.fused_dense_agg(
        a, *jin[1:5], ww, relu, True) * jin[6]), argnums=argnums)(
            jin[0], *([jin[5]] if with_w else []))
    _close(got[0].numpy(), np.asarray(jg[0])[:21], FWD_TOL, "dx")
    if with_w:
        _close(got[2].numpy(), np.asarray(jg[1])[:21], FWD_TOL, "dw")


def test_k6_fwd_geometry():
    """A warp a graph: at the 4096-graph batch 8 graphs a block and one
    slice of 128 channels, four floats a lane (K7's vector rule); below
    FWD_SPLIT_PER_SM graphs an SM (NCI1's batch of 128), slices of 32
    channels, a float a lane, and a block a graph where the graphs are
    about the SMs' count; the threshold an argument; fewer warps where the
    edge lists pass the shared memory; a stride or slot count past the
    sort key refused."""
    geo = k6.fwd_geometry(4097, 48, 160, 128)
    assert geo.args() == (4, 1, 1, 8, k6.warp_smem(160, 8))
    split = k6.fwd_geometry(129, 48, 160, 128)
    assert (split.vec, split.vpl, split.slices, split.warps) == (1, 1, 4, 1)
    edge = k6.FWD_SPLIT_PER_SM * 132
    assert k6.fwd_geometry(edge - 1, 48, 160, 128).vec == 1
    assert k6.fwd_geometry(edge, 48, 160, 128).vec == 4
    assert k6.fwd_geometry(129, 48, 160, 128, split_per_sm=0).vec == 4
    assert k6.fwd_geometry(129, 48, 160, 300).slices == 10
    assert k6.fwd_geometry(4097, 48, 160, 600).slices == 2
    assert k6.fwd_geometry(4097, 48, 160, 128, align=1).args()[:3] == (
        1, 4, 1)
    assert k6.fwd_geometry(4097, 48, 4000, 128).warps == 3
    for Sm, Em in ((32768, 160), (48, 65537), (48, 20000)):
        with pytest.raises(ValueError):
            k6.fwd_geometry(4097, Sm, Em, 128)


# ---- K8-dx ------------------------------------------------------------------


def _dx_case(seed=0, d=32):
    """A bsp batch (as tensors), x, g, one random embedding row per edge in
    each plan's chunk order (0 on pad slots) and the GCN-style weight in
    each order."""
    b = _bsp_batch(seed + 5)
    rng = np.random.default_rng(seed)
    N, E = CAPS[1], CAPS[2]
    x = rng.standard_normal((N, d)).astype(np.float32)
    g = rng.standard_normal((N, d)).astype(np.float32)
    per_edge = rng.standard_normal((E, d)).astype(np.float32)
    vals = rng.uniform(0.2, 1.0, N).astype(np.float32)
    C = b.bsp_fwd["blk_out"].shape[0]
    embs, ws = [], []
    for major in ("dst", "src"):
        perm = tbp.build_block_plan(b.edge_src, b.edge_dst, b.edge_mask, N,
                                    C, major)["perm"]
        embs.append(tbp.permute_edge_data(per_edge, perm))
        ws.append(tbp.permute_edge_data(vals[b.edge_src] * vals[b.edge_dst],
                                        perm))
    return b.to("cpu"), x, g, embs, ws


def test_src_slot_order_names_the_dst_major_slots():
    """``src_slot_order(batch)``, kept on the batch: the src-major plan's
    real slots grouped by source row in slot order, each position naming
    the dst-major slot of its edge (``fwd_slot``), so the dst-major emb
    copy read there equals the src-major copy at the position's own slot;
    the same rows as the unmapped order of the same plan."""
    b, _, _, (ef, eb), (wf, wb) = _dx_case()
    order = src_slot_order(b)
    assert src_slot_order(b) is order and order.plan is b.bsp_bwd
    assert order.slot_map is b.bsp_bwd["fwd_slot"]
    own = SlotOrder(b.bsp_bwd, CAPS[1], CAPS[2])
    slot, minor, major, ptr = order.get()
    oslot, ominor, omajor, optr = own.get()
    for a, o in ((minor, ominor), (major, omajor), (ptr, optr)):
        assert torch.equal(a, o)
    R = int(ptr[CAPS[1]])
    assert R == int((b.bsp_bwd["mask"] > 0).sum())
    s, o = slot[:R].long().numpy(), oslot[:R].long().numpy()
    assert (s >= 0).all()
    np.testing.assert_array_equal(ef[s], eb[o])
    np.testing.assert_array_equal(wf[s], wb[o])
    dst_rows, src_rows = (r.numpy() for r in tbp.slot_rows(b.bsp_fwd))
    np.testing.assert_array_equal(src_rows[s], major[:R].numpy())
    np.testing.assert_array_equal(dst_rows[s], minor[:R].numpy())


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [True, False])
def test_k8_dx_walk_matches_plain_and_jax_kernel(message, weighted):
    """K8-dx as its kernel walks the src-major plan's SlotOrder, emulated:
    reading the dst-major emb copy and weight through ``fwd_slot`` gives
    the bits of reading the src-major copies at each slot (the parent
    kernel's inputs); every row written once; the plain version's bits,
    and the wrapper's CPU route through the mapped order the same; within
    1e-5 of the VJP of the interpret-mode Pallas kernel."""
    b, x, g, (ef, eb), (wf, wb) = _dx_case(seed=2 + weighted)
    relu = message == "relu_add"
    if not weighted:
        wf = wb = None
    mapped = src_slot_order(b)
    got, writes = k8_dx_walk(x, g, ef, wf, relu, mapped)
    assert (writes == 1).all()
    own, _ = k8_dx_walk(x, g, eb, wb, relu,
                        SlotOrder(b.bsp_bwd, CAPS[1], CAPS[2]))
    np.testing.assert_array_equal(got, own)
    tx, tg, tef, teb = (torch.from_numpy(a) for a in (x, g, ef, eb))
    twf, twb = (None if a is None else torch.from_numpy(a) for a in (wf, wb))
    plain = blocked_gather_message_scatter_dx_plain(tx, tg, teb, b.bsp_bwd,
                                                    twb, message)
    np.testing.assert_array_equal(got, plain.numpy())
    before = blocked_gather_message_scatter_dx.launches
    via = blocked_gather_message_scatter_dx(tx, tg, tef, b.bsp_bwd, twf,
                                            message, rows=mapped)
    assert blocked_gather_message_scatter_dx.launches == before
    np.testing.assert_array_equal(via.numpy(), plain.numpy())
    jp, jq = ({k: jnp.asarray(v.numpy()) for k, v in p.items()
               if k != "fwd_slot"} for p in (b.bsp_fwd, b.bsp_bwd))
    jw = [None if a is None else jnp.asarray(a) for a in (wf, wb)]
    _, vjp = jax.vjp(lambda a: jk8.blocked_gather_message_scatter(
        a, jnp.asarray(ef), jnp.asarray(eb), jp, jq, *jw, message=message,
        interpret=True), jnp.asarray(x))
    _close(got, np.asarray(vjp(jnp.asarray(g))[0]), FWD_TOL)


def test_blocked_wrapper_takes_fwd_slot_for_a_gradient():
    """With a gradient, the K8 wrapper takes the src-major plan without its
    emb copy and weight where the plan has ``fwd_slot`` (the gradient of x
    the same as with the copies), raises without either, and refuses a
    ``rows_bwd`` that names the other slots than the call reads."""
    b, x, g, (ef, eb), (wf, wb) = _dx_case(seed=6)
    tef, teb, twf, twb, tg = (torch.from_numpy(a)
                              for a in (ef, eb, wf, wb, g))
    grads = []
    for copies in (True, False):
        tx = torch.from_numpy(x).requires_grad_()
        out = blocked_gather_message_scatter(
            tx, tef, teb if copies else None, b.bsp_fwd, b.bsp_bwd, twf,
            twb if copies else None,
            rows_bwd=None if copies else src_slot_order(b))
        out.backward(tg)
        grads.append(tx.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    bare = {k: v for k, v in b.bsp_bwd.items() if k != "fwd_slot"}
    tx = torch.from_numpy(x).requires_grad_()
    with pytest.raises(ValueError, match="fwd_slot"):
        blocked_gather_message_scatter(tx, tef, None, b.bsp_fwd, bare, twf)
    with pytest.raises(ValueError, match="rows_bwd"):
        blocked_gather_message_scatter(
            tx, tef, None, b.bsp_fwd, b.bsp_bwd, twf,
            rows_bwd=SlotOrder(b.bsp_bwd, CAPS[1]))   # own slots, no map


# ---- NCI1's GCN and code2's blocked step against the JAX package ----------


@pytest.fixture(scope="module")
def nci1():
    """11 synthetic TU graphs (one padding slot) in the strided layout; a
    narrow NCI1 GraphTrans (emb 32, 2 GCN layers, 1 encoder layer), the
    JAX model with noisy variables and random BN statistics, and the port
    with the same weights."""
    emb, d_model, layers, enc_layers = 32, 32, 2, 1
    graphs = _tu_graphs(11, seed=13)
    caps = (12, 12 * 48, 2048)
    jbatch = jb.collate(graphs, *caps, **_collate_kw())
    batch = tb.collate(graphs, *caps, **_collate_kw()).to("cpu")
    hp = _hp(emb, d_model, layers, enc_layers)
    jmodel = MODELS["gnn-transformer"].build(2, hp, JLinearNode(emb),
                                             JZeroEdge)
    v = jmodel.init({"params": jax.random.key(0),
                     "dropout": jax.random.key(1)}, jbatch, None, False)
    rng = np.random.default_rng(8)
    noise = lambda a: (np.asarray(a) * rng.normal(1.0, 0.1, a.shape)
                       + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(noise, jax.device_get(v["params"]))
    stats = _random_stats(jax.device_get(v["batch_stats"]), rng)
    make = lambda: _make(emb, d_model, layers, enc_layers)
    return dict(jmodel=jmodel, jbatch=jbatch, batch=batch, hp=hp,
                params=params, stats=stats, make=make, emb=emb)


def _record_k6(monkeypatch, model):
    """The emb argument of every K6 call of the strided GCN, and a count of
    the zero encoders' calls."""
    seen = {"emb": [], "zero_encoder": 0}

    def k6_call(*args, **kw):
        seen["emb"].append(args[4])
        return dense_agg(*args, **kw)

    def count(*_):
        seen["zero_encoder"] += 1

    monkeypatch.setattr(dense_mp, "dense_agg", k6_call)
    for m in model.modules():
        if isinstance(m, ZeroEdgeEncoder):
            m.register_forward_hook(count)
    return seen


def test_nci1_gcn_layer_and_logits_take_no_zero_edge_tensor(nci1,
                                                            monkeypatch):
    """NCI1's strided GCN layer passes K6 None for its zero edge
    embeddings (the zero encoder is never called): one layer's output and
    the gradients of a random projection of it (input rows, lin, root_emb)
    within 1e-4 and 5e-4 of max(1, max|ref|) of the JAX layer's, and the
    whole forward's logits within 1e-4."""
    c, b = nci1, nci1["batch"]
    tmodel = load_flax_variables(c["make"](), c["params"], c["stats"]).eval()
    seen = _record_k6(monkeypatch, tmodel)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((b.num_node_slots, c["emb"])).astype(np.float32)
    h[~b.node_mask.numpy()] = 0
    g = rng.standard_normal(h.shape).astype(np.float32)
    variables = {"params": c["params"], "batch_stats": c["stats"]}
    conv = lambda m, bb, hh: m.gnn_node.convs[1](bb, hh, False)

    def proj(params, hh):
        out = c["jmodel"].apply(dict(variables, params=params), c["jbatch"],
                                hh, method=conv)
        return jnp.sum(out * g), out

    (_, want), (gp, gh) = jax.value_and_grad(proj, argnums=(0, 1),
                                             has_aux=True)(c["params"], h)
    tconv = tmodel.gnn_node.convs[1]
    th = torch.from_numpy(h).requires_grad_()
    out = tconv(b, th)
    _close(out.detach().numpy(), np.asarray(want), TOL)
    (out * torch.from_numpy(g)).sum().backward()
    jc = gp["gnn_node"]["conv_1"]
    for got, ref in ((th.grad, gh), (tconv.lin.weight.grad,
                                     np.asarray(jc["TDense_0"]["kernel"]).T),
                     (tconv.lin.bias.grad, jc["TDense_0"]["bias"]),
                     (tconv.root_emb.grad, jc["root_emb"])):
        _close(got.numpy(), np.asarray(ref), GRAD_TOL)
    want = np.asarray(c["jmodel"].apply(variables, c["jbatch"], None, False))
    with torch.no_grad():
        logits = tmodel(b).numpy()
    gm = b.graph_mask.numpy()
    _close(logits[gm], want[gm], TOL)
    assert len(seen["emb"]) == 1 + 2 and seen["zero_encoder"] == 0
    assert all(e is None for e in seen["emb"])


def test_nci1_train_step_takes_no_zero_edge_tensor(nci1, monkeypatch):
    """One NCI1 train step (dropout off, batch statistics on) with K6 given
    None for the zero embeddings in every layer: the loss within 1e-4 and
    every gradient within 5e-4 of max(1, max|ref|) of
    ``BaseTrainer.make_grad_fn``'s."""
    c = nci1
    grad_fn = jax.jit(BaseTrainer.make_grad_fn(
        c["jmodel"], jlosses.classification_loss, c["hp"]))
    jgrads, _, jloss = jax.device_get(grad_fn(
        TrainState.create(c["params"], c["stats"], None), c["jbatch"],
        jax.random.key(2)))
    twin = load_flax_variables(c["make"](), c["params"], c["stats"]).train()
    seen = _record_k6(monkeypatch, twin)
    b = c["batch"]
    loss = classification_loss(twin(b, Generators.seeded(0, "cpu")), b)
    loss.backward()
    assert len(seen["emb"]) == 2 and seen["zero_encoder"] == 0
    assert all(e is None for e in seen["emb"])
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=0)
    want = {k: v.numpy() for k, v in load_flax_variables(
        c["make"](), jgrads, c["stats"]).state_dict().items()}
    for name, p in twin.named_parameters():
        assert p.grad is not None, name
        _close(p.grad.numpy(), want[name], GRAD_TOL, name)


def test_code2_blocked_step_makes_no_src_major_copy(model_case,
                                                    monkeypatch):
    """code2's train step on the blocked route encodes the dst-major
    plan's attributes alone, once a layer, and hands K8 no src-major emb
    copy or weight (its dx reads them through ``fwd_slot``): the loss
    within 1e-4 and every gradient within 5e-4 of max(1, max|ref|) of the
    JAX model's on the blocked route in interpret mode."""
    from graphtrans_tpu_torch.nn import conv as tconv

    c = model_case
    b = c["batch"]
    model = _blocked_model(c).train()
    encoded, k8_calls = [], []
    for m in model.gnn_node.convs:
        m.edge_encoder.register_forward_hook(
            lambda mod, inp, out: encoded.append(inp[0]))

    def k8_call(*args, **kw):
        k8_calls.append((args[2], args[6], kw.get("rows_bwd")))
        return blocked_gather_message_scatter(*args, **kw)

    monkeypatch.setattr(tconv, "blocked_gather_message_scatter", k8_call)
    loss = seq_token_loss(model(b, Generators.seeded(0, "cpu")), b)
    loss.backward()
    layers = len(model.gnn_node.convs)
    assert [a is b.edge_attr_bsp_fwd for a in encoded] == [True] * layers
    assert [(e, w) for e, w, _ in k8_calls] == [(None, None)] * layers
    assert all(r is src_slot_order(b) for _, _, r in k8_calls)
    np.testing.assert_allclose(loss.item(), c["jloss"], atol=TOL, rtol=0)
    twin = load_flax_variables(c["make"](), c["jgrads"], c["stats"])
    want = {k: v.numpy() for k, v in twin.state_dict().items()}
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name], GRAD_TOL, name)
