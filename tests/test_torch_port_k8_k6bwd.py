"""K8's forward walk and K6-bwd's sorted dx walk on the CPU: the SlotOrder
that K8's forward walks (``ops/kernels/block_spmm.py``), the walk emulated
in the kernel's order of terms (``tests/_port_walks.py``) against the
port's plain version (bit for bit) and ``ops/pallas/block_spmm.py:
blocked_gather_message_scatter`` in interpret mode; K6-bwd's walk over the
valid slots sorted by (src, slot) against ``dense_agg_bwd_plain`` and the
VJP of ``ops/pallas/dense_agg.py:fused_dense_agg`` in interpret mode; what
``dense_agg_bwd`` returns for each request and its launch geometry; and
the blocked GCN layer, which encodes the src-major plan's slots only where
a gradient is wanted. The CUDA kernels are held to the same walks' bits on
the card in test_torch_port_cuda.py."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas import block_spmm as jk8  # noqa: E402
from graphtrans_tpu.ops.pallas import dense_agg as jda  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.data import vocab as tv  # noqa: E402
from graphtrans_tpu_torch.nn.conv import GCNConv  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import LinearEdgeEncoder  # noqa: E402
from graphtrans_tpu_torch.ops import block_plan as tbp  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    SlotOrder, blocked_gather_message_scatter,
    blocked_gather_message_scatter_plain, dense_agg_bwd, dense_agg_bwd_plain,
    slot_order)
from _heap import release_freed_heap  # noqa: E402,F401
from _port_walks import k6_bwd_walk, k8_fwd_walk  # noqa: E402

FWD_TOL = 1e-5   # of max(1, max|ref|): f32 sums in another order
k7 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.spmm")
k6 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.dense_agg")
CAPS = (7, 768, 2048)      # graph slots, node cap (6 blocks), edge cap


def _bsp_batch(seed=5):
    """A flat batch of 6 code2-like graphs (20-120 nodes, edges augmented)
    with both block plans."""
    raw = ts.make_code_dataset(num_graphs=6, vocab_size=8, seq_len_max=6,
                               min_nodes=20, max_nodes=120, seed=seed)
    graphs = [dict(tv.augment_edge(g), _id=i) for i, g in enumerate(raw)]
    return tb.collate(graphs, *CAPS, num_tasks=4, y_dtype="float32",
                      bsp_chunks_cap=tbp.chunk_capacity(CAPS[2], CAPS[1]))


def _k8_case(d=32, seed=0):
    """The batch, x, the dst-major plan's emb copy (one random row per
    edge in the plan's chunk order, 0 on pad slots), the GCN-style slot
    weight, and both plans as tensors."""
    b = _bsp_batch(seed + 5)
    rng = np.random.default_rng(seed)
    N = CAPS[1]
    x = rng.standard_normal((N, d)).astype(np.float32)
    per_edge = rng.standard_normal((CAPS[2], d)).astype(np.float32)
    perm = tbp.build_block_plan(b.edge_src, b.edge_dst, b.edge_mask, N,
                                b.bsp_fwd["blk_out"].shape[0], "dst")["perm"]
    vals = rng.uniform(0.2, 1.0, N).astype(np.float32)
    emb = tbp.permute_edge_data(per_edge, perm)
    w = tbp.permute_edge_data(vals[b.edge_src] * vals[b.edge_dst], perm)
    plans = [{k: torch.from_numpy(v) for k, v in p.items()}
             for p in (b.bsp_fwd, b.bsp_bwd)]
    return b, x, emb, w, plans


def _hub_plan(N=640, E=3000, seed=4):
    """A dst-major plan whose hub row (node 3, half the edges) spans
    several chunks of several minor blocks, with masked edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = np.sort(np.concatenate([np.full(E // 2, 3),
                                  rng.integers(0, N, E - E // 2)])
                  ).astype(np.int32)
    mask = rng.random(E) < 0.85
    plan = tbp.build_block_plan(src, dst, mask, N, tbp.chunk_capacity(E, N))
    return {k: torch.from_numpy(v) for k, v in plan.items()}, N, E


@pytest.mark.parametrize("case", ["batch", "hub"])
def test_slot_order_lists_each_real_slot_once_by_row(case):
    """The SlotOrder of a dst-major plan: positions [0, ptr[N]) hold every
    real slot exactly once and no pad slot, row i's at [ptr[i], ptr[i+1])
    in slot order; src and dst are each slot's minor and major rows
    (``slot_rows``); the runs are edge_runs of ptr, every row in one."""
    if case == "batch":
        b, _, _, _, (plan, _) = _k8_case()
        N, E = CAPS[1], CAPS[2]
    else:
        plan, N, E = _hub_plan()
    order = SlotOrder(plan, N, E)
    slot, src, dst, ptr = order.get()
    assert order.get() is order.get()
    assert all(t.dtype == torch.int32 for t in (slot, src, dst, ptr))
    assert slot.shape == src.shape == dst.shape == (plan["mask"].numel(),)
    assert ptr.shape == (N + 1,) and ptr[0] == 0
    real = torch.nonzero(plan["mask"].reshape(-1) > 0)[:, 0]
    R = int(ptr[N])
    assert R == real.numel() <= E
    assert torch.equal(torch.sort(slot[:R].long())[0], real)
    maj, mnr = tbp.slot_rows(plan)
    assert torch.equal(dst[:R].long(), maj[slot[:R].long()])
    assert torch.equal(src[:R].long(), mnr[slot[:R].long()])
    for i in range(N):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        assert (dst[lo:hi] == i).all()
        assert (torch.diff(slot[lo:hi]) > 0).all()       # slot order
    rptr = order.runs()
    assert order.runs() is rptr
    assert torch.equal(rptr, k7.edge_runs(ptr, E))
    assert rptr[0] == 0 and rptr[-1] == N and (torch.diff(rptr) >= 0).all()
    if case == "hub":
        hub = int(torch.searchsorted(rptr, 3, right=True)) - 1
        assert ptr[rptr[hub + 1]] - ptr[rptr[hub]] >= int(ptr[4] - ptr[3])


def test_slot_order_is_made_once_per_batch():
    """``slot_order(batch)`` keeps one SlotOrder on the batch, of its
    dst-major plan, sized by its edge slots; a batch copied again gets its
    own."""
    host = _bsp_batch()
    batch = host.to("cpu")
    order = slot_order(batch)
    assert slot_order(batch) is order and order.plan is batch.bsp_fwd
    assert (order.num_nodes, order.num_edges) == (CAPS[1], CAPS[2])
    assert slot_order(host.to("cpu")) is not order


@pytest.mark.parametrize("message", ["relu_add", "add"])
@pytest.mark.parametrize("weighted", [True, False])
def test_k8_slot_walk_matches_plain_and_jax_kernel(message, weighted):
    """K8's forward as its kernel walks the SlotOrder, emulated: every row
    written once, rows no real slot reaches exactly 0, the plain version's
    bits (the same terms in slot order, products rounded before their
    adds), and within 1e-5 of the interpret-mode Pallas kernel."""
    b, x, emb, w, (pf, pb) = _k8_case(seed=1 + weighted)
    w = w if weighted else None
    N = CAPS[1]
    order = SlotOrder(pf, N, CAPS[2])
    got, writes, walked = k8_fwd_walk(x, emb, w, message == "relu_add",
                                      order)
    assert (writes == 1).all()
    R = int(order.get()[3][N])
    assert walked[:R].all() and not walked[R:].any()   # pad slots never
    te = torch.from_numpy(emb)
    tw = None if w is None else torch.from_numpy(w)
    plain = blocked_gather_message_scatter_plain(
        torch.from_numpy(x), te, None, pf, None, tw, None, message).numpy()
    np.testing.assert_array_equal(got, plain)
    jp = {k: jnp.asarray(v.numpy()) for k, v in pf.items()}
    jq = {k: jnp.asarray(v.numpy()) for k, v in pb.items()}
    want = np.asarray(jk8.blocked_gather_message_scatter(
        jnp.asarray(x), jnp.asarray(emb), jnp.zeros_like(jnp.asarray(emb)),
        jp, jq, None if w is None else jnp.asarray(w),
        None if w is None else jnp.ones_like(jnp.asarray(w)),
        message=message, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_TOL * max(1.0, np.abs(want).max()))
    reached = np.zeros(N, bool)
    reached[tbp.slot_rows(pf)[0][pf["mask"].reshape(-1) > 0].numpy()] = True
    assert not got[~reached].any()


def _k6_inputs(G, Sm=16, Em=40, d=32, seed=0):
    """A strided batch: graphs of 1..Sm nodes, 70 % of the slots valid, a
    padding graph slot last, masked slots' src and dst 0 (as collate pads
    them)."""
    rng = np.random.default_rng(seed + G)
    n = rng.integers(1, Sm + 1, G)
    src = (rng.random((G, Em)) * n[:, None]).astype(np.int32)
    dst = (rng.random((G, Em)) * n[:, None]).astype(np.int32)
    emask = rng.random((G, Em)) < 0.7
    emask[-1] = False
    src[~emask] = dst[~emask] = 0
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
def test_k6_bwd_walk_matches_plain_and_jax_kernel(G, relu, with_w):
    """K6-bwd's dx as its kernel walks each graph's valid slots sorted by
    (src, slot), emulated: every row written once, within 1e-6 of
    ``dense_agg_bwd_plain``'s dx and within 1e-5 of the interpret-mode
    Pallas kernel's VJP (G 37 padded to 48 graphs on the JAX side, as
    ``ops/dense_mp.py`` pads it)."""
    x, src, dst, emask, emb, w, gout = _k6_inputs(G, seed=3)
    w = w if with_w else None
    got, writes = k6_bwd_walk(x, src, dst, emask, emb, w, gout, relu)
    assert (writes == 1).all()
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, src, dst, emask, emb, w, gout)]
    plain = dense_agg_bwd_plain(*t, relu=relu)[0].numpy()
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-6 * max(1.0, np.abs(plain).max()))
    jin = [None if a is None else jnp.asarray(_pad16(a))
           for a in (x, src, dst, emask, emb, w, gout)]
    jdx = jax.grad(lambda a: jnp.sum(jda.fused_dense_agg(
        a, jin[1], jin[2], jin[3], jin[4], jin[5], relu, True) * jin[6]))(
            jin[0])
    want = np.asarray(jdx)[:G]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FWD_TOL * max(1.0, np.abs(want).max()))
    assert not got[-1].any()                 # the padding graph slot


@pytest.mark.parametrize("with_w", [False, True])
def test_dense_agg_bwd_returns_only_what_is_asked(with_w):
    """``dense_agg_bwd`` on the CPU: None for demb and dw where they are
    not asked for (dw also without w), the full triple where they are,
    every output the bits of the full call's."""
    x, src, dst, emask, emb, w, gout = (torch.from_numpy(a)
                                        for a in _k6_inputs(9, seed=7))
    w = w if with_w else None
    full = dense_agg_bwd(x, src, dst, emask, emb, w, gout)
    assert full[1] is not None and (full[2] is None) == (not with_w)
    for need_demb in (False, True):
        for need_dw in (False, True):
            got = dense_agg_bwd(x, src, dst, emask, emb, w, gout,
                                need_demb=need_demb, need_dw=need_dw)
            assert (got[1] is None) == (not need_demb)
            assert (got[2] is None) == (not (need_dw and with_w))
            for a, ref in zip(got, full):
                if a is not None:
                    assert torch.equal(a, ref)


def test_k6_bwd_geometry():
    """A warp a graph: 8 graphs a block at the 4096-graph batch (513
    blocks, one wave on 132 SMs), one where the graphs are about the SMs'
    count; K7-bwd's vector rule (two slices at d 600, one float a load
    where an address is not 16-byte aligned); fewer warps where the edge
    lists pass the shared memory; a stride or slot count past the sort
    key refused."""
    geo = k6.bwd_geometry(4097, 48, 160, 128)
    assert (geo.vec, geo.vpl, geo.slices, geo.warps) == (4, 1, 1, 8)
    assert -(-4097 // geo.warps) == 513
    assert geo.smem == k6.warp_smem(160, 8) == 16 * 160 * 8
    assert geo.args() == (4, 1, 1, 8, geo.smem)
    assert k6.bwd_geometry(129, 48, 160, 128).warps == 1
    assert k6.bwd_geometry(264, 48, 160, 128).warps == 2
    assert k6.bwd_geometry(4097, 48, 160, 600).slices == 2
    assert k6.bwd_geometry(4097, 48, 160, 128, align=1).vec == 1
    assert k6.bwd_geometry(4097, 48, 4000, 128).warps == 3
    for Sm, Em in ((32768, 160), (48, 65537), (48, 20000)):
        with pytest.raises(ValueError):
            k6.bwd_geometry(4097, Sm, Em, 128)


def _gcn_case(d=16):
    b = _bsp_batch(seed=9).to("cpu")
    h = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (CAPS[1], d)).astype(np.float32))
    conv = GCNConv(d, LinearEdgeEncoder(d))
    torch.nn.init.normal_(conv.root_emb)
    tbp.set_block_spmm(conv, "on")
    return b, h, conv


def test_blocked_gcn_encodes_the_src_major_plan_only_for_a_gradient():
    """The blocked GCN layer runs its edge encoder on the dst-major plan's
    slots alone, once a call, under no_grad and inference_mode and where a
    gradient of h or of the encoder is wanted (K8-dx reads those rows
    through the src-major plan's ``fwd_slot``: the src-major plan is
    encoded for no gradient), and gives the same output either way."""
    b, h, conv = _gcn_case()
    seen = []
    conv.edge_encoder.register_forward_hook(
        lambda m, inp, out: seen.append(inp[0]))
    with torch.no_grad():
        served = conv(b, h)
    assert [a is b.edge_attr_bsp_fwd for a in seen] == [True]
    seen.clear()
    with torch.inference_mode():
        torch.testing.assert_close(conv(b, h), served, rtol=0, atol=0)
    assert len(seen) == 1
    for needs in ("h", "encoder"):
        seen.clear()
        conv.zero_grad(set_to_none=True)
        for p in conv.edge_encoder.parameters():
            p.requires_grad_(needs == "encoder")
        hl = h.clone().requires_grad_(needs == "h")
        out = conv(b, hl)
        assert [a is b.edge_attr_bsp_fwd for a in seen] == [True]
        torch.testing.assert_close(out.detach(), served, rtol=0, atol=0)
        out.square().sum().backward()
    for p in conv.edge_encoder.parameters():
        p.requires_grad_(True)
    seen.clear()
    for p in conv.parameters():          # no leaf wants a gradient
        p.requires_grad_(False)
    conv(b, h)
    assert len(seen) == 1


def test_blocked_wrapper_needs_the_src_major_plan_for_a_gradient():
    """The K8 wrapper serves without the src-major plan, its emb copy and
    weight, raises where a gradient is wanted without them, and refuses
    part of them, or one slot weight of two."""
    b, x, emb, w, (pf, pb) = _k8_case(seed=6)
    tx, te, tw = (torch.from_numpy(a) for a in (x, emb, w))
    with torch.no_grad():
        out = blocked_gather_message_scatter(tx.requires_grad_(), te, None,
                                             pf, None, tw)
    np.testing.assert_array_equal(out.numpy(), blocked_gather_message_scatter(
        tx.detach(), te, te, pf, pb, tw, tw).numpy())
    with pytest.raises(ValueError, match="src-major"):
        blocked_gather_message_scatter(tx, te, None, pf, None, tw)
    with torch.no_grad():
        with pytest.raises(ValueError, match="together"):
            blocked_gather_message_scatter(tx, te, te, pf, None, tw, tw)
        with pytest.raises(ValueError, match="together"):
            blocked_gather_message_scatter(tx, te, None, pf, None, tw, tw)
        with pytest.raises(ValueError, match="both"):
            blocked_gather_message_scatter(tx, te, te, pf, pb, None, tw)


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """The argtypes that dense_agg.py, block_spmm.py and spmm.py set have
    as many entries as their C entries have parameters."""
    import pathlib
    import re
    import types

    from graphtrans_tpu_torch.ops.kernels import _build

    k8 = importlib.import_module(
        "graphtrans_tpu_torch.ops.kernels.block_spmm")
    csrc = pathlib.Path(_build.SRC_DIR)
    entries = {"dense_agg": ("dense_agg_fwd", "dense_agg_bwd"),
               "block_spmm": ("block_spmm_demb",),
               "spmm": ("spmm_fwd", "spmm_bwd", "blocked_fwd", "blocked_dx")}
    modules = {"dense_agg": k6, "block_spmm": k8, "spmm": k7}
    for source, names in entries.items():
        fake = types.SimpleNamespace(**{
            n: types.SimpleNamespace(argtypes=None) for n in names})
        monkeypatch.setattr(_build, "load", lambda name, f=fake: f)
        lib = modules[source]._load()
        text = (csrc / f"{source}.cu").read_text()
        for n in names:
            sig = re.search(r'extern "C" \w+ ' + n + r"\((.*?)\)\s*\{", text,
                            re.S)
            assert len(getattr(lib, n).argtypes) == len(
                sig.group(1).split(",")), n
