"""Kernel K1 (GIN aggregation with in-kernel bond lookup): the port's plain
version, forward and gradients, against the JAX Pallas kernel in interpret
mode and the XLA dense route. The CUDA kernels are held against the plain
version on the card in test_torch_port_cuda.py."""

import dataclasses
import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops import dense_mp as jdm  # noqa: E402
from graphtrans_tpu.ops.pallas.gin_agg import VP, fused_gin_agg  # noqa: E402
from graphtrans_tpu_torch.data.batch import collate  # noqa: E402
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import BOND_FEATURE_DIMS  # noqa: E402
from graphtrans_tpu_torch.ops import dense_mp  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    gin_agg, gin_agg_bwd, gin_agg_bwd_plain, gin_agg_plain)
from _heap import release_freed_heap  # noqa: E402,F401

k1 = importlib.import_module("graphtrans_tpu_torch.ops.kernels.gin_agg")
CSRC = Path(__file__).resolve().parents[1] / "graphtrans_tpu_torch" / "csrc"
TOL = 1e-5  # f32, sums of <= Em terms in another order
SMEM_MAX, SMS = 232448, 132


def _case(d, seed=0, G=7, Sm=32, Em=96):
    """A strided batch with padding graph slots and masked edges, random x
    (zero on padding rows), bond tables, edge weights and a GIN scale."""
    rng = np.random.default_rng(seed)
    graphs = make_mol_dataset(num_graphs=G - 2, num_tasks=2, min_nodes=4,
                              max_nodes=Sm, seed=seed)
    b = collate(graphs, G, G * Sm, max(1024, G * Em), num_tasks=2,
                y_dtype="float32", node_stride=Sm, dense_edge_cap=Em)
    x = rng.standard_normal((G * Sm, d)).astype(np.float32)
    x[~b.node_mask] = 0
    V = sum(BOND_FEATURE_DIMS)
    tbl = rng.standard_normal((V, d)).astype(np.float32)
    attr = b.edge_attr_dense.astype(np.int32)
    cols, off = [], 0
    for f, n in enumerate(BOND_FEATURE_DIMS):
        cols.append(np.clip(attr[..., f], 0, n - 1) + off)
        off += n
    return dict(batch=b, x=x.reshape(G, Sm, d), tbl=tbl,
                attr=np.stack(cols, axis=1).astype(np.int32),
                w=rng.standard_normal((G, Em)).astype(np.float32),
                scale=np.float32(1.0 + rng.standard_normal() * 0.1))


def _torch_args(c, with_w, with_scale, device="cpu"):
    b = c["batch"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(c["x"]), t(b.edge_src_dense), t(b.edge_dst_dense),
            t(b.edge_mask_dense), t(c["attr"]), t(c["tbl"]),
            t(c["w"]) if with_w else None,
            t(np.array([c["scale"]])) if with_scale else None)


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_plain_matches_jax_interpret_kernel(with_w, with_scale):
    c = _case(128, seed=1)
    b = c["batch"]
    tblp = np.concatenate([c["tbl"], np.zeros((VP - len(c["tbl"]), 128),
                                              np.float32)])
    want = fused_gin_agg(
        jnp.asarray(c["x"]), jnp.asarray(b.edge_src_dense),
        jnp.asarray(b.edge_dst_dense), jnp.asarray(b.edge_mask_dense),
        jnp.asarray(c["attr"]), jnp.asarray(tblp),
        jnp.asarray(c["w"]) if with_w else None,
        jnp.float32(c["scale"]) if with_scale else None,
        True, with_scale, True)
    got = gin_agg_plain(*_torch_args(c, with_w, with_scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # CPU tensors take the plain version through the wrapper, uncounted
    before = gin_agg.launches
    again = gin_agg(*_torch_args(c, with_w, with_scale))
    assert gin_agg.launches == before
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("d", [40, 300])
def test_plain_matches_jax_xla_dense_route(with_w, d):
    """Any width: the XLA one-hot route with the encoder's lookup outside."""
    c = _case(d, seed=2, Sm=48, Em=144)
    b = c["batch"]
    G, Sm, _ = c["x"].shape
    emb = c["tbl"][c["attr"]].sum(axis=1)                    # [G, Em, d]
    want = jdm.gather_message_scatter_dense(
        jnp.asarray(c["x"].reshape(G * Sm, d)), b, jnp.asarray(emb),
        edge_weight=jnp.asarray(c["w"]) if with_w else None)
    got = gin_agg_plain(*_torch_args(c, with_w, False))
    np.testing.assert_allclose(got.numpy().reshape(G * Sm, d),
                               np.asarray(want), atol=TOL, rtol=0)
    assert not got.numpy().reshape(G * Sm, d)[~b.node_mask].any()


def _gout(c, seed):
    return np.random.default_rng(seed).standard_normal(
        c["x"].shape).astype(np.float32)


def _assert_grads(got, want, V):
    """got: the port's (dx, dT, dw, dscale); want: JAX's, with dT padded to
    VP rows in the interpret kernel (rows past V must be zero)."""
    dx, dt, dw, dsc = got
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), atol=GTOL,
                               rtol=0)
    wt = np.asarray(want[1])
    np.testing.assert_allclose(dt.numpy(), wt[:V], atol=GTOL, rtol=0)
    assert not wt[V:].any()
    for g, w in ((dw, want[2]), (dsc, want[3])):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy().reshape(np.shape(w)),
                                       np.asarray(w), atol=GTOL, rtol=0)


GTOL = 5e-4  # gradients: sums over every edge of the batch, in f32


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("with_scale", [False, True])
def test_plain_grads_match_jax_interpret_kernel(with_w, with_scale):
    """K1's plain version differentiated by autograd against jax.vjp of
    fused_gin_agg, whose backward is the interpret-mode Pallas kernel."""
    import jax

    c = _case(128, seed=4)
    b = c["batch"]
    V = len(c["tbl"])
    tblp = np.concatenate([c["tbl"], np.zeros((VP - V, 128), np.float32)])
    fixed = [jnp.asarray(a) for a in (b.edge_src_dense, b.edge_dst_dense,
                                      b.edge_mask_dense, c["attr"])]

    def f(x, tbl, *opt):
        opt = list(opt)
        w = opt.pop(0) if with_w else None
        scale = opt.pop(0) if with_scale else None
        return fused_gin_agg(x, *fixed, tbl, w, scale, True, with_scale, True)

    primals = [jnp.asarray(c["x"]), jnp.asarray(tblp)]
    if with_w:
        primals.append(jnp.asarray(c["w"]))
    if with_scale:
        primals.append(jnp.float32(c["scale"]))
    gout = _gout(c, 5)
    _, vjp = jax.vjp(f, *primals)
    jg = list(vjp(jnp.asarray(gout)))
    want = jg[:2] + [jg.pop(2) if with_w else None,
                     jg[2] if with_scale else None]
    args = _torch_args(c, with_w, with_scale)
    got = gin_agg_bwd_plain(*args, torch.from_numpy(gout))
    _assert_grads(got, want, V)
    # CPU tensors take the plain version through the wrapper, uncounted
    before = gin_agg_bwd.launches
    again = gin_agg_bwd(*args, torch.from_numpy(gout))
    assert gin_agg_bwd.launches == before
    # autograd's CPU index backward adds the table gradient in no fixed
    # order, so two runs differ by f32 rounding of sums up to ~15
    for a, g in zip(again, got):
        assert (a is None) == (g is None)
        if a is not None:
            torch.testing.assert_close(a, g, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G", [7, 37])
@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (True, True)])
def test_plain_grads_match_jax_interpret_kernel_at_width_300(G, with_w,
                                                             with_scale):
    """The published GIN width 300 (75 float4 lanes: the backward kernel's
    one slice at the bench batch, three at a small one) and 37 graphs, a
    prime, so no chunk of several graphs divides them: K1's plain backward
    against jax.vjp of the interpret-mode kernel within GTOL of max(1,
    max |ref|) per output (dT and dscale sum over the whole batch)."""
    import jax

    c = _case(300, seed=8, G=G)
    b = c["batch"]
    V = len(c["tbl"])
    tblp = np.concatenate([c["tbl"], np.zeros((VP - V, 300), np.float32)])
    fixed = [jnp.asarray(a) for a in (b.edge_src_dense, b.edge_dst_dense,
                                      b.edge_mask_dense, c["attr"])]

    def f(x, tbl, w, scale):
        return fused_gin_agg(x, *fixed, tbl, w if with_w else None,
                             scale if with_scale else None, True, with_scale,
                             True)

    gout = _gout(c, 9)
    _, vjp = jax.vjp(f, jnp.asarray(c["x"]), jnp.asarray(tblp),
                     jnp.asarray(c["w"]), jnp.float32(c["scale"]))
    jdx, jdt, jdw, jdsc = vjp(jnp.asarray(gout))
    got = gin_agg_bwd_plain(*_torch_args(c, with_w, with_scale),
                            torch.from_numpy(gout))
    want = (jdx, np.asarray(jdt)[:V], jdw if with_w else None,
            jdsc if with_scale else None)
    assert not np.asarray(jdt)[V:].any()
    for name, g, w in zip(("dx", "dT", "dw", "dscale"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy().reshape(w.shape), w, rtol=0,
                atol=GTOL * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("with_w", [False, True])
def test_plain_grads_match_jax_xla_dense_route(with_w):
    """Width 40: jax.vjp through the XLA one-hot route with the table
    lookup outside and the GIN combine scale*x + agg."""
    import jax

    c = _case(40, seed=6, Sm=48, Em=144)
    b = c["batch"]
    G, Sm, d = c["x"].shape
    attr = jnp.asarray(c["attr"])

    def f(x, tbl, scale, *w):
        emb = tbl[attr].sum(axis=1)                          # [G, Em, d]
        agg = jdm.gather_message_scatter_dense(
            x.reshape(G * Sm, d), b, emb,
            edge_weight=w[0] if w else None).reshape(G, Sm, d)
        return scale * x + agg

    primals = [jnp.asarray(c["x"]), jnp.asarray(c["tbl"]),
               jnp.float32(c["scale"])]
    if with_w:
        primals.append(jnp.asarray(c["w"]))
    gout = _gout(c, 7)
    _, vjp = jax.vjp(f, *primals)
    jg = vjp(jnp.asarray(gout))
    want = (jg[0], jg[1], jg[3] if with_w else None, jg[2])
    got = gin_agg_bwd_plain(*_torch_args(c, with_w, True),
                            torch.from_numpy(gout))
    _assert_grads(got, want, len(c["tbl"]))


def test_fused_tables_route_matches_jax():
    """dense_mp's wrapper (per-feature clip, folded offsets, prologue) vs
    the JAX fused-tables route in interpret mode, with an out-of-range bond
    feature that both clip."""
    c = _case(128, seed=3)
    b = c["batch"]
    G, Sm, d = c["x"].shape
    ea = b.edge_attr_dense.copy()
    ea[0, 0, 1] = 9                                          # > dims[1] - 1
    b = dataclasses.replace(b, edge_attr_dense=ea)
    jdm._FUSED_TABLES_INTERPRET = True
    try:
        want = jdm.gather_message_scatter_dense_tables(
            jnp.asarray(c["x"].reshape(G * Sm, d)), b, jnp.asarray(c["tbl"]),
            BOND_FEATURE_DIMS, eps_scale=jnp.float32(c["scale"]))
    finally:
        jdm._FUSED_TABLES_INTERPRET = False
    tb = b.to("cpu")
    got = dense_mp.gather_message_scatter_dense_tables(
        torch.from_numpy(c["x"].reshape(G * Sm, d)), tb,
        torch.from_numpy(c["tbl"]), BOND_FEATURE_DIMS,
        eps_scale=torch.tensor([c["scale"]]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)



# ---- K1-bwd's launch (csrc/gin_agg.cu), on the CPU -------------------------


@pytest.mark.parametrize("has_w", [False, True])
@pytest.mark.parametrize("Sm,Em", [(32, 96), (48, 80)])
@pytest.mark.parametrize("d", [40, 128, 300])
@pytest.mark.parametrize("G", [1, 65, 4097])
def test_bwd_geometry_covers_every_graph_and_channel(G, d, Sm, Em, has_w):
    """bwd_geometry at one graph, serve64's 65 and the bench batch's 4097:
    every graph in one chunk and every channel in one lane of one slice,
    the last warp of a slice the only one with idle lanes, the shared
    bytes the C entry computes within a block's limit, and the blocks one
    wave of what the shared memory lets the card hold. At 65 graphs the channels split so that
    every SM gets a block, but at d 40: its 10 float4 lanes are one warp,
    and a slice keeps at least MIN_SLICE_LANES."""
    geo = k1.bwd_geometry(G, Sm, Em, 3, 13, d, has_w)
    assert geo.vec == 4 and geo.grid == (geo.chunks, geo.slices)
    lanes = geo.channels // geo.vec
    assert geo.channels % geo.vec == 0 and geo.threads % 32 == 0
    assert geo.threads - 32 < lanes <= geo.threads <= k1.BWD_MAX_THREADS
    seen = np.zeros(d, int)
    for sl in range(geo.slices):
        for lane in range(lanes):
            for j in range(geo.vec):
                c = sl * geo.channels + lane * geo.vec + j
                if c < d:
                    seen[c] += 1
    assert (seen == 1).all() and (geo.slices - 1) * geo.channels < d
    graphs = np.zeros(G, int)
    for chunk in range(geo.chunks):
        graphs[chunk * geo.gpb:(chunk + 1) * geo.gpb] += 1
    assert (graphs == 1).all() and (geo.chunks - 1) * geo.gpb < G
    assert geo.smem == k1.bwd_smem(Sm, Em, 3, 13, geo.channels, geo.threads,
                                   has_w, geo.xrows) <= SMEM_MAX
    # x whole where a block walks one graph, else the ring
    assert geo.xrows == (Sm if geo.gpb == 1 else k1.XRING)
    per_sm = k1.SM_SHARED // (geo.smem + 1024)
    assert geo.chunks * geo.slices <= SMS * per_sm or geo.gpb == 1
    if geo.gpb > 1:    # not a block fewer would do
        assert (geo.chunks - 1) * geo.slices < SMS * per_sm
    if G == 65:
        assert (geo.chunks * geo.slices >= SMS
                or -(-d // 4) < 2 * k1.MIN_SLICE_LANES)
    if G == 4097 and d == 300:     # the bench batch: one slice of all of d
        assert geo.slices == 1 and geo.threads == 96 and geo.gpb > 1
        if Sm == 32 and not has_w:  # three blocks an SM
            assert per_sm == 3 and geo.chunks == 373


def test_bwd_geometry_vector_width_follows_width_and_addresses():
    """4 channels a thread where d and the addresses allow, else 1 (at
    d 300 on addresses that are not 16-byte aligned: three slices of 100
    lanes); a table row sum of more than BWD_MAX_F rows or a graph too
    large for a block's shared memory raise."""
    geo = lambda d, **k: k1.bwd_geometry(65, 48, 80, 3, 13, d, False, **k)
    assert [geo(d).vec for d in (300, 42, 45)] == [4, 1, 1]
    assert geo(300, align=2).vec == 1 and geo(300, align=1).vec == 1
    assert geo(300, align=1).threads == 128 and geo(300, align=1).slices == 3
    assert geo(300, align=1).channels == 100 and geo(42).channels == 14
    with pytest.raises(ValueError, match="table rows"):
        k1.bwd_geometry(65, 48, 80, 5, 13, 300, False)
    with pytest.raises(ValueError, match="shared memory"):
        k1.bwd_geometry(65, 16384, 80, 3, 13, 300, False)


def _c_params(entry: str) -> int:
    text = (CSRC / "gin_agg.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                    re.S)
    return len(sig.group(1).split(","))


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """The argtypes that gin_agg.py sets have as many entries as K1's C
    entries have parameters, and each launch's ints (six forward, seven
    backward) follow the tensors' shape."""
    from graphtrans_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        gin_agg_fwd=types.SimpleNamespace(argtypes=None),
        gin_agg_bwd=types.SimpleNamespace(argtypes=None)))
    lib = k1._load()
    for entry in ("gin_agg_fwd", "gin_agg_bwd"):
        assert len(getattr(lib, entry).argtypes) == _c_params(entry), entry
    assert len(k1.bwd_geometry(9, 48, 144, 3, 13, 300, True).args()) == 7
    assert len(k1.fwd_geometry(9, 48, 144, 3, 13, 300, True).args()) == 6


# ---- K1's forward launch and walk (csrc/gin_agg.cu), on the CPU -----------


def _parent_accepts(Sm, Em, F, V):
    """The shared bytes the earlier forward kernel needed (its wrapper's
    check): x, an accumulator and the table in 128-channel slices, and the
    staged edge lists."""
    return (2 * Sm + V) * 128 * 4 + Em * (3 + F) * 4 <= SMEM_MAX


def _covers(geo, G, d):
    """Every channel in one lane of one slice, every graph in one chunk,
    the last warp of a slice the only one with idle lanes."""
    lanes = geo.channels // geo.vec
    assert geo.channels % geo.vec == 0 and geo.threads % 32 == 0
    assert geo.threads - 32 < lanes <= geo.threads <= k1.BWD_MAX_THREADS
    seen = np.zeros(d, int)
    for sl in range(geo.slices):
        for lane in range(lanes):
            c = sl * geo.channels + lane * geo.vec
            seen[c:min(c + geo.vec, d)] += 1
    assert (seen == 1).all() and (geo.slices - 1) * geo.channels < d
    graphs = np.zeros(G, int)
    for chunk in range(geo.chunks):
        graphs[chunk * geo.gpb:(chunk + 1) * geo.gpb] += 1
    assert (graphs == 1).all() and (geo.chunks - 1) * geo.gpb < G


@pytest.mark.parametrize("has_w", [False, True])
@pytest.mark.parametrize("Sm,Em", [(32, 96), (48, 80), (128, 384)])
@pytest.mark.parametrize("d", [40, 128, 300])
@pytest.mark.parametrize("G", [1, 65, 4097])
def test_fwd_geometry_covers_every_graph_and_channel(G, d, Sm, Em, has_w):
    """fwd_geometry at one graph, serve64's 65 and the bench batch's 4097:
    every graph and channel once, the shared bytes the C entry computes
    within a block's limit, and the blocks one wave of what the shared
    memory lets the card hold. At 4097 graphs of stride 32 and d 300 a
    block covers all of d (96 threads): five blocks an SM, 7 graphs a
    block."""
    geo = k1.fwd_geometry(G, Sm, Em, 3, 13, d, has_w)
    assert geo.vec == 4 and geo.grid == (geo.chunks, geo.slices)
    _covers(geo, G, d)
    assert geo.smem == k1.fwd_smem(Sm, Em, 3, geo.channels,
                                   has_w) <= SMEM_MAX
    per_sm = k1.SM_SHARED // (geo.smem + 1024)
    assert geo.chunks * geo.slices <= SMS * per_sm or geo.gpb == 1
    if geo.gpb > 1:    # not a block fewer would do
        assert (geo.chunks - 1) * geo.slices < SMS * per_sm
    if G == 65:        # the channels split so that every SM gets a block
        assert (geo.chunks * geo.slices >= SMS
                or -(-d // 4) < 2 * k1.MIN_SLICE_LANES)
    if G == 4097 and d == 300 and Sm == 32:
        assert geo.slices == 1 and geo.threads == 96
        assert (per_sm, geo.gpb) == (5, 7)


@pytest.mark.parametrize("G", [1, 4097])
@pytest.mark.parametrize("F", [1, 3, 4, 6])
@pytest.mark.parametrize("Sm", [1, 32, 128, 220])
def test_fwd_geometry_takes_every_shape_the_parent_took(Sm, F, G):
    """Every (Sm, Em, F, V, d) that the earlier forward's check accepted
    gets a launch within a block's shared memory, the largest edge count
    it allowed included: where a graph does not fit a block, the channels
    split, down to one lane a slice; stride 128 at d 300 splits none at
    the bench batch."""
    for V in (1, 13, 64):
        top = (SMEM_MAX - (2 * Sm + V) * 128 * 4) // ((3 + F) * 4)
        for Em in sorted({0, 1, 96, top // 2, top}):
            if Em < 0 or not _parent_accepts(Sm, Em, F, V):
                continue
            for d in (4, 40, 42, 300):
                for has_w in (False, True):
                    geo = k1.fwd_geometry(G, Sm, Em, F, V, d, has_w)
                    _covers(geo, G, d)
                    assert geo.smem <= SMEM_MAX
    geo = k1.fwd_geometry(4097, 128, 384, 3, 13, 300, False)
    assert geo.slices == 1 and geo.channels == 300
    with pytest.raises(ValueError, match="table rows"):
        k1.fwd_geometry(G, Sm, 96, 0, 13, 300, False)
    with pytest.raises(ValueError, match="shared memory"):
        k1.fwd_geometry(G, 40000, 96, 3, 13, 300, False)


def test_fwd_geometry_vector_width_follows_width_and_addresses():
    """4 channels a thread where d and the addresses allow, else 1: at
    d 300 on addresses that are not 16-byte aligned, serve64 takes three
    slices of 100 lanes, one warp short of four a slice."""
    geo = lambda d, **k: k1.fwd_geometry(65, 48, 80, 3, 13, d, False, **k)
    assert [geo(d).vec for d in (300, 42, 45)] == [4, 1, 1]
    assert geo(300, align=2).vec == 1 and geo(300, align=1).vec == 1
    assert geo(300, align=1).threads == 128 and geo(300, align=1).slices == 3
    assert geo(300, align=1).channels == 100 and geo(42).channels == 14


def _fwd_inputs(d, seed=3):
    """_case's inputs as numpy, with one graph whose slots are all masked
    and a weight of exactly 0 on a valid slot."""
    c = _case(d, seed=seed)
    b = c["batch"]
    emask = np.array(b.edge_mask_dense)
    emask[1] = False
    w = c["w"].copy()
    w[0, np.nonzero(emask[0])[0][1]] = 0.0
    return (c["x"], np.asarray(b.edge_src_dense), np.asarray(b.edge_dst_dense),
            emask, c["attr"], c["tbl"], w, np.float32(c["scale"]))


def _emb(tbl, a):
    """T[a0] + T[a1] + ..., in that order (TableEmb's)."""
    v = tbl[a[0]].copy()
    for f in range(1, len(a)):
        v = v + tbl[a[f]]
    return v


def _emulate_parent_fwd(x, src, dst, emask, attr, tbl, w, scale):
    """The earlier forward's arithmetic in float32: each valid slot in
    order adds w * relu(x[src] + T-sum) into a shared accumulator row."""
    G, Sm, d = x.shape
    out = np.zeros_like(x)
    for g in range(G):
        for e in np.nonzero(emask[g])[0]:
            m = np.maximum(x[g, src[g, e]] + _emb(tbl, attr[g, :, e]),
                           np.float32(0))
            if w is not None:
                m = m * w[g, e]
            out[g, dst[g, e]] = out[g, dst[g, e]] + m
    return out if scale is None else out + scale * x


def _emulate_fwd(x, src, dst, emask, attr, tbl, w, scale):
    """The new forward's walk in float32, graph by graph: the valid slots'
    keys dst * Em + slot, each one's rank places its record (src | dst <<
    16, the table rows, w), and the walk over the sorted records closes a
    row (its sum, plus scale * x) when it passes it."""
    G, Sm, d = x.shape
    Em = src.shape[1]
    out = np.full_like(x, np.nan)
    for g in range(G):
        key = np.where(emask[g], dst[g].astype(np.int64) * Em + np.arange(Em),
                       2**31 - 1)
        rec, recw = {}, {}
        for e in np.nonzero(emask[g])[0]:
            p = int((key < key[e]).sum())
            assert p not in rec            # a rank is one slot's
            rec[p] = (int(src[g, e]) | int(key[e] // Em) << 16,
                      attr[g, :, e])
            recw[p] = None if w is None else w[g, e]
        assert sorted(rec) == list(range(len(rec)))
        acc, row = np.zeros(d, np.float32), 0
        for k in range(len(rec) + 1):
            dd = Sm if k == len(rec) else rec[k][0] >> 16
            while row < dd:
                out[g, row] = acc if scale is None else acc + scale * x[g, row]
                acc, row = np.zeros(d, np.float32), row + 1
            if k == len(rec):
                break
            m = np.maximum(x[g, rec[k][0] & 0xFFFF] + _emb(tbl, rec[k][1]),
                           np.float32(0))
            if recw[k] is not None:
                m = m * recw[k]
            acc = acc + m
    return out


@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (True, True)])
def test_fwd_walk_gives_the_parent_order(with_w, with_scale):
    """The new forward's algorithm, emulated in float32, gives the earlier
    forward's bits (each row's terms in slot order: the sort by (dst,
    slot) is stable) and agrees with the plain version, on a batch with
    padding graphs, a graph whose slots are all masked and a zero weight."""
    x, src, dst, emask, attr, tbl, w, scale = _fwd_inputs(8)
    w = w if with_w else None
    scale = scale if with_scale else None
    got = _emulate_fwd(x, src, dst, emask, attr, tbl, w, scale)
    np.testing.assert_array_equal(
        got, _emulate_parent_fwd(x, src, dst, emask, attr, tbl, w, scale))
    t = torch.from_numpy
    want = gin_agg_plain(t(x), t(src), t(dst), t(emask), t(attr), t(tbl),
                         None if w is None else t(w),
                         None if scale is None else torch.tensor([scale]))
    np.testing.assert_allclose(got, want.numpy(), atol=TOL, rtol=0)
