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
    entries have parameters, and the launch's seven ints follow the
    tensors' shape."""
    from graphtrans_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        gin_agg_fwd=types.SimpleNamespace(argtypes=None),
        gin_agg_bwd=types.SimpleNamespace(argtypes=None)))
    lib = k1._load()
    for entry in ("gin_agg_fwd", "gin_agg_bwd"):
        assert len(getattr(lib, entry).argtypes) == _c_params(entry), entry
    assert len(k1.bwd_geometry(9, 48, 144, 3, 13, 300, True).args()) == 7
