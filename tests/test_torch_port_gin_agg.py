"""Kernel K1 (GIN aggregation with in-kernel bond lookup): the port's plain
version against the JAX Pallas kernel in interpret mode and the XLA dense
route. The CUDA kernel is held against the plain version on the card in
test_torch_port_cuda.py."""

import dataclasses

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
from graphtrans_tpu_torch.ops.kernels import gin_agg, gin_agg_plain  # noqa: E402

TOL = 1e-5  # f32, sums of <= Em terms in another order


def _case(d, seed=0, G=7, Sm=32, Em=96):
    """A strided batch with padding graph slots and masked edges, random x
    (zero on padding rows), bond tables, edge weights and a GIN scale."""
    rng = np.random.default_rng(seed)
    graphs = make_mol_dataset(num_graphs=G - 2, num_tasks=2, min_nodes=4,
                              max_nodes=Sm, seed=seed)
    b = collate(graphs, G, G * Sm, 1024, num_tasks=2, y_dtype="float32",
                node_stride=Sm, dense_edge_cap=Em)
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

