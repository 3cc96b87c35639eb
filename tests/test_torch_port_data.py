"""Port host code (graphtrans_tpu_torch.data / ops.pack) against the JAX
package: the same numpy inputs must give the same arrays."""

import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphtrans_tpu.data import batch as jb  # noqa: E402
from graphtrans_tpu.data import loader as jl  # noqa: E402
from graphtrans_tpu.data import mol as jm  # noqa: E402
from graphtrans_tpu.data import synthetic as js  # noqa: E402
from graphtrans_tpu.ops import pack as jp  # noqa: E402
from graphtrans_tpu_torch.data import batch as tb  # noqa: E402
from graphtrans_tpu_torch.data import loader as tl  # noqa: E402
from graphtrans_tpu_torch.data import mol as tm  # noqa: E402
from graphtrans_tpu_torch.data import synthetic as ts  # noqa: E402
from graphtrans_tpu_torch.ops import pack as tp  # noqa: E402
from _heap import release_freed_heap  # noqa: E402,F401

SNAPSHOT = "data_snapshots"


def _assert_graphs_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert sorted(ga) == sorted(gb)
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
            assert np.asarray(ga[k]).dtype == np.asarray(gb[k]).dtype, k


def test_make_mol_dataset_matches_jax():
    kw = dict(num_graphs=12, num_tasks=5, min_nodes=4, max_nodes=20, seed=3)
    _assert_graphs_equal(js.make_mol_dataset(**kw), ts.make_mol_dataset(**kw))


def test_snapshot_loader_matches_jax():
    got = tm.load_ogb_graphs(SNAPSHOT, "ogbg-molpcba")
    want = jm.load_ogb_graphs(SNAPSHOT, "ogbg-molpcba")
    _assert_graphs_equal(want[0], got[0])
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(want[1][split], got[1][split])
    assert [len(got[1][s]) for s in ("train", "valid", "test")] == [192, 24, 24]
    assert max(g["x"].shape[0] for g in got[0]) <= 35
    assert max(g["edge_index"].shape[1] for g in got[0]) <= 76
    assert tm.load_ogb_graphs(SNAPSHOT, "ogbg-molhiv") is None


@pytest.mark.parametrize("dataset", ["ogbg-molpcba", "ogbg-molhiv"])
def test_synthetic_fallback_matches_jax_preprocess(dataset):
    """No snapshot under data_root: both packages draw the same synthetic
    graphs and the same 80/10/10 split."""
    args = argparse.Namespace(data_root="no_such_root", dataset=dataset,
                              synthetic_num_graphs=30, synthetic_seed=4,
                              gnn_emb_dim=8)
    want = jm.MolUtil.preprocess(args)
    got, num_tasks = tm.load_mol_splits("no_such_root", dataset, 30, 4)
    assert num_tasks == want.num_tasks
    for split in ("train", "valid", "test"):
        _assert_graphs_equal(want.splits[split], got[split])
    assert tm.load_mol_splits(None, dataset, 30, 4)[1] == num_tasks


@pytest.mark.parametrize("n", [1, 16, 17, 100, 129, 300, 1000])
def test_bucket_size_matches_jax(n):
    for m in (8, 16, 128):
        assert tb.bucket_size(n, m) == jb.bucket_size(n, m)


def test_dataset_caps_matches_jax():
    graphs = ts.make_mol_dataset(num_graphs=40, num_tasks=2, seed=1)
    for bs in (4, 16, 64):
        assert tl.dataset_caps(graphs, bs) == jl.dataset_caps(graphs, bs)


@pytest.mark.parametrize("rows_cap", [0, 6])
def test_build_pack_fields_matches_jax(rows_cap):
    num_nodes = np.array([5, 200, 60, 31, 0], np.int64)
    mask = num_nodes > 0
    offs = np.concatenate([[0], np.cumsum(num_nodes)[:-1]])
    N = int(num_nodes.sum()) + 8
    want = jp.build_pack_fields(num_nodes, mask, offs, N, 128, 127, rows_cap)
    got = tp.build_pack_fields(num_nodes, mask, offs, N, 128, 127, rows_cap)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]))
    tokens = np.array([3, 9, 4, 7])
    for a, b in zip(tp.plan_seq_pack(tokens, 10), jp.plan_seq_pack(tokens, 10)):
        np.testing.assert_array_equal(a, b)
    assert tp.build_pack_fields(num_nodes, mask, offs, N, 128, 127, 1) is None


@pytest.mark.parametrize("layout", ["strided_packed", "flat"])
def test_collate_matches_jax(layout):
    graphs = ts.make_mol_dataset(num_graphs=7, num_tasks=4, min_nodes=3,
                                 max_nodes=30, seed=5)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    if layout == "strided_packed":
        kw = dict(node_stride=32, dense_edge_cap=96, seq_pack_w=128)
        caps = (8, 8 * 32, 512)
    else:
        kw = {}
        caps = (8, 256, 512)
    want = jb.collate(graphs, *caps, num_tasks=4, y_dtype="float32", **kw)
    got = tb.collate(graphs, *caps, num_tasks=4, y_dtype="float32", **kw)
    names = [f.name for f in dataclasses.fields(got)]
    for k in names:
        a, b = getattr(want, k), getattr(got, k)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=k)
            assert np.asarray(a).dtype == b.dtype, k
        else:
            assert a == b or (a is None and b is None), k
    tt = got.to("cpu")
    assert isinstance(tt.node_feat, torch.Tensor)
    assert tt.edge_mask_dense is None or tt.edge_mask_dense.dtype == torch.bool


@pytest.mark.parametrize("layout", ["strided_packed", "flat"])
def test_collate_takes_a_graph_without_edges(layout):
    """A one-atom molecule (no bonds, edge_attr of shape [0, 3]) between
    two others: its node is in the batch, none of its edge slots is valid,
    and the other graphs' edges are collated as without it."""
    graphs = ts.make_mol_dataset(num_graphs=2, num_tasks=4, min_nodes=3,
                                 max_nodes=30, seed=5)
    lone = dict(graphs[0], x=graphs[0]["x"][:1],
                edge_index=np.zeros((2, 0), np.int64),
                edge_attr=np.zeros((0, 3), np.int8))
    kw = (dict(node_stride=32, dense_edge_cap=96, seq_pack_w=128)
          if layout == "strided_packed" else {})
    caps = (3, 3 * 32, 512)
    got = tb.collate([graphs[0], lone, graphs[1]], *caps, num_tasks=4,
                     y_dtype="float32", **kw)
    ref = tb.collate(graphs, *caps, num_tasks=4, y_dtype="float32", **kw)
    assert got.num_nodes[1] == 1 and got.graph_mask[1]
    e = int(ref.edge_mask.sum())
    assert int(got.edge_mask.sum()) == e
    np.testing.assert_array_equal(got.edge_attr[:e], ref.edge_attr[:e])
    if layout == "strided_packed":
        assert not got.edge_mask_dense[1].any()
        np.testing.assert_array_equal(got.edge_attr_dense[[0, 2]],
                                      ref.edge_attr_dense[:2])


def test_collate_rejects_later_options():
    graphs = ts.make_mol_dataset(num_graphs=2, num_tasks=1, seed=0)
    with pytest.raises(NotImplementedError, match="slice 11 \\(PNA"):
        tb.collate(graphs, 3, 128, 256, scatter_free=True)
    # tiers that do not narrow, or a third tier without a second: the JAX
    # package drops them silently, the port refuses them
    for bad in (dict(seq_pack_w2=128), dict(seq_pack_w3=64)):
        with pytest.raises(ValueError, match="seq_pack|narrow"):
            tb.collate(graphs, 3, 128, 256, seq_pack_w=128, **bad)
    with pytest.raises(TypeError):
        tb.collate(graphs, 3, 128, 256, no_such_option=1)


def test_iterate_batches_covers_split_in_order():
    graphs = ts.make_mol_dataset(num_graphs=21, num_tasks=3, seed=2)
    node_cap, edge_cap = tl.dataset_caps(graphs, 8)
    ids = []
    for b in tl.iterate_batches(graphs, 8, 9 * 48, edge_cap, num_tasks=3,
                                y_dtype="float32", node_stride=48,
                                dense_edge_cap=96, seq_pack_w=128):
        assert b.num_graph_slots == 9
        ids += [int(i) for i in b.graph_ids[b.graph_mask]]
    assert ids == list(range(21))
