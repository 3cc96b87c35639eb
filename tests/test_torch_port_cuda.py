"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports no JAX, so it runs on a machine with a card
and no JAX (``--noconftest`` skips tests/conftest.py, which imports JAX):
    python -m pytest tests/test_torch_port_cuda.py -q --noconftest
"""

import pytest

torch = pytest.importorskip("torch")

from graphtrans_tpu_torch.data.batch import collate  # noqa: E402
from graphtrans_tpu_torch.data.synthetic import make_mol_dataset  # noqa: E402
from graphtrans_tpu_torch.nn.encoders import BOND_FEATURE_DIMS  # noqa: E402
from graphtrans_tpu_torch.ops.dense_mp import bond_table_index  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    attention_seg, attention_seg_plain, gin_agg, gin_agg_plain, set_kernels)

K1_TOL, K2_TOL, LOGITS_TOL = 1e-5, 2e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _batch(G=9, Sm=48, Em=144, seed=0):
    graphs = make_mol_dataset(num_graphs=G - 2, num_tasks=4, min_nodes=1,
                              max_nodes=Sm, seed=seed)
    graphs = [dict(g, _id=i) for i, g in enumerate(graphs)]
    return collate(graphs, G, G * Sm, 4096, num_tasks=4, y_dtype="float32",
                   node_stride=Sm, dense_edge_cap=Em, seq_pack_w=128)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 300])
@pytest.mark.parametrize("with_w,with_scale", [(False, True), (True, False),
                                               (False, False)])
def test_gin_agg_kernel_matches_plain(cuda, d, with_w, with_scale):
    b = _batch().to(cuda)
    G, Sm, Em = b.num_graph_slots, b.node_stride, b.edge_src_dense.shape[1]
    gen = torch.Generator().manual_seed(d)
    x = torch.randn(G, Sm, d, generator=gen).to(cuda)
    x = x.masked_fill(~b.node_mask.reshape(G, Sm, 1), 0.0)
    args = (x, b.edge_src_dense, b.edge_dst_dense, b.edge_mask_dense,
            bond_table_index(b.edge_attr_dense, BOND_FEATURE_DIMS),
            torch.randn(sum(BOND_FEATURE_DIMS), d, generator=gen).to(cuda),
            torch.randn(G, Em, generator=gen).to(cuda) if with_w else None,
            torch.tensor([1.25], device=cuda) if with_scale else None)
    before = gin_agg.launches
    got = gin_agg(*args)
    torch.cuda.synchronize()
    assert gin_agg.launches == before + 1
    assert (got - gin_agg_plain(*args)).abs().max().item() <= K1_TOL
    assert not got.reshape(G * Sm, d)[~b.node_mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("W,d,H", [(128, 128, 4), (384, 128, 4), (256, 64, 2)])
def test_attention_seg_kernel_matches_plain(cuda, W, d, H):
    gen = torch.Generator().manual_seed(W + d)
    R = 6
    seg = torch.full((R, W), -1, dtype=torch.int32)
    lens = torch.randint(2, W // 3, (64,), generator=gen).tolist()
    g = 0
    for r in range(R - 1):                       # the last row is all padding
        s = 0
        while s + lens[g % 64] <= W - 5:
            seg[r, s:s + lens[g % 64]] = g
            s += lens[g % 64]
            g += 1
    qkv = torch.randn(R, W, 3 * d, generator=gen).to(cuda)
    seg = seg.to(cuda)
    before = attention_seg.launches
    got = attention_seg(qkv, seg, H)
    torch.cuda.synchronize()
    assert attention_seg.launches == before + 1
    assert (got - attention_seg_plain(qkv, seg, H)).abs().max().item() <= K2_TOL
    assert not got[seg < 0].any()


@pytest.mark.cuda
def test_model_kernels_match_plain_versions(cuda):
    from graphtrans_tpu_torch.models.gnn_transformer import GNNTransformer
    from graphtrans_tpu_torch.nn.init import init_weights

    model = GNNTransformer(4, 3, 300, True, 128, 4, 512, 2, True, device=cuda)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    b = _batch(seed=3).to(cuda)
    with torch.inference_mode():
        got = model(b)[b.graph_mask]
        want = set_kernels(model, False)(b)[b.graph_mask]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= LOGITS_TOL
