"""The forward launches of K4, K5 and K9 on the CPU, and the long-row
forward's algorithm (``csrc/attention_fwd.cuh``) emulated step by step in
PyTorch against the plain versions.

``dense_fwd_geometry`` sends every span of up to ``tile_max(hd)`` tokens to
the whole-span tile forward (``csrc/attention_tile.cuh``) and wider ones to
the long forward; K5's and K9's long launches are a block of 256 threads
per (row, head, 64 queries) whose shared bytes fit the H100. The emulation
follows the kernel's order of work: a 64-query tile, the keys whose tag
meets one of the tile's query tags ranked in token order and taken 64 at a
time, each chunk's scores masked to -inf where a pair does not meet, the
running max starting at a finite sentinel, the rescale alpha, l summing the
undropped probabilities and O the kept ones. It holds that order to the
plain versions' output (and their log-sum-exp for m and l), both in
float64, with key padding, segment tags, K4's graph blocks, rows without a
key and dropout."""

import importlib
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from graphtrans_tpu_torch.nn.transformer import attention_route  # noqa: E402

ap = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                             "attention_packed")
asm = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                              "attention_smalls")
fa = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                             "flash_attention")
fh = importlib.import_module("graphtrans_tpu_torch.ops.kernels.flash_hil")
CSRC = Path(__file__).resolve().parents[1] / "graphtrans_tpu_torch" / "csrc"

SMEM_MAX = 232448
ALGO_TOL = 1e-9    # both sides in float64: sums in another order
T = 64             # queries a tile, keys a chunk
M0 = -1e30         # the running max before the first key


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("block", [0, 33, 49])
@pytest.mark.parametrize("S", [33, 49, 98, 99, 128, 129, 257, 384])
def test_k4_forward_geometry_picks_tile_or_long(S, block, hd):
    """The tile instance for every span of up to 128 tokens, the long one
    above; the variant (serving, training) does not move the launch."""
    B, nhead = 1366, 4
    geo = ap.dense_fwd_geometry(B, S, block, hd, nhead, True, 0.3)
    assert geo == ap.dense_fwd_geometry(B, S, block, hd, nhead, False, 0.0)
    width = geo.spans[0][1] - geo.spans[0][0]
    assert width == (block if 0 < block < S else S)
    if width <= 128:
        assert geo.instance == "tile" and geo.args()[0] == 1
        assert geo.pad == -(-width // 4) * 4
        assert geo.smem == geo.group * ap.fwd_tile_bytes(geo.pad, hd)
        assert 0 < geo.smem <= SMEM_MAX
        assert geo.grid[0] * geo.group >= B * len(geo.spans) * nhead
    else:
        assert geo.instance == "long" and geo.args()[0] == 3
        assert geo.grid == (B, nhead, -(-S // T)) and geo.threads == 128
        assert geo.group == 1 and geo.pad == T
        assert geo.smem == ap.long_fwd_bytes(hd)
    assert len(geo.args()) == 8


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [513, 1001])
def test_long_forward_launch_of_k5_and_k9(S, hd):
    """K5's and K9's forward at code2's rows: the long instance, a block of
    128 threads (four warps of 16 queries) per (row, head, 64 queries), the
    row one span."""
    B, nhead = 513, 4
    k5 = ap.long_fwd_geometry(B, S, hd, nhead)
    k9 = asm.fwd_geometry(B, S, 0, hd, nhead, True, 0.3)
    assert k5 == k9
    assert k5.instance == "long" and k5.spans == ((0, S),)
    assert k5.grid == (B, nhead, -(-S // T)) and k5.threads == 128
    assert k5.smem == ap.long_fwd_bytes(hd) <= SMEM_MAX
    assert k5.args() == (3, T, 1, B, nhead, -(-S // T), 128, k5.smem)


def test_long_forward_shared_memory():
    """Q, the K/V buffers and the warps' P tiles: one buffer up to hd 64,
    so four blocks share an SM at hd 32 and three at hd 64 (228 KB, 1 KB
    of it reserved a block); at hd 128 one block fits with two buffers, and
    would with one."""
    sizes = [ap.long_fwd_bytes(hd) for hd in (32, 64, 128)]
    assert sizes == [45856, 70432, 187680]
    assert [228 * 1024 // (b + 1024) for b in sizes] == [4, 3, 1]
    assert max(sizes) <= SMEM_MAX
    single = ap.long_fwd_bytes(128) - 4 * 2 * T * (128 + 4 + 1)
    assert 228 * 1024 // (single + 1024) == 1


@pytest.mark.parametrize("W", [512, 1024, 1536])
def test_k3_forward_launch_is_the_long_forward(W):
    """K3's forward at code2's tiers of 512 and 1024 and at a wider row: the
    long forward's launch at hd 32, a block of 128 threads (four warps of
    16 queries) per (row, head, 64 queries), four blocks' shared memory an
    SM; its f32 C entry launches only flash_hil_fwd_long_kernel, after
    attn::long_fwd_launch_ok (the bf16 entry its own kernel, after
    attn::fwd16_launch_ok, at long16_fwd_geometry's launch), and the
    per-query kernel it replaced is gone."""
    R, nhead = 15, 4
    geo = fh.fwd_geometry(R, W, nhead)
    assert geo == ap.long_fwd_geometry(R, W, 32, nhead)
    assert geo.instance == "long" and geo.spans == ((0, W),)
    assert geo.grid == (R, nhead, -(-W // T)) and geo.threads == 128
    assert geo.smem == ap.long_fwd_bytes(32) <= SMEM_MAX
    assert 228 * 1024 // (geo.smem + 1024) == 4
    assert geo.args() == (3, T, 1, R, nhead, -(-W // T), 128, geo.smem)
    src = (CSRC / "flash_hil.cu").read_text()
    assert "attn::long_fwd_launch_ok(L, R, W, H, 32)" in src
    assert "attn::long_fwd<HD, DROP, STATS>" in src
    assert src.count("<<<") == 2 and "flash_hil_fwd_long_kernel" in src
    assert "flash_hil_fwd_bf16_kernel" in src
    assert "attn::fwd16_launch_ok(L, R, W, H, false)" in src
    assert (fh.fwd_geometry(R, W, nhead, torch.bfloat16)
            == ap.long16_fwd_geometry(R, W, nhead, False))
    for gone in ("flash_hil_fwd_kernel", "block_range", " BQ = ", " BK = "):
        assert gone not in src


@pytest.mark.parametrize("d,nhead", [(128, 2), (256, 4), (96, 4)])
def test_k3_refuses_other_head_widths(d, nhead):
    """K3 is built for heads of width 32: its launch path raises on any
    other before it reaches the card."""
    qkv = torch.zeros(1, 512, 3 * d)
    seg = torch.zeros(1, 512, dtype=torch.int32)
    with pytest.raises(ValueError, match="head width"):
        fh.flash_hil_seg_with_stats(qkv, seg, nhead)


@pytest.mark.parametrize("backend,S,block", [
    ("auto", 98, 49), ("auto", 99, 33), ("packed_fused", 99, 33),
    ("packed_layer", 99, 33), ("packed_layer", 98, 49), ("auto", 128, 64)])
def test_molecule_k4_launches_take_the_tile_forward(backend, S, block):
    """Every K4 forward of the molecule paths (rows of 2 x 49 and 3 x 33
    tokens, and K10's layer on them) takes the tile instance at d 256, 4
    heads of 64."""
    assert attention_route(backend, S, 256, block) in ("k4", "k10")
    assert ap.dense_fwd_geometry(1366, S, block, 64, 4, True,
                                 0.3).instance == "tile"


# ---- the long forward, emulated -------------------------------------------


def _long_fwd(qkv, qtag, ktag, nhead, keep=None, rate=0.0):
    """out [B, S, d], m and l [B, S, H] as csrc/attention_fwd.cuh computes
    them: per (row, head, 64-query tile) the keys of the row whose tag
    meets the tile's tags, in rank order, 64 a chunk. ``keep`` (bool [B, H,
    S, S]) is the dropout mask at ``rate``."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, v = qkv.split(d, dim=-1)
    out = torch.zeros(B, S, d, dtype=torch.float64)
    m_out = torch.zeros(B, S, nhead, dtype=torch.float64)
    l_out = torch.zeros_like(m_out)
    inv_keep = 1.0 / (1.0 - rate)
    for b in range(B):
        for h in range(nhead):
            cs = slice(h * hd, (h + 1) * hd)
            for q0 in range(0, S, T):
                qt = qtag[b, q0:q0 + T]
                n = len(qt)
                m = torch.full((n,), M0, dtype=torch.float64)
                l = torch.zeros(n, dtype=torch.float64)
                acc = torch.zeros(n, hd, dtype=torch.float64)
                live = qt[qt >= 0]
                if len(live):
                    kt_all = ktag[b]
                    sel = (kt_all >= live.min()) & (kt_all <= live.max())
                    ranked = torch.nonzero(sel).flatten()
                    for r0 in range(0, len(ranked), T):
                        kix = ranked[r0:r0 + T]
                        kt = kt_all[kix]
                        s = q[b, q0:q0 + n, cs] @ k[b, kix, cs].T
                        s = s / math.sqrt(hd)
                        meet = (qt[:, None] >= 0) & (qt[:, None]
                                                     == kt[None, :])
                        s = s.masked_fill(~meet, -math.inf)
                        mn = torch.maximum(m, s.max(-1).values)
                        alpha = torch.exp(m - mn)
                        e = torch.exp(s - mn[:, None])
                        l = l * alpha + e.sum(-1)
                        if keep is not None:
                            e = e * keep[b, h, q0:q0 + n][:, kix]
                        acc = acc * alpha[:, None] + e @ v[b, kix, cs]
                        m = mn
                scale = (inv_keep if keep is not None else 1.0) / l.clamp_min(
                    1e-16)
                out[b, q0:q0 + n, cs] = acc * scale[:, None]
                m_out[b, q0:q0 + n, h] = torch.where(l > 0, m, -math.inf)
                l_out[b, q0:q0 + n, h] = l
    return out, m_out, l_out


def _lse_ref(qkv, qtag, ktag, nhead):
    """(max, sum of exp(s - max)) of each query's attended scores, and
    whether it has a key, from the whole masked score matrix."""
    B, S, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    q, k, _ = (t.reshape(B, S, nhead, hd).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    s = q @ k.transpose(-1, -2) / math.sqrt(hd)                 # [B, H, S, S]
    meet = ((qtag[:, :, None] == ktag[:, None, :])
            & (ktag >= 0)[:, None, :])[:, None]
    s = s.masked_fill(~meet, -math.inf)
    mx = s.max(-1).values
    has = meet.any(-1).expand_as(mx)
    lsum = torch.exp(s - torch.where(has, mx, 0.0)[..., None]).sum(-1)
    return mx.transpose(1, 2), lsum.transpose(1, 2), has.transpose(1, 2)


def _check_stats(m, l, qkv, qtag, ktag, nhead):
    mx, lsum, has = _lse_ref(qkv, qtag, ktag, nhead)
    assert torch.allclose(m[has], mx[has], atol=1e-9, rtol=0)
    assert torch.allclose(l[has], lsum[has], atol=1e-9, rtol=1e-12)
    assert (m[~has] == -math.inf).all() and (l[~has] == 0).all()


def _qkv(B, S, d, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, 3 * d, generator=gen, dtype=torch.float64) * 2


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S", [129, 200, 257])
def test_long_forward_matches_k4_on_wide_spans(S, rate):
    """K4's wide spans (block 0) under PadTags: every query, padding queries
    too, attends the row's valid keys; a row without one gives zeros."""
    B, d, H, seed = 3, 64, 2, 2**31 - 5
    qkv = _qkv(B, S, d, S)
    gen = torch.Generator().manual_seed(S + 1)
    valid = torch.rand(B, S, generator=gen) < 0.5
    valid[:, -1] = True
    valid[1] = False
    qtag = torch.zeros(B, S, dtype=torch.long)
    ktag = torch.where(valid, 0, -1)
    keep = (ap.keep_mask(B, S, H, rate, seed, "cpu") if rate else None)
    got, m, l = _long_fwd(qkv, qtag, ktag, H, keep, rate)
    want = ap.attention_dense_plain(qkv, valid, H, 0, rate, seed)
    assert (got - want).abs().max().item() <= ALGO_TOL
    assert not got[1].any() and (got[0].abs().sum(-1) > 0).all()
    _check_stats(m, l, qkv, qtag, ktag, H)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("form", ["key_padding", "seg"])
def test_long_forward_matches_k5(form, rate):
    """K5's two tag forms at a row of 300 (five query tiles, the last
    partial): graph rows whose valid keys are a prefix plus the CLS column,
    a fully masked row; segments whose keys span several chunks and tiles,
    padding queries (seg -1) with zero output."""
    B, S, d, H, seed = 3, 300, 64, 2, 123456789
    qkv = _qkv(B, S, d, 7)
    if form == "key_padding":
        valid = torch.zeros(B, S, dtype=torch.bool)
        valid[0, :150] = True
        valid[2, :40] = True
        valid[[0, 2], -1] = True
        segq, segk = fa.key_padding_segs(valid)
    else:
        seg = torch.full((B, S), -1, dtype=torch.int32)
        seg[0, :70], seg[0, 70:250] = 0, 1
        seg[1, 5:290] = 4
        segq = segk = seg
    keep = (fa.tile_keep_mask(torch.arange(B), S, H, rate, seed)
            if rate else None)
    got, m, l = _long_fwd(qkv, segq.long(), segk.long(), H, keep, rate)
    want = fa.flash_attention_plain(qkv, segq, segk, H, rate, seed)
    assert (got - want).abs().max().item() <= ALGO_TOL
    live = ((segq[:, :, None] == segk[:, None, :])
            & (segk >= 0)[:, None, :]).any(-1)
    assert not got[~live].any() and (got[live].abs().sum(-1) > 0).all()
    _check_stats(m, l, qkv, segq.long(), segk.long(), H)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("S,block", [(300, 150), (513, 0), (400, 130)])
def test_long_forward_matches_k9(S, block, rate):
    """K9's long instance: code2's rows of 513 and graph blocks wider than
    tile_max (150, and 130 with a partial last block) under PadTags, one
    block without a valid key, with K9's dropout schedule."""
    B, d, H, seed = 3, 64, 2, 99
    assert asm.fwd_geometry(B, S, block, d // H, H, True,
                            0.3).instance == "long"
    qkv = _qkv(B, S, d, S + block)
    gen = torch.Generator().manual_seed(S)
    valid = torch.rand(B, S, generator=gen) < 0.4
    width = block or S
    valid[1, :width] = False
    grp = torch.arange(S) // block if block else torch.zeros(S,
                                                             dtype=torch.long)
    qtag = grp.expand(B, S)
    ktag = torch.where(valid, grp, -1)
    keep = (asm.keep_mask(torch.arange(B), S, H, rate, seed)
            if rate else None)
    got, m, l = _long_fwd(qkv, qtag, ktag, H, keep, rate)
    want = asm.attention_smalls_plain(qkv, valid, H, block, rate, seed)
    assert (got - want).abs().max().item() <= ALGO_TOL
    assert not got[1, :width].any()
    _check_stats(m, l, qkv, qtag, ktag, H)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_long_forward_matches_k3(rate):
    """K3 on the long forward (seg as both tags) at code2's tier of 512: a
    segment of 400 tokens (seven query tiles, seven key chunks), single
    tokens, padding tails, an all-padding row, one graph id in two runs,
    with K3's 512 x 128 dropout schedule: the plain version's output, m
    and l their log-sum-exp, padding queries exactly 0."""
    B, S, d, H, seed = 3, 512, 64, 2, 2**31 - 9
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :400], seg[0, 400], seg[0, 401:465] = 0, 1, 2
    seg[2, :100], seg[2, 100:300], seg[2, 300:390] = 5, 6, 5
    qkv = _qkv(B, S, d, 15)
    keep = fh.flash_hil_keep_mask(B, S, H, rate, seed) if rate else None
    got, m, l = _long_fwd(qkv, seg.long(), seg.long(), H, keep, rate)
    want = fh.flash_hil_seg_plain(qkv, seg, H, rate, seed)
    assert (got - want).abs().max().item() <= ALGO_TOL
    assert not got[seg < 0].any() and (got[seg >= 0].abs().sum(-1) > 0).all()
    _check_stats(m, l, qkv, seg.long(), seg.long(), H)


def test_first_chunk_without_a_key_changes_nothing():
    """A chunk that holds no key a query meets (its segment's keys come
    later by rank) leaves the query's m at the sentinel, its l at 0 and its
    accumulator at 0: alpha is 1, and no NaN reaches a later chunk."""
    B, S, d, H = 1, 200, 32, 1
    seg = torch.zeros(B, S, dtype=torch.long)
    seg[0, 100:] = 1            # the tile of queries 64-127 meets both tags
    qkv = _qkv(B, S, d, 3)
    got, m, l = _long_fwd(qkv, seg, seg, H)
    assert torch.isfinite(got).all()
    want = fa.flash_attention_plain(qkv, seg.int(), seg.int(), H)
    assert (got - want).abs().max().item() <= ALGO_TOL
    _check_stats(m, l, qkv, seg, seg, H)
