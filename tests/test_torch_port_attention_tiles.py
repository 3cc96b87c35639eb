"""Launch geometry of the kernels on csrc/attention_tile.cuh (K4-bwd, K9's
forward, K9-bwd) and csrc/attention_bwd.cuh (the long-row backward of
K5-bwd and K9-bwd), on the CPU: for every (S, block, head width) that
``nn/transformer.py:attention_route`` can send to K4 or K9, the spans
partition the row and hold exactly K4's pairs, a block's dynamic shared
memory fits the H100's 227 KB, the threads cover the work, and K9's
thresholds send the molecules' spans to the tile instances and code2's rows
of 513 and 1001 to the long forward and the long backward, whose
tiles and rank-ordered key chunks cover every (row, head, token) once. The
C entries check the same geometry before they launch
(``csrc/attention_packed.cu``, ``csrc/attention_smalls.cu``); the ctypes
signatures are held to those entries' parameter lists."""

import importlib
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from graphtrans_tpu_torch.nn.transformer import attention_route  # noqa: E402

ap = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                             "attention_packed")
asm = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                              "attention_smalls")

SMEM_MAX = 232448
WIDTHS = (33, 49, 98, 99, 128, 129, 256, 383, 384)
BLOCKS = (0, 33, 49, 64)
CASES = [(S, block) for S in WIDTHS for block in BLOCKS]
PARTIAL = [(100, 33), (98, 33), (129, 64), (20, 6)]   # S % block != 0
CSRC = Path(__file__).resolve().parents[1] / "graphtrans_tpu_torch" / "csrc"


def _k4_pairs(S, block):
    """K4's mask without the key padding: (i, j) meet iff they share a graph
    block (block 0: the row)."""
    grp = torch.arange(S) // block if block else torch.zeros(S, dtype=int)
    return grp[:, None] == grp[None, :]


def _check_spans(spans, S, block):
    assert spans[0][0] == 0 and spans[-1][1] == S
    assert all(a < b for a, b in spans)
    assert all(spans[k][1] == spans[k + 1][0] for k in range(len(spans) - 1))
    cover = torch.zeros(S, S, dtype=torch.int32)
    graph = torch.arange(S) // block if block else torch.zeros(S, dtype=int)
    for a, b in spans:
        cover[a:b, a:b] += 1
        assert graph[a:b].unique().numel() == 1   # one graph a span
    pairs = _k4_pairs(S, block)
    assert (cover[pairs] == 1).all()              # each pair in one span
    assert (cover[~pairs] == 0).all()             # and no other pair


def _check_launch(geo, B, S, nhead):
    spans = geo.spans
    width = spans[0][1] - spans[0][0]
    problems = B * len(spans) * nhead
    assert 0 < geo.smem <= SMEM_MAX
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 256
    assert geo.group >= 1 and geo.grid[0] * geo.group >= problems
    assert (geo.grid[0] - 1) * geo.group < problems   # no empty block
    if geo.instance in ("short", "tile"):
        assert geo.pad % 4 == 0 and width <= geo.pad < width + 4
        # a thread for each 4 x 4 micro-tile of the pair tile
        assert geo.threads >= min(256, geo.group * (geo.pad // 4) ** 2) - 31


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S,block", CASES + PARTIAL)
def test_k4_bwd_geometry(S, block, hd):
    B, nhead = 1366, 4
    geo = ap.dense_bwd_geometry(B, S, block, hd, nhead)
    _check_spans(geo.spans, S, block)
    _check_launch(geo, B, S, nhead)
    width = geo.spans[0][1] - geo.spans[0][0]
    assert geo.instance == ("short" if width <= 64 else "wide")
    if geo.instance == "wide":
        assert geo.threads == 256 and geo.group == 1 and geo.pad == 64
        assert geo.smem == ap.bwd_wide_bytes(width, hd)
    else:
        assert geo.smem == geo.group * ap.bwd_short_bytes(geo.pad, hd)
    assert len(geo.args()) == 8 and geo.args()[0] in (1, 2)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,block", CASES + PARTIAL + [(1001, 0), (513, 0)])
def test_k9_forward_geometry(S, block, hd):
    """(The variant, serving or training, does not move the geometry.)"""
    B, nhead = 4097, 4
    geo = asm.fwd_geometry(B, S, block, hd, nhead, True, 0.3)
    assert geo == asm.fwd_geometry(B, S, block, hd, nhead, False, 0.0)
    _check_spans(geo.spans, S, block)
    width = geo.spans[0][1] - geo.spans[0][0]
    if width <= asm.tile_max(hd):
        assert geo.instance == "tile"
        _check_launch(geo, B, S, nhead)
        assert geo.smem == geo.group * asm.fwd_tile_bytes(geo.pad, hd)
    else:
        assert geo.instance == "long" and geo.smem == ap.long_fwd_bytes(hd)
        assert geo.grid == (B, nhead, -(-S // 64)) and geo.threads == 128
    assert len(geo.args()) == 8


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S,block", CASES + PARTIAL + [(1001, 0), (513, 0)])
def test_k9_bwd_geometry(S, block, hd):
    """K9-bwd's instance by span width and head width: short up to 64
    tokens, wide up to 384 at hd 32 and 64, long otherwise (a block per
    (row, head, 64 tokens) of 256 threads)."""
    B, nhead = 4097, 4
    geo = asm.bwd_geometry(B, S, block, hd, nhead)
    _check_spans(geo.spans, S, block)
    width = geo.spans[0][1] - geo.spans[0][0]
    want = ("short" if width <= 64 else
            "wide" if width <= 384 and hd <= 64 else "long")
    assert geo.instance == want
    if want == "long":
        assert geo.grid == (B, nhead, -(-S // 64)) and geo.threads == 256
        assert geo.group == 1 and geo.pad == 64
        assert geo.smem == asm.long_bwd_bytes(hd) <= SMEM_MAX
    else:
        _check_launch(geo, B, S, nhead)
        assert geo == ap.dense_bwd_geometry(B, S, block, hd, nhead)
    assert len(geo.args()) == 8 and geo.args()[0] == {
        "short": 1, "wide": 2, "long": 3}[want]


def test_long_bwd_shared_memory():
    """The long backward's dk/dv kernel (the larger of the two) fits a block
    at every head width, and two blocks share an SM up to hd 64 (228 KB an
    SM, 1 KB of it reserved a block)."""
    assert [asm.long_bwd_bytes(hd) for hd in (32, 64, 128)] == [
        75328, 108096, 173632]
    assert all(2 * (asm.long_bwd_bytes(hd) + 1024) <= 228 * 1024
               for hd in (32, 64))
    assert asm.long_bwd_bytes(128) <= SMEM_MAX


def _rank_chunks(keep):
    """The long dk/dv kernel's chunks of a row: the accepted keys (a bool
    [S]) in token order, T = 64 at a time; chunk z is block z's."""
    idx = torch.nonzero(keep).flatten()
    return [idx[z:z + 64] for z in range(0, len(idx), 64)]


@pytest.mark.parametrize("S", [33, 64, 65, 129, 513, 1001])
@pytest.mark.parametrize("form", ["prefix_cls", "scattered", "none", "all"])
def test_long_bwd_launch_covers_every_row_head_and_tile(S, form):
    """Over the grid (B, H, ceil(S / 64)) of both long kernels: the query
    tiles [64z, 64z + 64) cover the row once; the valid keys fall into
    chunks by rank, each into exactly one block z < ceil(S / 64), and the
    padding keys into the positional tile of one block, which writes their
    zeros; every (row, head) pair of the grid is launched."""
    B, nhead = 3, 4
    gen = torch.Generator().manual_seed(S)
    gz = -(-S // 64)
    if S > 64:   # at hd 128 every row wider than 64 takes the long instance
        geo = asm.bwd_geometry(B, S, 0, 128, nhead)
        assert geo.instance == "long" and geo.grid == (B, nhead, gz)
    cover = torch.zeros(S, dtype=torch.int32)
    for z in range(gz):
        cover[64 * z:64 * z + 64] += 1
    assert (cover == 1).all()
    for _ in range(B):
        if form == "prefix_cls":
            keep = torch.arange(S) < int(torch.randint(1, S, (1,),
                                                       generator=gen))
            keep[-1] = True
        elif form == "scattered":
            keep = torch.rand(S, generator=gen) < 0.4
        else:
            keep = torch.full((S,), form == "all")
        chunks = _rank_chunks(keep)
        assert len(chunks) <= gz
        owner = torch.zeros(S, dtype=torch.int32)
        for c in chunks:
            assert 0 < len(c) <= 64
            owner[c] += 1
        for z in range(gz):      # block z's zeros for its padding keys
            pad = ~keep[64 * z:64 * z + 64]
            owner[64 * z:64 * z + 64][pad] += 1
        assert (owner == 1).all()


def test_k9_threshold_follows_shared_memory():
    """128 tokens at hd 32 and 64; at hd 128 the largest span whose Q, K, V
    and scores fit a block (112), as the JAX kernel's ~128."""
    assert [asm.tile_max(hd) for hd in (32, 64, 128)] == [128, 128, 112]
    assert asm.fwd_tile_bytes(112, 128) <= SMEM_MAX
    assert asm.fwd_tile_bytes(116, 128) > SMEM_MAX
    with pytest.raises(ValueError, match="statistics"):
        asm.fwd_geometry(4, 33, 0, 64, 4, False, 0.3)


@pytest.mark.parametrize("backend,S,block,instance", [
    ("smalls", 33, 0, "tile"), ("smalls", 49, 0, "tile"),
    ("packed_smalls", 99, 33, "tile"), ("packed_smalls", 98, 49, "tile"),
    ("packed_smalls", 128, 64, "tile"), ("smalls", 1001, 0, "long"),
    ("smalls", 513, 0, "long")])
def test_k9_routes_take_the_tile_instance_at_molecule_shapes(backend, S,
                                                             block,
                                                             instance):
    """The molecules' rows (smalls: 33, 49 with CLS; packed_smalls: rows of
    three 33- or two 49-token graphs) reach K9 and its tile instance;
    code2's rows of 513 and 1001 its long one."""
    assert attention_route(backend, S, 256, block) == "k9"
    assert asm.fwd_geometry(64, S, block, 64, 4, True, 0.3).instance == (
        instance)


@pytest.mark.parametrize("backend,S,block,instance", [
    ("smalls", 33, 0, "short"), ("smalls", 49, 0, "short"),
    ("packed_smalls", 99, 33, "short"), ("packed_smalls", 98, 49, "short"),
    ("packed_smalls", 128, 64, "short"), ("smalls", 1001, 0, "long"),
    ("smalls", 513, 0, "long"), ("smalls", 257, 0, "wide")])
def test_k9_routes_take_the_short_backward_at_molecule_shapes(backend, S,
                                                              block,
                                                              instance):
    """The molecules' rows under smalls and packed_smalls take K9-bwd's
    short instance; code2's rows of 513 and 1001 its long one, and rows cut
    to 257 its wide one."""
    assert attention_route(backend, S, 256, block) == "k9"
    assert asm.bwd_geometry(64, S, block, 64, 4).instance == instance


@pytest.mark.parametrize("backend,S,block", [
    ("auto", 99, 33), ("auto", 98, 49), ("auto", 128, 64),
    ("packed_fused", 99, 33), ("auto", 129, 0), ("auto", 256, 0),
    ("auto", 384, 0)])
def test_k4_routes_reach_both_backward_instances(backend, S, block):
    """Packed molecule rows take the short backward, code2's unpacked rows
    of 129-384 (block 0) the wide one."""
    assert attention_route(backend, S, 256, block) == "k4"
    geo = ap.dense_bwd_geometry(8, S, block, 64, 4)
    assert geo.instance == ("short" if block else "wide")


def test_graph_packed_rows_hold_whole_blocks():
    """attention_route's packed rows hold gb = 128 // S graphs of S tokens,
    so S * gb % S == 0: K4 and K9 see partial last blocks only when a
    caller passes them, and both geometries take them (PARTIAL above)."""
    for S in range(2, 65):
        gb = 128 // S
        if gb >= 2:
            spans = ap.row_spans(gb * S, S)
            assert len(spans) == gb and all(b - a == S for a, b in spans)


@pytest.mark.parametrize("n", [1, 64, 65, 128, 129, 384])
def test_k2_geometry_by_segment_length(n):
    """K2's launches on rows as wide as a segment of n tokens: rows of up
    to 128 tokens (every molecule, NCI1 and code2 128-tier row, so every
    segment of up to 128 tokens) take the tile instance, a block of 256
    (forward) or 512 threads (backward) per (row, head); wider rows the
    long forward and the long-row pair, by 64-token tiles. Shared memory
    fits the H100's 227 KB."""
    R, nhead, hd = 923, 4, 32
    fwd = ap.seg_fwd_geometry(R, n, hd, nhead)
    bwd = ap.seg_bwd_geometry(R, n, hd, nhead)
    want = "tile" if n <= 128 else "long"
    assert ap.seg_instance(n) == fwd.instance == bwd.instance == want
    for geo in (fwd, bwd):
        assert 0 < geo.smem <= SMEM_MAX
        assert geo.threads % 32 == 0 and geo.group == 1
        if want == "tile":
            assert geo.grid == (R * nhead, 1, 1)
            assert geo.threads == (512 if geo is bwd else 256)
            assert geo.pad == -(-n // 4) * 4
        else:
            assert geo.grid == (R, nhead, -(-n // 64)) and geo.pad == 64
    if want == "tile":
        assert fwd.smem == ap.seg_tile_bytes(n, hd, False)
        assert bwd.smem == ap.seg_tile_bytes(n, hd, True)
    else:
        assert fwd == ap.long_fwd_geometry(R, n, hd, nhead)
        assert bwd.smem == asm.long_bwd_bytes(hd) and bwd.threads == 256
    assert ap.seg_tile_bytes(128, hd, True) <= SMEM_MAX   # the widest tile


def test_k2_score_tiles_fit_their_bound():
    """The tile instance sizes its score tiles for the worst split of a
    row: the sum over segments of pad x seg_sld(pad), pad = n rounded up
    to 4, is at most seg_score_floats(W) for every split of W <= 128 tokens
    into segments (exhaustive up to W 14, then the extremes and random
    splits); each tile's rows hold an odd number of float4."""
    gen = torch.Generator().manual_seed(0)
    r4 = lambda n: -(-n // 4) * 4
    need = lambda parts: sum(r4(n) * ap.seg_sld(r4(n)) for n in parts)

    def splits(W):
        if W == 0:
            yield []
            return
        for first in range(1, W + 1):
            for rest in splits(W - first):
                yield [first] + rest

    assert all(ap.seg_sld(p) % 8 == 4 and ap.seg_sld(p) >= p + 4
               for p in range(4, 129, 4))
    for W in range(1, 15):
        for parts in splits(W):
            assert need(parts) <= ap.seg_score_floats(W)
    for W in range(15, 129):
        cases = [[W], [1] * W, [W - 2, 2], [W - 1, 1], [4] * (W // 4)]
        for _ in range(50):
            k = int(torch.randint(1, W, (1,), generator=gen))
            cut = torch.randperm(W - 1, generator=gen)[:k].sort().values + 1
            edges = [0] + cut.tolist() + [W]
            cases.append([b - a for a, b in zip(edges, edges[1:])])
        for parts in cases:
            assert need(parts) <= ap.seg_score_floats(W)


def _c_params(source: str, entry: str) -> int:
    text = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                    re.S)
    return len(sig.group(1).split(","))


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """The argtypes each wrapper sets (no card needed) have as many entries
    as the C function has parameters."""
    from graphtrans_tpu_torch.ops.kernels import _build

    def fake(name):
        lib = types.SimpleNamespace()
        for fn in ("attention_seg_fwd", "attention_seg_bwd",
                   "attention_dense_fwd", "attention_dense_bwd",
                   "attention_smalls_fwd", "attention_smalls_bwd",
                   "flash_attention_fwd", "flash_attention_bwd"):
            setattr(lib, fn, types.SimpleNamespace(argtypes=None))
        return lib

    monkeypatch.setattr(_build, "load", fake)
    fa = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                                 "flash_attention")
    packed, smalls, flash = ap._load(), asm._load(), fa._load()
    for lib, source, entry in (
            (packed, "attention_packed.cu", "attention_dense_bwd"),
            (packed, "attention_packed.cu", "attention_dense_fwd"),
            (packed, "attention_packed.cu", "attention_seg_fwd"),
            (packed, "attention_packed.cu", "attention_seg_bwd"),
            (smalls, "attention_smalls.cu", "attention_smalls_fwd"),
            (smalls, "attention_smalls.cu", "attention_smalls_bwd"),
            (flash, "flash_attention.cu", "flash_attention_fwd"),
            (flash, "flash_attention.cu", "flash_attention_bwd")):
        assert len(getattr(lib, entry).argtypes) == _c_params(source,
                                                              entry), entry
