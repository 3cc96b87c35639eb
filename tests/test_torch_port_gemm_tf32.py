"""K10's product (csrc/transformer_layer.cu:layer_gemm) and K3-bwd's launch,
on the CPU.

(a) The product runs as 3xTF32 mma.sync on the tensor cores: each operand
is split into a TF32 high part and a TF32 remainder (``cvt.rna``: round to
nearest, ties away from zero), and lo*hi, hi*lo and hi*hi are summed eight
k at a time, in the kernel's k order, into a 32-deep slice's tiles that
f32 adds carry into the accumulators. A numpy emulation of that
arithmetic (the tensor cores' adds modelled as truncating) is held against
a float64 product at K10's depths and value ranges: its error stays within
4x a plain float32 product's error on the same operands, while
single-pass TF32 misses the same check by orders of magnitude (so the
check tells the two apart).
(b) ``gemm_geometry`` mirrors the C launch; every product K10's forward and
backward chains launch at the bench and snapshot shapes fits a block's
shared memory, keeps two blocks an SM, covers C, and meets the alignment
the C entry demands. (c) K3-bwd launches the long-row backward
(``attn::launch_long_bwd<32>``) on the grid that the Python geometry
helpers give. No card is needed."""

import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

tl = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                             "transformer_layer")
fh = importlib.import_module("graphtrans_tpu_torch.ops.kernels.flash_hil")
asm = importlib.import_module("graphtrans_tpu_torch.ops.kernels."
                              "attention_smalls")

CSRC = Path(__file__).resolve().parents[1] / "graphtrans_tpu_torch" / "csrc"
SMEM_MAX = 232448
K2_TOL, GRAD_TOL = 2e-5, 5e-4   # chip_smoke.py's K10 and K10-bwd bounds
FACTOR = 4                       # 3xTF32's error against plain f32's


def _rna(x):
    """float32 -> TF32 (10 mantissa bits) as the device's cvt.rna rounds:
    to nearest, ties away from zero (add half an ulp to the magnitude)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _rna(x)
    return hi, _rna((np.asarray(x, np.float32) - hi).astype(np.float32))


def _rz(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    away = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(away, np.nextafter(f, np.float32(0)), f)


def _emulate(a, b, passes: int = 3, promote: bool = True):
    """C = a [M, K] @ b [K, N] as the kernel sums it. Per 8 k (one m16n8k8
    mma) c += al bh, c += ah bl, c += ah bh (3xTF32, tc::mma3), or c += ah
    bh alone (single-pass TF32). An mma's eight products of TF32 values are
    exact, and it adds them and c without rounding: modelled as their exact
    sum truncated toward zero to f32 (the tensor cores align their terms
    and drop the bits below the largest one's last place). With
    ``promote`` each 32-deep slice sums into tiles of its own, added to the
    accumulator with a rounded f32 add, as layer_gemm does; without it
    every mma lands on the running sum."""
    ah, al = _split(a)
    bh, bl = _split(b)
    pairs = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    pairs = [(x.astype(np.float64), y.astype(np.float64)) for x, y in pairs]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for s0 in range(0, a.shape[1], 32):
        c = np.zeros_like(acc) if promote else acc
        for k0 in range(s0, min(a.shape[1], s0 + 32), 8):
            for x, y in pairs:
                c = _rz(c + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        acc = (acc + c).astype(np.float32) if promote else c
    return acc


def _weight_grad(g, x, passes: int = 3):
    """dW = g^T x as _weight_grad launches it: layout 2 split over the rows
    into partials of gemm_geometry's kchunk, summed in order in f32
    (layer_sum)."""
    K, M = g.shape
    N = x.shape[1]
    tiles = -(-N // 128) * -(-M // 128)
    splits = max(1, min(-(-tl.BLOCKS_SM // tiles), -(-K // 256)))
    kchunk = tl.gemm_geometry(M, N, K, tl.TN, splits)[3]
    out = np.zeros((M, N), np.float32)
    for k0 in range(0, K, kchunk):
        out = (out + _emulate(g[k0:k0 + kchunk].T, x[k0:k0 + kchunk],
                              passes)).astype(np.float32)
    return out


# K10's products at [*, *, 256], ff 512: (name, rows of A, K, N, A's and
# B's value ranges). Activations are LayerNorm outputs and attention mixes
# (~N(0, 1)); weights nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) or
# in_proj's xavier U(-sqrt(6/(d+3d)), ...); cotangents ~N(0, 1e-3^2).
def _case(name, rng):
    d, ff = 256, 512
    act = lambda rows, k: rng.standard_normal((rows, k)).astype(np.float32)
    lin = lambda k, n, bound: rng.uniform(-bound, bound, (k, n)).astype(
        np.float32)
    grad = lambda rows, k: (1e-3 * rng.standard_normal((rows, k))).astype(
        np.float32)
    return {
        "qkv K 256": (act(96, d), lin(d, 96, (6 / (4 * d)) ** 0.5)),
        "FF1 K 256": (act(96, d), lin(d, 96, d ** -0.5)),
        "FF2 K 512": (np.maximum(act(96, ff), 0), lin(ff, 96, ff ** -0.5)),
        "dx K 768": (grad(96, 3 * d), lin(3 * d, 96, (6 / (4 * d)) ** 0.5)),
    }[name]


@pytest.mark.parametrize("name", ["qkv K 256", "FF1 K 256", "FF2 K 512",
                                  "dx K 768"])
def test_3xtf32_keeps_f32_accuracy_at_k10_depths(name):
    """At K10's depths the emulated 3xTF32 product's largest error is
    within FACTOR x that of numpy's float32 product on the same operands,
    and single-pass TF32's is more than 100 x it; without the slices' f32
    adds the truncating mma would cost more. Why FACTOR keeps the
    kernel inside chip_smoke.py's bounds: the kernel and the plain layer
    (torch's f32 product) then differ by at most (FACTOR + 1) x the f32
    error, which at these ranges is a few 1e-7 of outputs of order 1 (the
    forward's LayerNorms divide by a sigma near 1): well under K2_TOL =
    2e-5 forward, and under a hundredth of GRAD_TOL's 5e-4 of max(1,
    max|ref|) for the gradients' products."""
    a, b = _case(name, np.random.default_rng(len(name)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err_f32 = np.abs((a @ b).astype(np.float64) - ref).max()
    err_3x = np.abs(_emulate(a, b).astype(np.float64) - ref).max()
    err_1x = np.abs(_emulate(a, b, 1).astype(np.float64) - ref).max()
    err_run = np.abs(_emulate(a, b, promote=False).astype(np.float64)
                     - ref).max()
    assert err_3x <= FACTOR * err_f32, (err_3x, err_f32)
    assert err_1x > 100 * FACTOR * err_f32, (err_1x, err_f32)
    assert err_run > err_3x   # every mma truncating onto the running sum
    scale = max(1.0, np.abs(ref).max())
    assert (FACTOR + 1) * err_f32 <= (K2_TOL if name[0] != "d"
                                      else GRAD_TOL / 100) * scale


@pytest.mark.parametrize("rows", [2048, 4100])
def test_3xtf32_weight_gradient_reduction(rows):
    """A weight gradient's reduction over a batch's rows (cut to a few
    thousand), split into partials as _weight_grad launches it and summed
    in order: 3xTF32 within FACTOR x float32's error, single-pass TF32 far
    outside it."""
    rng = np.random.default_rng(rows)
    g = (1e-3 * rng.standard_normal((rows, 128))).astype(np.float32)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    ref = g.T.astype(np.float64) @ x.astype(np.float64)
    err_f32 = np.abs((g.T @ x).astype(np.float64) - ref).max()
    err_3x = np.abs(_weight_grad(g, x).astype(np.float64) - ref).max()
    err_1x = np.abs(_weight_grad(g, x, 1).astype(np.float64) - ref).max()
    assert err_3x <= FACTOR * err_f32, (err_3x, err_f32)
    assert err_1x > 100 * FACTOR * err_f32, (err_1x, err_f32)
    assert (FACTOR + 1) * err_f32 <= GRAD_TOL / 100 * max(
        1.0, np.abs(ref).max())


def test_tf32_rounding_is_to_nearest_ties_away():
    """_rna against exact cases: 1 + 2^-11 (a tie) rounds up to 1 + 2^-10,
    -(1 + 2^-11) to -(1 + 2^-10), 1 + 2^-12 down to 1; hi + lo splits x to
    within 2^-22 of |x|."""
    x = np.array([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 3.0], np.float32)
    assert _rna(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 3.0]
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi, lo = _split(v)
    assert (np.abs(hi.astype(np.float64) + lo - v) <= 2**-22 * np.abs(v)
            ).all()


def _record_products(monkeypatch, B, S, d, ff, nhead, block):
    """Runs K10's forward and backward chains on meta tensors and returns
    each layer_gemm launch as (M, N, K, layout, splits, epi)."""
    calls = []

    def gemm(lib, a, b, M, N, K, layout, epi=tl.EPI_NONE, bias=None,
             res=None, drop=tl._NO_DROP, splits=1):
        calls.append((M, N, K, layout, splits, epi))
        return torch.empty((splits, M, N) if splits > 1 else (M, N),
                           device="meta")

    ok = lambda *args: 0
    lib = types.SimpleNamespace(layer_norm_fwd=ok, layer_norm_bwd=ok,
                                layer_colsum=ok, layer_sum=ok)
    meta = lambda *shape: torch.empty(*shape, device="meta")
    monkeypatch.setattr(tl, "_gemm", gemm)
    monkeypatch.setattr(tl, "_load", lambda: lib)
    monkeypatch.setattr(tl, "_stream", lambda t: None)
    monkeypatch.setattr(tl, "dense_fwd_launch", lambda qkv, *a, **k: (
        meta(B, S, d), meta(B, S, nhead), meta(B, S, nhead)))
    monkeypatch.setattr(tl, "dense_bwd_launch",
                        lambda qkv, *a, **k: meta(B, S, 3 * d))
    shapes = ((3 * d, d), (3 * d,), (d, d), (d,), (d,), (d,), (ff, d),
              (ff,), (d, ff), (d,), (d,), (d,))
    params = [meta(*s) for s in shapes]
    x, valid = meta(B, S, d), torch.empty(B, S, dtype=torch.bool,
                                          device="meta")
    _, saved = tl._forward(x, valid, params, nhead, block, 0.3, 5, save=True)
    forward = list(calls)
    tl._backward(x, valid, params, nhead, block, 0.3, 5, meta(B, S, d), saved)
    return forward, calls[len(forward):]


@pytest.mark.parametrize("B,S,block", [(1366, 99, 33), (128, 98, 49)])
def test_gemm_geometry_of_every_k10_product(monkeypatch, B, S, block):
    """Each product of K10 at the bench's [1366, 99, 256] and the
    snapshot's rows of 98, ff 512: the grid covers C with no empty tile
    row or column, the splits cover K, the stages fit a block's dynamic
    shared memory and leave two blocks an SM, and the row lengths meet
    the C entry's 16-byte cp.async alignment. The forward runs four
    products in layout 0; the backward four in layout 1 and four weight
    gradients in layout 2, split over the rows."""
    d, ff, M = 256, 512, B * S
    fwd, bwd = _record_products(monkeypatch, B, S, d, ff, 4, block)
    assert [c[:4] for c in fwd] == [(M, 3 * d, d, tl.NT), (M, d, d, tl.NT),
                                    (M, ff, d, tl.NT), (M, d, ff, tl.NT)]
    assert sorted(c[3] for c in bwd) == [tl.NN] * 4 + [tl.TN] * 4
    for M_, N, K, layout, splits, _ in fwd + bwd:
        grid, threads, smem, kchunk, blocks = tl.gemm_geometry(
            M_, N, K, layout, splits)
        assert threads == 128 and smem <= SMEM_MAX and blocks == 2
        assert grid[0] * 64 >= N > (grid[0] - 1) * 64
        assert grid[1] * 128 >= M_ > (grid[1] - 1) * 128
        assert grid[2] == splits and kchunk % 32 == 0
        assert splits * kchunk >= K   # a split past K writes zeros
        assert N % 4 == 0 and (M_ if layout == tl.TN else K) % 4 == 0
        if layout == tl.TN:   # a weight gradient: the batch's rows split
            assert K == M and splits > 1 and (M_, N) in {
                (3 * d, d), (d, d), (ff, d), (d, ff)}


def test_gemm_geometry_shared_bytes():
    """Three stages of a 128-row A tile and a 64-column B tile: 90 KB in
    layout 0 (both tiles' rows along K, 40 floats), less where a tile's
    rows are K (32 rows of 132 or 68 floats); two blocks an SM in every
    layout (228 KB an SM, 1 KB of it reserved a block)."""
    got = [tl.gemm_geometry(1000, 256, 512, layout, 1)[2]
           for layout in (tl.NT, tl.NN, tl.TN)]
    assert got == [92160, 87552, 76800]
    assert all(2 * (b + 1024) <= 228 * 1024 for b in got)
    assert all(tl.gemm_geometry(1000, 256, 512, layout, 1)[4] == 2
               for layout in (tl.NT, tl.NN, tl.TN))


@pytest.mark.parametrize("W", [1024, 1001, 448])
def test_k3_bwd_launches_the_long_backward(W):
    """flash_hil_bwd launches attn::launch_long_bwd<32> (the source test
    below), whose grid for (R, W, hd 32, 4 heads) is the long instance of
    the Python geometry helpers: (row, head, 64 tokens) with 256 threads and
    the long backward's shared bytes at hd 32, two blocks an SM."""
    R, nhead = 15, 4
    geo = asm.bwd_geometry(R, W, 0, 32, nhead)
    assert geo.instance == "long"
    assert geo.grid == (R, nhead, -(-W // 64)) and geo.threads == 256
    assert geo.smem == asm.long_bwd_bytes(32) <= SMEM_MAX
    assert 2 * (geo.smem + 1024) <= 228 * 1024


def test_k3_bwd_source_uses_the_long_backward():
    """flash_hil.cu's backward entry launches its own pair of kernels over
    attn::lr::long_dq and long_dkv through attn::launch_long_bwd<32>, with
    seg as both tags; the per-thread pair it replaced is gone."""
    src = (CSRC / "flash_hil.cu").read_text()
    assert "attn::launch_long_bwd<32>" in src
    assert "attn::SegTags{seg, seg}" in src
    for kernel in ("flash_hil_bwd_dq_kernel", "flash_hil_bwd_dkv_kernel"):
        assert re.search(r"__launch_bounds__\(attn::LONG_THREADS, "
                         r"attn::long_blocks\(HD\)\)\n" + kernel, src)
    assert "flash_hil_dq_kernel" not in src
    assert "flash_hil_dkv_kernel" not in src
    # the forward, backward and plain version draw one mask: 512 x 128
    assert fh.MASK_BQ == 512 and fh.MASK_BK == 128
    assert "MASK_BQ = 512" in src and "MASK_BK = 128" in src


def _c_params(source: str, entry: str) -> int:
    text = (CSRC / source).read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", text,
                    re.S)
    return len(sig.group(1).split(","))


def test_ctypes_signatures_match_k3_and_k10_entries(monkeypatch):
    """The argtypes that flash_hil.py and transformer_layer.py set have as
    many entries as their C functions have parameters."""
    from graphtrans_tpu_torch.ops.kernels import _build

    def fake(name):
        return types.SimpleNamespace(**{
            fn: types.SimpleNamespace(argtypes=None) for fn in (
                "flash_hil_fwd", "flash_hil_bwd", "layer_gemm",
                "layer_norm_fwd", "layer_norm_bwd", "layer_colsum",
                "layer_sum")})

    monkeypatch.setattr(_build, "load", fake)
    k3, k10 = fh._load(), tl._load()
    for lib, source, entry in (
            (k3, "flash_hil.cu", "flash_hil_fwd"),
            (k3, "flash_hil.cu", "flash_hil_bwd"),
            (k10, "transformer_layer.cu", "layer_gemm"),
            (k10, "transformer_layer.cu", "layer_norm_fwd"),
            (k10, "transformer_layer.cu", "layer_norm_bwd"),
            (k10, "transformer_layer.cu", "layer_colsum"),
            (k10, "transformer_layer.cu", "layer_sum")):
        assert len(getattr(lib, entry).argtypes) == _c_params(source,
                                                              entry), entry
