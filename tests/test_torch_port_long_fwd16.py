"""The bf16 long forward (``csrc/attention_fwd.cuh:long_fwd16``: K2 on
rows of 129-384 tokens, K3 at any width) as the card runs it, emulated in
numpy on the CPU, against the plain bf16 versions and against the JAX
kernels in bf16 in interpret mode; and the forward's launch geometry.

The emulation follows the kernel's order of work. A block per (row, head,
tile slot), ceil(W / 64) + 1 slots a row. A row whose graph ids each form
one run is cut by runs: a run of n tokens into ceil(n / 64) query tiles,
slot z taking tiles z, z + Z, ...; a tile's keys are its run's tokens,
taken 64 at a time from the run's first token; slot z also writes the
zeros of its share of the row's padding tokens. A row where an id forms two
runs keeps the positional 64-query tiles, and a tile's keys are those whose
tag lies between its least and greatest query tag, listed by rank and
masked pair by pair. K3 runs the online softmax chunk by chunk (the running
max from a finite sentinel, alpha = exp(m_old - m_new)) and rounds the
unnormalised, dropped p to bf16 against the running max before P V; K2
walks the keys twice, m and l first, then p = exp(s - m) / l, dropped and
rounded to bf16 once. Every product takes bf16 operands summed in float32;
the output is rounded once. The emulation also checks that every token of
every (row, head) is written exactly once, and that m and l are what the
bf16 backward pair reads: the max scaled score and the sum of the
undropped exp(s - m), m = -inf and l = 0 for a query without a key.

Tolerances, of max(1, max|ref|): outputs within 7.8e-3 (two bf16 ulps at
1: sums in other orders, K3's p rounded against the running max where the
plain version rounds it against the row's final max, and the kernel's exp
and reciprocal on the SFU, within 2^-22 of float32's); m within 1e-6 and l
within 1e-5 relative of their float64 values."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu.ops.pallas.flash_hil import flash_hil_seg_qkv  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import attention_packed as ap  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import flash_hil as fh  # noqa: E402
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    attention_seg_plain, keep_mask)
from graphtrans_tpu_torch.ops.kernels.flash_hil import (  # noqa: E402
    flash_hil_keep_mask, flash_hil_seg_plain)

OUT_TOL = 7.8e-3
H, HD = 4, 32
T = 64               # keys a chunk
QB = 64              # queries a tile (four warps of 16)
M0 = np.float32(-1e30)   # the running max before the first key
SEED = 2**31 - 17
SMEM_MAX = 232448
SM_SMEM = 233472     # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024

# rows of runs: n tokens of a new graph id, (n, id) of the given id, (n, -1)
# padding. Each width holds a row whose graphs straddle the positional
# 64-query tiles, a row where an id forms two runs (walked by rank), an
# all-padding row, a row of one graph of exactly W tokens and a run longer
# than K3's ring of three 64-key chunks.
ROWS = {
    256: [[100, 156], [(40, 7), 17, (40, 7), 64, (95, -1)], [(256, -1)],
          [256], [(3, -1), 200, 53]],
    512: [[1, 64, 385, (62, -1)], [(512, -1)],
          [(100, 7), 200, (100, 7), 1, (111, -1)], [512],
          [(7, -1), 300, 205]],
}


def _seg(W, rows) -> np.ndarray:
    seg = np.full((len(rows), W), -1, np.int32)
    g = 1000
    for r, runs in enumerate(rows):
        s = 0
        for run in runs:
            n, gid = run if isinstance(run, tuple) else (run, None)
            if gid != -1:
                seg[r, s:s + n] = g if gid is None else gid
            g, s = g + 1, s + n
        assert s == W
    return seg


def _bf16(x) -> np.ndarray:
    """x rounded to bf16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _case(W, seed):
    seg = _seg(W, ROWS[W])
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng.standard_normal((len(seg), W, 3 * H * HD)).astype(
        np.float32))
    return qkv, seg


def _runs(tags):
    """(first token, length) of each run of one id >= 0, and whether some
    id forms two runs (tile::find_runs)."""
    runs, ids = [], []
    for i, v in enumerate(tags):
        if v >= 0 and (i == 0 or tags[i - 1] != v):
            runs.append([i, 1])
            ids.append(v)
        elif v >= 0:
            runs[-1][1] += 1
    return [tuple(r) for r in runs], len(set(ids)) < len(ids)


def _tiles(W, tags):
    """The work of each tile slot of a row: [(q0, nq, keys, general)] and
    the padding tokens it zeroes."""
    Z = -(-W // QB) + 1
    runs, general = _runs(tags)
    slots = []
    for z in range(Z):
        work, zeros = [], []
        if not general:
            per = -(-W // Z)
            zeros = [i for i in range(min(W, z * per),
                                      min(W, z * per + per)) if tags[i] < 0]
            items = [(k0 + QB * t, min(QB, n - QB * t), k0, n)
                     for k0, n in runs for t in range(-(-n // QB))]
            for q0, nq, k0, n in items[z::Z]:
                work.append((q0, nq, list(range(k0, k0 + n)), False))
        else:
            for q0 in range(z * QB, W, Z * QB):
                nq = min(QB, W - q0)
                qt = [v for v in tags[q0:q0 + nq] if v >= 0]
                keys = ([j for j in range(W) if min(qt) <= tags[j] <= max(qt)]
                        if qt else [])
                work.append((q0, nq, keys, True))
        slots.append((work, zeros))
    return slots


def _emulate(qkv, seg, rate, seed, norm):
    """(out, m, l) of the bf16 long forward, emulated: K2 with ``norm``, K3
    without; float32 arrays (out of bf16 values)."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    scale = np.float32(1.0) / np.sqrt(np.float32(HD))
    keep = None
    if rate > 0:
        keep = (keep_mask(R, W, H, rate, seed, "cpu") if norm else
                flash_hil_keep_mask(R, W, H, rate, seed, "cpu")).numpy()
    inv_keep = np.float32(1.0 / (1.0 - rate))
    out = np.full((R, W, d), np.nan, np.float32)
    m_all = np.full((R, W, H), np.nan, np.float32)
    l_all = np.full((R, W, H), np.nan, np.float32)
    for b in range(R):
        tags = seg[b]
        for h in range(H):
            Q, K, V = (qkv[b, :, p * d + h * HD:p * d + (h + 1) * HD]
                       for p in range(3))
            written = np.zeros(W, np.int64)
            for work, zeros in _tiles(W, tags):
                for i in zeros:
                    out[b, i, h * HD:(h + 1) * HD] = 0
                    m_all[b, i, h], l_all[b, i, h] = -np.inf, 0
                    written[i] += 1
                for q0, nq, keys, general in work:
                    qi = np.arange(q0, q0 + nq)
                    o, mx, lsum = _tile(Q, K, V, tags, qi, np.array(keys,
                                        np.int64), general, scale, norm,
                                        None if keep is None else keep[b, h],
                                        inv_keep)
                    out[b, qi, h * HD:(h + 1) * HD] = o
                    m_all[b, qi, h] = np.where(lsum > 0, mx, -np.inf)
                    l_all[b, qi, h] = lsum
                    written[qi] += 1
            assert (written == 1).all(), (b, h, written)
    return out, m_all, l_all


def _tile(Q, K, V, tags, qi, keys, general, scale, norm, keep, inv_keep):
    """One query tile of 64 queries, its keys 64 at a time."""
    n = len(qi)
    mx = np.full(n, M0, np.float32)
    lsum = np.zeros(n, np.float32)
    o = np.zeros((n, HD), np.float32)

    def scores(kj):
        s = (Q[qi] @ K[kj].T) * scale
        if general:
            meet = (tags[kj][None, :] >= 0) & (tags[kj][None, :]
                                               == tags[qi][:, None])
            s = np.where(meet, s, -np.inf)
        return s.astype(np.float32)

    def dropped(p, kj):
        if keep is None:
            return p
        return np.where(keep[np.ix_(qi, kj)], p * inv_keep, np.float32(0))

    chunks = [keys[c:c + T] for c in range(0, len(keys), T)]
    with np.errstate(invalid="ignore", over="ignore"):
        for kj in chunks:            # K3: the output; K2: m and l
            s = scores(kj)
            mn = np.maximum(mx, s.max(1))            # finite: mx >= M0
            a = np.exp(mx - mn)
            p = np.exp(s - mn[:, None]).astype(np.float32)   # 0: no pair
            lsum = lsum * a + p.sum(1, dtype=np.float32)
            mx = mn
            if not norm:
                o = o * a[:, None] + _bf16(dropped(p, kj)) @ V[kj]
        if norm:                     # K2: p normalised by the final m, l
            inv = np.float32(1) / np.maximum(lsum, np.float32(1e-16))
            for kj in chunks:
                p = np.exp(scores(kj) - mx[:, None]) * inv[:, None]
                o = o + _bf16(dropped(p.astype(np.float32), kj)) @ V[kj]
        else:
            o = o / np.maximum(lsum, np.float32(1e-16))[:, None]
    return _bf16(o), mx, lsum


def _dist(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _stats(qkv, seg):
    """m and l in float64 from the scores: the max scaled score of a
    query's keys and the sum of exp(s - m), -inf and 0 without a key."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    x = qkv.astype(np.float64)
    m = np.full((R, W, H), -np.inf)
    l = np.zeros((R, W, H))
    for h in range(H):
        q = x[:, :, h * HD:(h + 1) * HD]
        k = x[:, :, d + h * HD:d + (h + 1) * HD]
        s = np.einsum("bic,bjc->bij", q, k) / np.sqrt(HD)
        meet = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] >= 0)
        s = np.where(meet, s, -np.inf)
        mh = s.max(2)
        with np.errstate(invalid="ignore"):
            e = np.where(meet, np.exp(s - mh[:, :, None]), 0.0)
        m[:, :, h], l[:, :, h] = mh, e.sum(2)
    return m, l


def _plain(qkv, seg, rate, norm):
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    f = attention_seg_plain if norm else flash_hil_seg_plain
    return f(t, torch.from_numpy(seg), H, rate, SEED).float().numpy()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("W,norm", [(256, True), (512, False)])
def test_long_fwd16_emulation_matches_plain(W, norm, rate):
    """The emulated forward (K2 at W 256, K3 at W 512) against the plain
    bf16 versions with the same dropout mask: runs that straddle the
    positional tiles, an id in two runs, an all-padding row, a row of one
    graph of W tokens and runs longer than the ring; every token written
    once; padding exactly 0 with m = -inf and l = 0; m and l the softmax
    statistics the backward reads."""
    qkv, seg = _case(W, seed=W + int(10 * rate))
    out, m, l = _emulate(qkv, seg, rate, SEED, norm)
    assert _dist(out, _plain(qkv, seg, rate, norm)) <= OUT_TOL
    pad = seg < 0
    assert not out[pad].any()
    assert np.all(m[pad] == -np.inf) and not l[pad].any()
    m64, l64 = _stats(qkv, seg)
    live = ~pad
    assert np.abs(m[live] - m64[live]).max() <= 1e-6 * max(
        1.0, np.abs(m64[live]).max())
    assert (np.abs(l[live] - l64[live]) / l64[live]).max() <= 1e-5
    assert np.all(l[live] >= 1.0)    # a query meets itself at exp(0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k2_long_fwd16_emulation_matches_jax_interpret(rate):
    """The emulated K2 forward on rows of 256 against
    attention_packed_seg_qkv in bf16 in interpret mode (its dropout is the
    same counter-hash mask)."""
    qkv, seg = _case(256, seed=5)
    out, _, _ = _emulate(qkv, seg, rate, SEED, True)
    want = attention_packed_seg_qkv(jnp.asarray(qkv, jnp.bfloat16),
                                    jnp.asarray(seg), SEED, H, rate, True,
                                    True)
    assert _dist(out, np.asarray(want.astype(jnp.float32))) <= OUT_TOL


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k3_fwd16_emulation_matches_jax_interpret(rate):
    """The emulated K3 forward on rows of 512 against flash_hil_seg_qkv in
    bf16 in interpret mode with the schedule's dropout (its DEFAULT
    products are exact float32 there, where the emulation rounds p to bf16
    against the running max as the TPU does)."""
    qkv, seg = _case(512, seed=6)
    out, _, _ = _emulate(qkv, seg, rate, SEED, False)
    want = flash_hil_seg_qkv(jnp.asarray(qkv, jnp.bfloat16),
                             jnp.asarray(seg), SEED, H, rate, True, True)
    assert _dist(out, np.asarray(want.astype(jnp.float32))) <= OUT_TOL


def test_k3_chunk_starts_follow_the_runs():
    """K3's p is rounded against the running max, so its bits follow where
    the chunks start: the runs' cut starts a run's chunks at its first
    token. A run beginning mid-tile (row 0 of W 512: runs at 0, 1, 65)
    takes keys 65, 129, ... as chunk starts, where the positional cut's
    chunks started at the rank of the keys of every graph meeting the
    tile; both stay within OUT_TOL of the plain version."""
    qkv, seg = _case(512, seed=7)
    tiles = [w for work, _ in _tiles(512, seg[0]) for w in work]
    starts = {k[0] for _, _, k, _ in tiles}
    assert starts == {0, 1, 65}
    assert sorted((q0, nq) for q0, nq, _, _ in tiles) == [
        (0, 1), (1, 64)] + [(65 + 64 * t, 64) for t in range(6)] + [
            (449, 1)]


@pytest.mark.parametrize("W,norm", [(129, True), (384, True), (512, False),
                                    (1024, False), (1001, False)])
def test_long_fwd16_geometry(W, norm):
    """The forward's launch: a block of four warps (128 threads) per (row,
    head, tile slot), ceil(W / 64) + 1 slots, pad the 64 queries of a
    tile; its shared bytes (Q, K2's K and V whole, K3's through a ring of
    three chunks; the row's tags, runs and scratch) fit the card and let
    three blocks (K2, K3 with dropout: their registers) or four (K3) share
    an SM at code2's widths."""
    R = 15
    geo = (ap.seg_bf16_geometry(R, W, H, False) if norm
           else fh.fwd_geometry(R, W, H, torch.bfloat16))
    assert geo == ap.long16_fwd_geometry(R, W, H, norm)
    assert geo.instance == "long" and geo.args()[0] == 3
    assert geo.grid == (R, H, -(-W // 64) + 1) and geo.group == 1
    assert geo.pad == 64 and geo.threads == 128
    rows = -(-W // 64) * 64 if norm else 192
    assert geo.smem == ap.long16_fwd_bytes(W, norm) == (
        (64 + 2 * rows) * 40 * 2 + (rows + 3 * W + 1 + 16) * 4)
    assert geo.smem <= SMEM_MAX
    assert SM_SMEM // (geo.smem + BLOCK_RESERVED) >= (3 if norm else 4)
    assert ap.long16_fwd_bytes(384, True) == 72772
    assert ap.long16_fwd_bytes(1024, False) == 48964
