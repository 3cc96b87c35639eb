"""K2's bf16 pair as the card runs it (``csrc/attention_tile.cuh``:
``fwd_seg16``, ``bwd_seg16``), emulated in numpy on the CPU, against the
plain bf16 versions and against the JAX kernel in bf16 in interpret mode;
and the pair's launch geometry.

The emulation follows the kernels step by step: a row's runs of one graph
id (the whole row as one problem where an id forms two runs), each cut
into 16-query tiles whose keys are padded to 16 ceil(n / 16) and masked by
tag; a tile's score rows whole (the max, then the undropped sum); the
rounding points (p, O; P_drop, dS, dQ, dK, dV rounded to bf16 once, every
product from bf16 operands summed in float32); the backward's first pass by
query tile (delta from the undropped p and the dropped dp, dS, dQ) and its
second by key tile, whose dK and dV sums run over the problem's query tiles
in turn. The card tests hold the kernels to the plain versions
(``tests/test_torch_port_cuda.py``).

Tolerances, of max(1, max|ref|): outputs within 7.8e-3 (two bf16 ulps at
1: the sums run in other orders and may round a value near a tie the other
way), gradients within 1.6e-2 (four ulps: two rounding points)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    SEG_BF16_THREADS, SEG_TILE_MAX, SMEM_MAX, attention_seg_bwd_plain,
    attention_seg_plain, keep_mask, long16_fwd_geometry, long16_geometry,
    seg_bf16_geometry)

OUT_TOL, GRAD_TOL = 7.8e-3, 1.6e-2
H, HD = 4, 32
SEED = 2**31 - 17
SM_SMEM = 233472        # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024   # the runtime's own shared bytes a block
SM_THREADS = 2048

# rows of runs: n tokens of a new graph id, (n, id) of the given id, (n, -1)
# padding
LAYOUTS = {
    "lengths": (128, [[1, 15, 16, 17, 33, 46], [48, 48, (32, -1)]]),
    "whole": (128, [[128], [(100, -1), 28]]),
    "two_runs": (128, [[(20, 7), 10, (15, 7), (83, -1)], [(128, -1)]]),
    "tiles": (128, [[17] * 7 + [9], [15] * 8 + [8], [33, 33, 33, 29]]),
    "narrow": (37, [[10, (3, -1), 9, 12, (3, -1)],
                    [(5, 2), 5, (5, 2), (22, -1)], [37]]),
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


def _case(W, rows, seed):
    """bf16-valued qkv and cotangent (float32 arrays) and seg."""
    rng = np.random.default_rng(seed)
    seg = _seg(W, rows)
    R = len(seg)
    qkv = _bf16(rng.standard_normal((R, W, 3 * H * HD)).astype(np.float32))
    g = _bf16(rng.standard_normal((R, W, H * HD)).astype(np.float32))
    return qkv, seg, g


def _bf16(x) -> np.ndarray:
    """x rounded to bf16 (nearest even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _problems(tags):
    """The row's problems (s0, n): its runs of one id >= 0, or the whole
    row where an id forms two runs (SegTiles::load, find_runs)."""
    runs, ids = [], []
    W = len(tags)
    for i in range(W):
        if tags[i] >= 0 and (i == 0 or tags[i - 1] != tags[i]):
            runs.append([i, 1])
            ids.append(tags[i])
        elif tags[i] >= 0:
            runs[-1][1] += 1
    if len(set(ids)) < len(ids):
        return [(0, W)]
    return [tuple(r) for r in runs]


def _emulate(qkv, seg, g, rate, seed):
    """(out, m, l, dqkv) of K2's bf16 pair, emulated: float32 arrays of
    bf16 values (m, l float32)."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    scale = np.float32(1.0) / np.sqrt(np.float32(HD))
    rows = -(-W // 16) * 16 + 16                  # seg16_rows(W)
    keep = (keep_mask(R, W, H, rate, seed, "cpu").numpy() if rate > 0
            else None)
    inv_keep = np.float32(1.0 / (1.0 - rate))
    out = np.zeros((R, W, d), np.float32)
    dqkv = np.zeros((R, W, d3), np.float32)
    m_all = np.full((R, W, H), -np.inf, np.float32)
    l_all = np.zeros((R, W, H), np.float32)
    for b in range(R):
        tg = np.full(rows, -1, np.int64)
        tg[:W] = seg[b]
        problems = _problems(seg[b])
        for h in range(H):
            def staged(part, src=qkv):
                t = np.zeros((rows, HD), np.float32)
                t[:W] = src[b, :, part * d + h * HD:part * d + (h + 1) * HD]
                return t
            Q, K, V = staged(0), staged(1), staged(2)
            G = np.zeros((rows, HD), np.float32)
            G[:W] = g[b, :, h * HD:(h + 1) * HD]
            kp = (np.zeros((rows, rows), bool) if keep is None else
                  np.pad(keep[b, h], ((0, rows - W), (0, rows - W))))
            mrow = np.zeros(rows, np.float32)
            lrow = np.zeros(rows, np.float32)
            drow = np.zeros(rows, np.float32)

            def meets(qi, kj):                    # [len(qi), len(kj)]
                return (tg[kj][None, :] >= 0) & (tg[kj][None, :]
                                                 == tg[qi][:, None])

            # the forward, a 16-query tile at a time
            for s0, n in problems:
                keys = np.arange(s0, s0 + -(-n // 16) * 16)
                for r0 in range(s0, s0 + n, 16):
                    qi = np.arange(r0, r0 + 16)
                    s = np.where(meets(qi, keys),
                                 (Q[qi] @ K[keys].T) * scale, -np.inf)
                    mx = s.max(1)
                    with np.errstate(invalid="ignore"):
                        e = np.where(mx[:, None] == -np.inf, np.float32(0),
                                     np.exp(s - mx[:, None]))
                    lsum = e.sum(1, dtype=np.float32)
                    p = e / np.maximum(lsum, np.float32(1e-16))[:, None]
                    if keep is not None:
                        p = np.where((p != 0) & kp[np.ix_(qi, keys)],
                                     p * inv_keep, np.float32(0))
                    o = _bf16(_bf16(p) @ V[keys])
                    live = qi - s0 < n
                    out[b, qi[live], h * HD:(h + 1) * HD] = o[live]
                    m_all[b, qi[live], h] = mx[live]
                    l_all[b, qi[live], h] = lsum[live]
            for i in range(W):
                if seg[b, i] >= 0:
                    mrow[i] = m_all[b, i, h]
                    lrow[i] = np.float32(1) / max(l_all[b, i, h],
                                                  np.float32(1e-16))

            def pd_pairs(qi, keys, s0, n):
                """p (0 where the pair does not meet) and the dropped dp of
                problem (s0, n)'s queries qi and keys."""
                ok = meets(qi, keys) & ((qi - s0) < n)[:, None]
                s = (Q[qi] @ K[keys].T) * scale
                with np.errstate(over="ignore", invalid="ignore"):
                    p = np.where(ok, np.exp(s - mrow[qi][:, None])
                                 * lrow[qi][:, None], np.float32(0))
                dp = G[qi] @ V[keys].T
                kept = (np.ones_like(ok) if keep is None
                        else kp[np.ix_(qi, keys)])
                if keep is not None:
                    dp = dp * inv_keep
                return p.astype(np.float32), np.where(
                    ok & kept, dp, np.float32(0)), kept

            # pass 1: by query tile, delta, dS and dQ
            for s0, n in problems:
                keys = np.arange(s0, s0 + -(-n // 16) * 16)
                for r0 in range(s0, s0 + n, 16):
                    qi = np.arange(r0, r0 + 16)
                    p, dp, _ = pd_pairs(qi, keys, s0, n)
                    de = (p * dp).sum(1, dtype=np.float32)
                    ds = _bf16(p * (dp - de[:, None]) * scale)
                    dq = _bf16(ds @ K[keys])
                    live = qi - s0 < n
                    drow[qi[live]] = de[live]
                    dqkv[b, qi[live], h * HD:(h + 1) * HD] = dq[live]
            # pass 2: by key tile, dK and dV summed over the query tiles
            for s0, n in problems:
                for k0 in range(s0, s0 + n, 16):
                    kj = np.arange(k0, k0 + 16)
                    dk = np.zeros((16, HD), np.float32)
                    dv = np.zeros((16, HD), np.float32)
                    for r0 in range(s0, s0 + n, 16):
                        qi = np.arange(r0, r0 + 16)
                        p, dp, kept = pd_pairs(qi, kj, s0, n)
                        pd = np.where(kept, p * inv_keep if keep is not None
                                      else p, np.float32(0))
                        ds = np.where(p != 0, p * (dp - drow[qi][:, None])
                                      * scale, np.float32(0))
                        dv += _bf16(pd).T @ G[qi]
                        dk += _bf16(ds).T @ Q[qi]
                    live = kj - s0 < n
                    dqkv[b, kj[live], d + h * HD:d + (h + 1) * HD] = \
                        _bf16(dk)[live]
                    dqkv[b, kj[live], 2 * d + h * HD:2 * d + (h + 1) * HD] = \
                        _bf16(dv)[live]
    return out, m_all, l_all, dqkv


def _dist(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_k2_bf16_pair_emulation_matches_plain(layout, rate):
    """The emulated pair against attention_seg_plain and
    attention_seg_bwd_plain in bf16 (the same dropout mask): segments of 1,
    15, 16, 17, 33, 46, 48 and 128 tokens, rows of 16-token runs and of runs
    that cross the tile borders, an id in two runs, all-padding rows and a
    row of 37; padding tokens exactly 0, m = -inf and l = 0."""
    W, rows = LAYOUTS[layout]
    qkv, seg, g = _case(W, rows, seed=len(layout) + int(10 * rate))
    out, m, l, dqkv = _emulate(qkv, seg, g, rate, SEED)
    t_qkv = torch.from_numpy(qkv).to(torch.bfloat16)
    t_seg = torch.from_numpy(seg)
    want = attention_seg_plain(t_qkv, t_seg, H, rate, SEED)
    want_d = attention_seg_bwd_plain(t_qkv, t_seg, H,
                                     torch.from_numpy(g).to(torch.bfloat16),
                                     rate, SEED)
    assert _dist(out, _f32(want)) <= OUT_TOL
    assert _dist(dqkv, _f32(want_d)) <= GRAD_TOL
    pad = seg < 0
    assert not out[pad].any() and not dqkv[pad].any()
    assert np.all(m[pad] == -np.inf) and not l[pad].any()
    assert np.all(l[~pad] >= 1.0)    # a query meets itself at exp(0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_k2_bf16_pair_emulation_matches_jax_interpret(rate):
    """The emulated pair against attention_packed_seg_qkv in bf16 in
    interpret mode on the W = 128 rows of every layout (nine rows: two
    dropout tiles), forward and dqkv."""
    rows = [r for name in ("lengths", "whole", "two_runs", "tiles")
            for r in LAYOUTS[name][1]]
    qkv, seg, g = _case(128, rows, seed=31)
    out, _, _, dqkv = _emulate(qkv, seg, g, rate, SEED)
    f = lambda t: attention_packed_seg_qkv(t, jnp.asarray(seg), SEED, H,
                                           rate, True, True)
    want, vjp = jax.vjp(f, jnp.asarray(qkv, jnp.bfloat16))
    (want_d,) = vjp(jnp.asarray(g, jnp.bfloat16))
    assert _dist(out, _f32(want)) <= OUT_TOL
    assert _dist(dqkv, _f32(want_d)) <= GRAD_TOL


@pytest.mark.parametrize("W", [37, 64, 128])
def test_seg_bf16_geometry(W):
    """The pair's launches: a block of SEG_BF16_THREADS per (row, head), the
    rows staged (W rounded up to 16, and 16 more), shared bytes within
    SMEM_MAX that let at least four blocks share an SM in either
    direction; rows wider than SEG_TILE_MAX take the bf16 long forward's
    launch (long16_fwd_geometry, its keys staged whole) and the bf16 long
    pair's (long16_geometry)."""
    R = 5
    for bwd in (False, True):
        geo = seg_bf16_geometry(R, W, H, bwd)
        assert geo.instance == "tile" and geo.args()[0] == 1
        assert geo.grid == (R * H, 1, 1) and geo.group == 1
        assert geo.pad == -(-W // 16) * 16 + 16
        assert geo.threads == SEG_BF16_THREADS == 128
        assert geo.smem <= SMEM_MAX
        by_smem = SM_SMEM // (geo.smem + BLOCK_RESERVED)
        assert min(by_smem, SM_THREADS // geo.threads) >= 4
    assert seg_bf16_geometry(R, 128, H, True).smem == 49948
    for bwd in (False, True):
        geo = seg_bf16_geometry(R, SEG_TILE_MAX + 1, H, bwd)
        assert geo.instance == "long" and geo.args()[0] == 3
        assert geo == (long16_geometry(R, SEG_TILE_MAX + 1, H) if bwd else
                       long16_fwd_geometry(R, SEG_TILE_MAX + 1, H, True))
