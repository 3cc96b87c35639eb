"""The bf16 long backward pair (``csrc/attention_bwd.cuh:long_dq16``,
``long_dkv16``: K2-bwd on rows of 129-384 tokens, K3-bwd at any width) as
the card runs it, emulated in numpy on the CPU, against the plain bf16
versions and against the gradients of the JAX kernels in bf16 in
interpret mode; and the pair's launch geometry.

The emulation follows the kernels' order of work. A block per (row, head,
tile slot), ceil(W / 64) + 1 slots a row. A row whose graph ids each form
one run is cut by runs: the dq kernel cuts a run of n tokens into
ceil(n / 64) query tiles, the dk/dv kernel into as many key tiles, slot z
taking tiles z, z + Z, ...; a tile's partners are its run's tokens, taken
64 at a time from the run's first token; slot z also writes the zeros of
its share of the row's padding tokens. A row where an id forms two runs
keeps the positional 64-token tiles, and a tile's partners are the tokens
whose tag lies between its least and greatest tag, listed by rank and
masked pair by pair. p = exp(s - m) / l from the forward's m and l, taken
as 2^(s log2(e) - m log2(e)) / (l (1 - rate)): a kept pair's P_drop; dp =
dO.v where the pair is kept, else 0; K2 sums delta = sum p dp over its
keys in a first sweep, then takes dS and dQ in a second (PAIRS), K3 takes
delta = dO . O over the forward's rounded output; dS = p (dp - delta (1 -
rate)) scale, which is p_undropped (dp_dropped - delta) scale. The dq
kernel leaves per query a record (m log2(e), 1 / (l (1 - rate)), delta (1
- rate), the dropout hash's row part) that the dk/dv kernel reads; the
hash of a pair is its query's part plus its key's (the mask policies'
Split), held here to the plain versions' masks. dS and P_drop are rounded
to bf16 before their products; dQ, dK and dV are summed in float32 and
rounded once. The emulation checks that every cell of dqkv of every (row,
head) is written exactly once.

Tolerance: 1.6e-2 of max(1, max|ref|) (BF16_GRAD_TOL): the sums run in
other orders than the references' (by chunks of 64 from a run's first
token), the kernels take exp and the reciprocal on the SFU (within 2^-22
of float32's), and dS and P_drop, rounded to bf16, move by an ulp where
that order moves them across a rounding boundary."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu.ops.pallas.flash_hil import flash_hil_seg_qkv  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import attention_packed as ap  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import flash_hil as fh  # noqa: E402
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    attention_seg_bwd_plain, dropout_tiling, keep_mask, keep_threshold)
from graphtrans_tpu_torch.ops.kernels.flash_hil import (  # noqa: E402
    flash_hil_keep_mask, flash_hil_seg_bwd_plain, flash_hil_seg_plain)

GRAD_TOL = 1.6e-2
H, HD = 4, 32
T = 64               # tokens a tile, partners a chunk
SEED = 2**31 - 19
LOG2E = np.float32(1.4426950408889634)
POS_MUL, SEED_MUL = np.uint32(2654435761), np.uint32(0x9E3779B9)
SMEM_MAX = 232448
SM_SMEM = 233472     # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED = 1024

# rows of runs: n tokens of a new graph id, (n, id) of the given id, (n, -1)
# padding. Each width holds graphs that straddle the positional 64-token
# tiles, a run of 1 token, a run of 128 (two whole chunks), a tile ending
# at its run's end beside the next graph's run, a run longer than K3's
# ring of three chunks, an id in two runs and an all-padding row.
ROWS = {
    256: [[1, 128, 60, 67], [(40, 7), 17, (40, 7), 64, (95, -1)],
          [(256, -1)], [(3, -1), 200, 53], [64, 64, 1, (127, -1)]],
    512: [[1, 64, 385, (62, -1)], [(512, -1)],
          [(100, 7), 200, (100, 7), 1, (111, -1)], [128, 128, 256],
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
    qkv = _bf16(rng.standard_normal((len(seg), W, 3 * H * HD)))
    gout = _bf16(rng.standard_normal((len(seg), W, H * HD)))
    return qkv, seg, gout


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


def _slots(W, tags):
    """The work of each tile slot of a row, the same in both kernels:
    [(first token, tokens, partners, general)] and the padding tokens it
    zeroes."""
    Z = -(-W // T) + 1
    runs, general = _runs(tags)
    slots = []
    for z in range(Z):
        work, zeros = [], []
        if not general:
            per = -(-W // Z)
            zeros = [i for i in range(min(W, z * per),
                                      min(W, z * per + per)) if tags[i] < 0]
            items = [(k0 + T * t, min(T, n - T * t), k0, n)
                     for k0, n in runs for t in range(-(-n // T))]
            for r0, n, k0, kn in items[z::Z]:
                work.append((r0, n, list(range(k0, k0 + kn)), False))
        else:
            for r0 in range(z * T, W, Z * T):
                n = min(T, W - r0)
                tg = [v for v in tags[r0:r0 + n] if v >= 0]
                part = ([j for j in range(W) if min(tg) <= tags[j] <= max(tg)]
                        if tg else [])
                work.append((r0, n, part, True))
        slots.append((work, zeros))
    return slots


def _mix(x):
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _split(R, W, seed, pairs):
    """(at [R, H, W], col [W]), uint32: the hash input of pair (i, j) of
    row r, head h is at[r, h, i] + col[j] (K2's mask policy with
    ``pairs``, K3's without)."""
    i = np.arange(W, dtype=np.uint32)
    r = np.arange(R)[:, None, None]
    h = np.arange(H)[None, :, None]
    if pairs:
        sp, bt = dropout_tiling(W)
        hseed = ((seed + (r // bt) * H + h) % 2**32).astype(np.uint32)
        base = ((r % bt) * W).astype(np.uint32)
        return ((base + i) * np.uint32(sp) * POS_MUL + hseed * SEED_MUL,
                i * POS_MUL)
    base = ((seed + (r * H + h) * 16384 * 1024) % 2**32).astype(np.uint32)
    at = ((i % np.uint32(512)) * np.uint32(128) * POS_MUL
          + (base + (i // np.uint32(512)) * np.uint32(1024)) * SEED_MUL)
    return at, ((i % np.uint32(128)) * POS_MUL
                + (i // np.uint32(128)) * SEED_MUL)


def _stats(Q, K, tags, scale):
    """The forward's m (the max scaled score) and l (the sum of exp(s -
    m)) of one (row, head), 0 for a query without a key."""
    s = (Q @ K.T) * scale
    meet = (tags[:, None] == tags[None, :]) & (tags[None, :] >= 0)
    m = np.where(meet, s, -np.inf).max(1)
    m = np.where(tags >= 0, m, 0).astype(np.float32)
    e = np.where(meet, np.exp(s - m[:, None]), 0)
    return m, e.sum(1, dtype=np.float32)


def _emulate(qkv, seg, out, gout, rate, seed, pairs):
    """dqkv of the bf16 long pair, emulated (K2 with ``pairs``, K3 without;
    ``out`` the forward's rounded output, which K3's delta reads)."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    scale = np.float32(1.0) / np.sqrt(np.float32(HD))
    sl = scale * LOG2E
    inv_keep = np.float32(1.0 / (1.0 - rate))
    keep_rate = np.float32(1.0 - rate)
    at, col = _split(R, W, seed, pairs)
    thresh = np.uint32(keep_threshold(rate))
    dqkv = np.full((R, W, d3), np.nan, np.float32)
    for b in range(R):
        tags = seg[b]
        slots = _slots(W, tags)
        for h in range(H):
            c = slice(h * HD, (h + 1) * HD)
            Q, K, V = (qkv[b, :, p * d + h * HD:p * d + (h + 1) * HD]
                       for p in range(3))
            G, O = gout[b, :, c], out[b, :, c]
            m, l = _stats(Q, K, tags, scale)

            def kept(x, i, j):  # x [len(i), len(j)], 0 where dropped
                if rate == 0.0:
                    return x
                keep = _mix(at[b, h, i][:, None] + col[j][None, :]) < thresh
                return np.where(keep, x, np.float32(0))

            def meets(i, j, general):
                if not general:
                    return np.ones((len(i), len(j)), bool)
                return (tags[i][:, None] >= 0) & (tags[i][:, None]
                                                  == tags[j][None, :])

            # the records the dq kernel leaves: m log2(e), 1 / (l (1 -
            # rate)), delta (1 - rate)
            rec = np.zeros((W, 3), np.float32)
            written = np.zeros((3, W), np.int64)
            for work, zeros in slots:            # the dq kernel
                for i in zeros:
                    dqkv[b, i, c] = 0
                    written[0, i] += 1
                for r0, n, part, general in work:
                    i = np.arange(r0, r0 + n)
                    ok = tags[i] >= 0
                    ml = np.where(ok, m[i] * LOG2E, 0).astype(np.float32)
                    li = np.where(ok, inv_keep / np.maximum(l[i], 1e-16),
                                  0).astype(np.float32)
                    de = (np.zeros(n, np.float32) if pairs else
                          np.where(ok, (G[i] * O[i]).sum(1) * keep_rate,
                                   0).astype(np.float32))
                    chunks = [np.array(part[k:k + T], np.int64)
                              for k in range(0, len(part), T)]

                    def pd(j):
                        s = (Q[i] @ K[j].T).astype(np.float32)
                        p = np.where(meets(i, j, general),
                                     np.exp2(s * sl - ml[:, None])
                                     * li[:, None], np.float32(0))
                        return p, kept(G[i] @ V[j].T, i, j)

                    if pairs:                    # delta's sweep
                        for j in chunks:
                            p, dp = pd(j)
                            de = de + (p * dp).sum(1, dtype=np.float32)
                        de = de * keep_rate
                    dq = np.zeros((n, HD), np.float32)
                    for j in chunks:             # dS and dQ
                        p, dp = pd(j)
                        dq += _bf16(p * (dp - de[:, None]) * scale) @ K[j]
                    dqkv[b, i, c] = _bf16(dq)
                    rec[i] = np.stack([ml, li, de], 1)
                    written[0, i] += 1
            for work, zeros in slots:            # the dk/dv kernel
                for j in zeros:
                    dqkv[b, j, d + h * HD:d + (h + 1) * HD] = 0
                    dqkv[b, j, 2 * d + h * HD:2 * d + (h + 1) * HD] = 0
                    written[1:, j] += 1
                for r0, n, part, general in work:
                    j = np.arange(r0, r0 + n)
                    dk = np.zeros((n, HD), np.float32)
                    dv = np.zeros((n, HD), np.float32)
                    for k in range(0, len(part), T):
                        i = np.array(part[k:k + T], np.int64)
                        ml, li, de = rec[i].T
                        s = (Q[i] @ K[j].T).astype(np.float32)
                        p = np.where(meets(i, j, general),
                                     np.exp2(s * sl - ml[:, None])
                                     * li[:, None], np.float32(0))
                        dp = kept(G[i] @ V[j].T, i, j)
                        ds = _bf16(p * (dp - de[:, None]) * scale)
                        dk += ds.T @ Q[i]
                        dv += _bf16(kept(p, i, j)).T @ G[i]
                    dqkv[b, j, d + h * HD:d + (h + 1) * HD] = _bf16(dk)
                    dqkv[b, j, 2 * d + h * HD:2 * d + (h + 1) * HD] = _bf16(dv)
                    written[1:, j] += 1
            assert (written == 1).all(), (b, h, written)
    return dqkv


def _dist(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _plain_out(qkv, seg, rate):
    """K3's forward output, rounded, from its plain bf16 version."""
    return flash_hil_seg_plain(_t(qkv), torch.from_numpy(seg), H, rate,
                               SEED).float().numpy()


def _grads(qkv, seg, gout, rate, pairs):
    """(the emulation's dqkv, the plain bf16 backward's)."""
    out = np.zeros(gout.shape, np.float32) if pairs else _plain_out(
        qkv, seg, rate)
    got = _emulate(qkv, seg, out, gout, rate, SEED, pairs)
    plain = attention_seg_bwd_plain if pairs else flash_hil_seg_bwd_plain
    want = plain(_t(qkv), torch.from_numpy(seg), H, _t(gout), rate, SEED)
    return got, want.float().numpy()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("W,pairs", [(256, True), (512, False)])
def test_long_bwd16_emulation_matches_plain(W, pairs, rate):
    """The emulated pair (K2 at W 256, K3 at W 512) against the plain bf16
    backward with the same dropout mask: graphs straddling the positional
    tiles, runs of 1 and 128 tokens, a tile ending at its run's end beside
    the next graph, runs longer than the ring, an id in two runs and an
    all-padding row; every dqkv cell written once; padding exactly 0."""
    qkv, seg, gout = _case(W, seed=W + int(10 * rate))
    got, want = _grads(qkv, seg, gout, rate, pairs)
    assert _dist(got, want) <= GRAD_TOL
    assert not got[seg < 0].any()


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("W,pairs", [(256, True), (512, False)])
def test_long_bwd16_emulation_matches_jax_interpret(W, pairs, rate):
    """The emulated pair against jax.vjp of attention_packed_seg_qkv (K2,
    rows of 256) and flash_hil_seg_qkv (K3, rows of 512) in bf16 in
    interpret mode, with the same counter-hash dropout (the interpret
    kernels' DEFAULT products are exact float32 on the CPU, where the
    emulation rounds dS and P_drop as the TPU does)."""
    qkv, seg, gout = _case(W, seed=W + 3 + int(10 * rate))
    f = attention_packed_seg_qkv if pairs else flash_hil_seg_qkv
    _, vjp = jax.vjp(lambda x: f(x, jnp.asarray(seg), SEED, H, rate, True,
                                 True), jnp.asarray(qkv, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(gout, jnp.bfloat16))
    out = (np.zeros(gout.shape, np.float32) if pairs
           else _plain_out(qkv, seg, rate))
    got = _emulate(qkv, seg, out, gout, rate, SEED, pairs)
    assert _dist(got, np.asarray(want.astype(jnp.float32))) <= GRAD_TOL


@pytest.mark.parametrize("W,pairs", [(256, True), (512, False)])
def test_split_hash_is_the_plain_mask(W, pairs):
    """The pair's dropout hash, a query's part plus a key's (the Split of
    K2's and K3's mask policies), keeps exactly the pairs the plain
    versions' masks keep."""
    R, rate = 3, 0.3
    at, col = _split(R, W, SEED, pairs)
    got = _mix(at[:, :, :, None] + col) < np.uint32(keep_threshold(rate))
    want = (keep_mask(R, W, H, rate, SEED, "cpu") if pairs
            else flash_hil_keep_mask(R, W, H, rate, SEED, "cpu"))
    assert np.array_equal(got, want.numpy())


def test_slots_cut_by_runs():
    """The runs' cut: W 256's first row (runs of 1, 128, 60, 67 tokens)
    gives tiles of 1, 64, 64, 60, 64 and 3 tokens, every tile's partners
    its run's tokens from the run's first; its eight tiles go to the row's
    five slots in turn; a row where an id forms two runs takes the
    positional tiles."""
    seg = _seg(256, ROWS[256])
    slots = _slots(256, seg[0])
    assert len(slots) == 5
    tiles = [w for work, _ in slots for w in work]
    assert sorted((r0, n) for r0, n, _, _ in tiles) == [
        (0, 1), (1, 64), (65, 64), (129, 60), (189, 64), (253, 3)]
    assert {p[0] for _, _, p, _ in tiles} == {0, 1, 129, 189}
    assert [len(work) for work, _ in slots] == [2, 1, 1, 1, 1]
    gen = [w for work, _ in _slots(256, seg[1]) for w in work]
    assert all(g for *_, g in gen)
    assert sorted(r0 for r0, *_ in gen) == [0, 64, 128, 192]


@pytest.mark.parametrize("W,whole", [(129, True), (256, True), (384, True),
                                     (512, False), (1001, False),
                                     (1024, False)])
def test_long_bwd16_geometry(W, whole):
    """The pair's launch, the same for its two kernels: a block of four
    warps (128 threads) per (row, head, tile slot), ceil(W / 64) + 1 slots,
    pad the 64 tokens of a tile; its shared bytes (the tile's own two
    slices, K2's partners whole, K3's through a ring of three chunks; the
    row's tags, runs and scratch), as csrc/attention_bwd.cuh:bwd16_bytes
    computes them, fit the card and let three blocks share an SM at
    code2's widths (four for K3)."""
    R = 15
    geo = (ap.seg_bf16_geometry(R, W, H, True) if whole
           else fh.bwd_geometry(R, W, H))
    assert geo == ap.long16_bwd_geometry(R, W, H, whole)
    assert geo.instance == "long" and geo.args()[0] == 3
    assert geo.grid == (R, H, -(-W // 64) + 1) and geo.group == 1
    assert geo.pad == 64 and geo.threads == 128
    rows = -(-W // 64) * 64 if whole else 192
    assert geo.smem == ap.long16_bwd_bytes(W, whole) == (
        (128 + 2 * rows) * 40 * 2 + (3 * W + 1 + 16) * 4)
    assert geo.smem <= SMEM_MAX
    assert SM_SMEM // (geo.smem + BLOCK_RESERVED) >= (3 if whole else 4)
    assert ap.long16_bwd_bytes(384, True) == 76356
    assert ap.long16_bwd_bytes(1024, False) == 53316
