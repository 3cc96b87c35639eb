"""K2's segment design on the CPU: the plain version against the JAX
Pallas kernel (interpret mode) at the segment lengths where the card's
kernels change instance and on a row with one graph id in two runs; every
batch the port's collate builds holds each graph's tokens as one run of
``pack_seg``; and a numpy emulation of the tile kernels' span source
(``csrc/attention_tile.cuh:SegRuns``: runs ranked 32 tokens at a time, the
row's slices staged once, each segment's tiles padded to 4 rows with the
next tokens' rows, the work items located by prefix counts) against the
plain forward and backward in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.attention_packed import (  # noqa: E402
    attention_packed_seg_qkv)
from graphtrans_tpu_torch.ops.kernels.attention_packed import (  # noqa: E402
    SEG_TILE_MAX, attention_seg_bwd_plain, attention_seg_plain, keep_mask,
    seg_score_floats, seg_sld, seg_tile_bytes)
from _heap import release_freed_heap  # noqa: E402,F401

TOL, GTOL = 2e-5, 5e-4   # forward; gradients, times max(1, max |ref|)


def _rows(W, layouts, rng):
    """seg [R, W] from per-row lists of run lengths (None: padding), the
    ids numbered in order unless a run names one (an int: that run's id)."""
    seg = np.full((len(layouts), W), -1, np.int32)
    g = 1000
    for r, runs in enumerate(layouts):
        s = 0
        for run in runs:
            n, gid = run if isinstance(run, tuple) else (run, None)
            if gid != -1:
                seg[r, s:s + n] = g if gid is None else gid
            g += 1
            s += n
    return seg, rng.standard_normal((len(layouts), W, 384)).astype(np.float32)


# segment lengths around the instances' limits (64/65, 128/129), a row
# with one id in two runs (7), an all-padding row
LAYOUTS = {
    128: [[64, 63], [65, (3, -1), 60], [128], [1, 2, 3, 4, 27, 27, 27],
          [(20, 7), 10, (15, 7), (83, -1)], [(128, -1)]],
    384: [[128, 129, (127, -1)], [384], [(150, 5), 100, (100, 5), (34, -1)],
          [64, 65, 255]],
}


@pytest.mark.parametrize("W", [128, 384])
@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.3, 2**31 - 7)])
def test_plain_matches_jax_kernel_at_instance_limits(W, rate, seed):
    rng = np.random.default_rng(W)
    seg, qkv = _rows(W, LAYOUTS[W], rng)
    g = rng.standard_normal((len(seg), W, 128)).astype(np.float32)
    f = lambda t: attention_packed_seg_qkv(t, jnp.asarray(seg), seed, 4,
                                           rate, True, True)
    want, vjp = jax.vjp(f, jnp.asarray(qkv))
    (want_dqkv,) = vjp(jnp.asarray(g))
    t_qkv, t_seg = torch.from_numpy(qkv), torch.from_numpy(seg)
    got = attention_seg_plain(t_qkv, t_seg, 4, rate, seed).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())
    dqkv = attention_seg_bwd_plain(t_qkv, t_seg, 4, torch.from_numpy(g),
                                   rate, seed).numpy()
    want_dqkv = np.asarray(want_dqkv)
    assert (np.abs(dqkv - want_dqkv).max()
            <= GTOL * max(1.0, np.abs(want_dqkv).max()))
    assert not got[seg < 0].any() and not dqkv[seg < 0].any()


def _runs_of(seg_row):
    """[(first, length)] of the runs of one id >= 0 in a row."""
    runs, i, W = [], 0, len(seg_row)
    while i < W:
        if seg_row[i] < 0:
            i += 1
            continue
        j = i
        while j < W and seg_row[j] == seg_row[i]:
            j += 1
        runs.append((i, j - i))
        i = j
    return runs


def _check_one_run_a_graph(seg, W):
    seg = np.asarray(seg).reshape(-1, W)
    assert seg.min() >= -1
    for row in seg:
        ids = [row[s] for s, _ in _runs_of(row)]
        assert len(ids) == len(set(ids))          # one run a graph id
    ids = seg[seg >= 0]
    # and a graph never spans two rows
    per_row = {g: set() for g in np.unique(ids)}
    for r, row in enumerate(seg):
        for g in np.unique(row[row >= 0]):
            per_row[g].add(r)
    assert all(len(rows) == 1 for rows in per_row.values())


def _tiers(b):
    for name in ("pack", "pack2", "pack3"):
        W = getattr(b, f"{name}_w")
        if W:
            yield getattr(b, f"{name}_seg"), W


def test_collated_pack_seg_holds_each_graph_as_one_run():
    """The fast path's assumption, on the batches the port builds: the
    molpcba snapshot, code2's three tiers (train: 1024/384/128; valid and
    test: 512/384/128) and NCI1's synthetic graphs."""
    from graphtrans_tpu_torch import predict
    from graphtrans_tpu_torch.data.loader import iterate_batches
    from graphtrans_tpu_torch.utils.config import parse_with_config

    configs = {
        "mol": "configs/molpcba/gnn-transformer/JK=cat/"
               "pooling=cls+gin+norm_input.yml",
        "code2": "configs/code2/gnn-transformer/JK=cat/"
                 "pooling=cls+norm_input.yml",
        "nci1": "configs/NCI1/gnn-transformer/no-virtual/"
                "gd=128+gdp=0.1+tdp=0.1+l=3+cosine.yml",
    }
    seen = set()
    for kind, config in configs.items():
        args = parse_with_config(predict.build_parser(), [
            "--configs", config, "--data_root", "data_snapshots", "--runs",
            "1", "--batch_size", "16" if kind == "code2" else "64"])
        splits, num_tasks, _ = predict.load_splits(args)
        for split in ("train", "valid", "test"):
            layout = predict.serving_layout(splits, args, num_tasks,
                                            split=split)
            for b in iterate_batches(splits[split], **layout):
                for seg, W in _tiers(b):
                    _check_one_run_a_graph(seg, W)
                    seen.add((kind, W))
    assert {("mol", 128), ("code2", 384), ("code2", 128)} <= seen
    assert any(k == "code2" and W > 384 for k, W in seen)
    assert any(k == "nci1" for k, _ in seen)


# ---- the tile kernels' span source, emulated --------------------------------

def _round4(n):
    return -(-n // 4) * 4


def seg_runs(row):
    """SegRuns::load on one row: (tags, problems [(s0, n)], the prefix
    counts of nr and nr^2), with warp 0's ballots 32 tokens at a time."""
    W = len(row)
    R4 = _round4(W) + 4
    tg = np.full(R4, -1, np.int64)
    tg[:W] = row
    s0, ends = [], []
    for c in range(0, W, 32):
        for lane in range(32):                 # ranks in lane order
            i = c + lane
            v = tg[i] if i < W else -1
            if v >= 0 and (i == 0 or tg[i - 1] != v):
                s0.append(i)
            if v >= 0 and tg[i + 1] != v:
                ends.append(i + 1)
    ids = [tg[s] for s in s0]
    if len(set(ids)) < len(ids):               # an id in two runs
        problems = [(0, W)]
    else:
        problems = [(s, e - s) for s, e in zip(s0, ends)]
    nr = [(n + 3) // 4 for _, n in problems]
    cnr = np.concatenate([[0], np.cumsum(nr)]).astype(int)
    cnr2 = np.concatenate([[0], np.cumsum(np.square(nr))]).astype(int)
    return tg, problems, cnr, cnr2


def _last_at_most(pre, ng, x):
    lo, hi = 0, ng - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if pre[mid] <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _check_items(problems, cnr, cnr2):
    """Every work item of each phase lands on one (problem, item) and each
    problem's items are covered once."""
    ng = len(problems)
    seen = set()
    for w in range(cnr2[ng]):
        g = _last_at_most(cnr2, ng, w)
        r = w - cnr2[g]
        assert 0 <= r < (cnr[g + 1] - cnr[g]) ** 2
        seen.add((g, r))
    assert len(seen) == cnr2[ng]
    for c in (4, 8, 16):
        seen = set()
        for w in range(c * cnr[ng]):
            g = _last_at_most(cnr, ng, w // c)
            r = w - c * cnr[g]
            assert 0 <= r < c * (cnr[g + 1] - cnr[g])
            seen.add((g, r))
        assert len(seen) == c * cnr[ng]
        if c == 16:   # four threads a row: a row's quad is lane-aligned
            assert all(c * cnr[g] % 4 == 0 for g in range(ng))


def emulate(qkv, seg, nhead, rate=0.0, seed=0, gout=None):
    """The tile kernels' arithmetic on SegRuns' layout, in float64: the
    forward (out, m, l) and, given gout, the backward's dqkv."""
    R, W, d3 = qkv.shape
    d = d3 // 3
    hd = d // nhead
    R4 = _round4(W) + 4
    keep = (keep_mask(R, W, nhead, rate, seed, "cpu").numpy()
            if rate > 0 else None)
    inv_keep = 1.0 / (1.0 - rate)
    out = np.zeros((R, W, d))
    m_all = np.full((R, W, nhead), -np.inf)
    l_all = np.zeros((R, W, nhead))
    dqkv = np.zeros((R, W, d3))
    for r in range(R):
        tg, problems, cnr, cnr2 = seg_runs(seg[r])
        _check_items(problems, cnr, cnr2)
        score = sum(_round4(n) * seg_sld(_round4(n)) for _, n in problems)
        assert score <= seg_score_floats(W)
        assert 4 * score < seg_tile_bytes(W, hd, False)
        for h in range(nhead):
            st = np.zeros((3, R4, hd))         # staged Q, K, V; zero rows
            for k in range(3):
                st[k, :W] = qkv[r, :, k * d + h * hd:k * d + (h + 1) * hd]
            G = np.zeros((R4, hd))
            if gout is not None:
                G[:W] = gout[r, :, h * hd:(h + 1) * hd]
            for s0, n in problems:
                np_ = _round4(n)
                Q, K, V = (st[k, s0:s0 + np_] for k in range(3))
                t = tg[s0:s0 + np_]
                meets = (t[None, :] >= 0) & (t[:, None] == t[None, :])
                s = np.where(meets, Q @ K.T / np.sqrt(hd), -np.inf)
                m = s.max(axis=1)
                e = np.where(np.isfinite(m)[:, None],
                             np.exp(s - np.where(np.isfinite(m), m, 0)[:, None]),
                             0.0)
                e = np.where(meets, e, 0.0)
                l = e.sum(axis=1)
                kp = np.ones((R4, R4), bool)     # keep, drawn at (s0 + i,
                if keep is not None:               # s0 + j) of the row
                    kp[:W, :W] = keep[r, h]
                kp = kp[s0:s0 + np_, s0:s0 + np_]
                pd = np.where(kp, e, 0.0) * (inv_keep if keep is not None
                                              else 1.0)
                li = 1.0 / np.maximum(l, 1e-16)
                o = (pd[:, :_round4(n)] @ V[:_round4(n)]) * li[:, None]
                out[r, s0:s0 + n, h * hd:(h + 1) * hd] = o[:n]
                m_all[r, s0:s0 + n, h] = m[:n]
                l_all[r, s0:s0 + n, h] = l[:n]
                if gout is None:
                    continue
                Gp = G[s0:s0 + np_]
                delta = (Gp * np.pad(o[:n], ((0, np_ - n), (0, 0)))).sum(1)
                p = e * li[:, None]                  # undropped
                dp = Gp @ V.T
                if keep is not None:
                    dp = np.where(kp, dp * inv_keep, 0.0)
                    pdrop = np.where(kp, p * inv_keep, 0.0)
                else:
                    pdrop = p
                valid = (np.arange(np_) < n)[:, None] & meets
                ds = np.where(valid, p * (dp - delta[:, None]), 0.0)
                pdrop = np.where(valid, pdrop, 0.0)
                sl = slice(s0, s0 + n)
                scale = 1.0 / np.sqrt(hd)
                dqkv[r, sl, h * hd:(h + 1) * hd] = (ds @ K)[:n] * scale
                dqkv[r, sl, d + h * hd:d + (h + 1) * hd] = (
                    ds[:n].T @ Q[:n])[:n] * scale
                dqkv[r, sl, 2 * d + h * hd:2 * d + (h + 1) * hd] = (
                    pdrop[:n].T @ Gp[:n])[:n]
    return out, m_all, l_all, dqkv


EMULATED = {
    128: [[27, 26, 28, 25, (22, -1)], [64, 64], [65, (63, -1)], [128],
          [1] * 40 + [(88, -1)], [(20, 7), 10, (15, 7), (83, -1)],
          [(128, -1)], [126, 2]],
    40: [[10, (3, -1), 9, 12, (6, -1)], [(5, 2), 5, (5, 2), (25, -1)]],
    37: [[10, (3, -1), 9, 12, (3, -1)], [(5, 2), 5, (5, 2), (22, -1)], [37]],
}


@pytest.mark.parametrize("W", sorted(EMULATED))
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_seg_runs_emulation_matches_plain(W, rate):
    """The tile instance's problems, layout and work items reproduce K2 in
    float64: forward, m and l (their log-sum-exp), and the backward."""
    assert W <= SEG_TILE_MAX
    rng = np.random.default_rng(W + int(10 * rate))
    seg, _ = _rows(W, EMULATED[W], rng)
    qkv = rng.standard_normal((len(seg), W, 3 * 64))
    g = rng.standard_normal((len(seg), W, 64))
    seed = 12345
    out, m, l, dqkv = emulate(qkv, seg, 2, rate, seed, g)
    t_qkv, t_seg = torch.from_numpy(qkv), torch.from_numpy(seg)
    want = attention_seg_plain(t_qkv, t_seg, 2, rate, seed).numpy()
    np.testing.assert_allclose(out, want, atol=1e-12, rtol=0)
    want_d = attention_seg_bwd_plain(t_qkv, t_seg, 2, torch.from_numpy(g),
                                     rate, seed).numpy()
    np.testing.assert_allclose(dqkv, want_d, atol=1e-11, rtol=0)
    live = seg >= 0
    s = (qkv[..., :64].reshape(len(seg), W, 2, 32).transpose(0, 2, 1, 3)
         @ qkv[..., 64:128].reshape(len(seg), W, 2, 32).transpose(0, 2, 3, 1)
         / np.sqrt(32))
    meet = (seg[:, :, None] == seg[:, None, :]) & live[:, None, :]
    s = np.where(meet[:, None], s, -np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):   # padding rows
        lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
        got = m + np.log(l)
    np.testing.assert_allclose(got[live], lse.transpose(0, 2, 1)[live],
                               atol=1e-12)
    assert (m[~live] == -np.inf).all() and (l[~live] == 0).all()
