"""Kernel K3 (segment-masked attention over wide packed rows): the port's
plain version, forward with attention dropout and its autograd backward,
against the JAX Pallas kernel ``flash_hil_seg_qkv`` in interpret mode. The
CUDA kernels are held against the plain version on the card in
test_torch_port_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphtrans_tpu.ops.pallas.flash_hil import flash_hil_seg_qkv  # noqa: E402
from graphtrans_tpu_torch.ops.kernels import (  # noqa: E402
    flash_hil_seg, flash_hil_seg_bwd, flash_hil_seg_plain)
from graphtrans_tpu_torch.ops.kernels.flash_hil import (  # noqa: E402
    flash_hil_keep_mask)
from _heap import release_freed_heap  # noqa: E402,F401

TOL = 3e-5  # f32 online softmax over up to 1024 keys in another order
GRAD_TOL = 5e-4  # dqkv, times max(1, max |reference|)
SEED = 2**31 - 5  # the schedule's per-tile seeds wrap past int32


def _case(S, d, seed):
    """One packed row: a long segment, mid-sized ones, single-token
    segments, and a padding tail; plus one all-padding row."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((2, S, 3 * d)).astype(np.float32)
    seg = np.full((2, S), -1, np.int32)
    lens = [S // 2 + 3, 1, 40, 1, 1, 97, S // 8]
    s = 0
    for g, n in enumerate(lens):
        seg[0, s:s + n] = g
        s += n
    assert s < S                     # the tail of row 0 is padding
    return qkv, seg


@pytest.mark.parametrize("S", [640, 1024])
def test_plain_matches_jax_interpret_kernel(S):
    qkv, seg = _case(S, 128, seed=S)
    want = np.asarray(flash_hil_seg_qkv(jnp.asarray(qkv), jnp.asarray(seg), 0,
                                        4, 0.0, False, True))
    got = flash_hil_seg_plain(torch.from_numpy(qkv), torch.from_numpy(seg), 4)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert not got.numpy()[seg < 0].any()       # padding queries: exact 0
    assert not got.numpy()[1].any()             # the all-padding row
    one = np.nonzero(np.bincount(seg[seg >= 0]) == 1)[0]
    for g in one:                               # a lone token sees itself:
        i = int(np.nonzero(seg[0] == g)[0][0])  # out = its own v
        np.testing.assert_allclose(got.numpy()[0, i], qkv[0, i, 256:],
                                   atol=1e-6, rtol=0)
    # CPU tensors take the plain version through the wrapper, uncounted
    before = flash_hil_seg.launches
    again = flash_hil_seg(torch.from_numpy(qkv), torch.from_numpy(seg), 4)
    assert flash_hil_seg.launches == before
    np.testing.assert_array_equal(again.numpy(), got.numpy())


FWD_TOL = 2e-5  # the forward at code2's test tier, W 512


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_matches_jax_interpret_kernel_at_w512(rate):
    """Code2's tier of 512: a segment of 390 tokens (wider than K2's tiers,
    so only K3 takes it), single tokens, a padding tail, an all-padding
    row and a row of short segments, with the schedule's dropout: within
    FWD_TOL of the interpret kernel, padding queries exactly 0."""
    rng = np.random.default_rng(512)
    qkv = rng.standard_normal((3, 512, 384)).astype(np.float32)
    seg = np.full((3, 512), -1, np.int32)
    seg[0, :390], seg[0, 390], seg[0, 391:451] = 0, 1, 2
    seg[2, :500] = 3 + np.arange(500) // 50
    want = np.asarray(flash_hil_seg_qkv(jnp.asarray(qkv), jnp.asarray(seg),
                                        SEED, 4, rate, rate > 0, True))
    got = flash_hil_seg_plain(torch.from_numpy(qkv), torch.from_numpy(seg), 4,
                              rate, SEED).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    assert not got[seg < 0].any() and not got[1].any()


@pytest.mark.parametrize("S", [640, 1024])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_fwd_and_grad_match_jax_interpret_kernel(S, rate):
    """Forward with dropout (the same mask: the outputs agree, and another
    seed's do not) and dqkv by autograd against ``jax.vjp`` of the kernel
    in training mode; padding tokens get exact zeros."""
    qkv, seg = _case(S, 128, seed=S + 1)
    g = np.random.default_rng(S).standard_normal((2, S, 128)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda x: flash_hil_seg_qkv(
        x, jnp.asarray(seg), SEED, 4, rate, True, True), jnp.asarray(qkv))
    want_d = np.asarray(vjp(jnp.asarray(g))[0])
    leaf = torch.from_numpy(qkv).requires_grad_()
    got = flash_hil_seg_plain(leaf, torch.from_numpy(seg), 4, rate, SEED)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    scale = max(1.0, np.abs(want_d).max())
    np.testing.assert_allclose(leaf.grad.numpy(), want_d,
                               atol=GRAD_TOL * scale, rtol=0)
    assert not leaf.grad.numpy()[seg < 0].any() and not leaf.grad[1].any()
    # CPU tensors take the plain backward through the wrapper, uncounted
    before = flash_hil_seg_bwd.launches
    again = flash_hil_seg_bwd(torch.from_numpy(qkv), torch.from_numpy(seg),
                              4, torch.from_numpy(g), None, rate, SEED)
    assert flash_hil_seg_bwd.launches == before
    np.testing.assert_allclose(again.numpy(), leaf.grad.numpy(), atol=1e-6,
                               rtol=0)
    if rate > 0.0:
        other = flash_hil_seg_plain(torch.from_numpy(qkv),
                                    torch.from_numpy(seg), 4, rate, SEED + 1)
        assert np.abs(other.numpy() - np.asarray(want)).max() > 100 * TOL


def test_dropout_waits_for_the_training_slice():
    """The dropout mask follows flash_hil's schedule (a new seed every 512
    queries and 128 keys, per row and head), keeps about 1 - rate, and the
    CPU wrapper with dropout runs the plain version."""
    keep = flash_hil_keep_mask(2, 640, 4, 0.1, SEED).numpy()
    assert keep.shape == (2, 4, 640, 640) and abs(keep.mean() - 0.9) < 0.01
    tile = keep[0, 0, :512, :128]
    for other in (keep[0, 0, :512, 128:256], keep[0, 1, :512, :128],
                  keep[1, 0, :512, :128]):
        assert (tile != other).mean() > 0.1      # another tile seed
    again = flash_hil_keep_mask(2, 640, 4, 0.1, SEED).numpy()
    np.testing.assert_array_equal(again, keep)
    qkv, seg = _case(640, 128, seed=1)
    t = [torch.from_numpy(a) for a in (qkv, seg)]
    np.testing.assert_array_equal(flash_hil_seg(*t, 4, 0.1, 7).numpy(),
                                  flash_hil_seg_plain(*t, 4, 0.1, 7).numpy())
