"""K2, the max-over-ground-truths corner confidence: the port's
``max_corner_confidence`` on the CPU (its plain PyTorch version) against the
JAX package's ``pallas_kernels.max_corner_confidence`` in interpret mode.

The same numpy inputs, made from a seed, go through both, at rtol 1e-5,
atol 1e-6 (the two libraries' exp and mean round differently in the last
ulp), over the valid-slot patterns the kernel packs differently: one slot
(single-object LINEMOD), eight (about an OCCLUSION frame), all fifty, a
scattered mask that is no prefix, and one image with none beside full ones;
a keypoint exactly at the 80 px threshold and one ulp inside it; two slots
tied for a cell's max; and no slot at all (G = 0).  ``tests/
test_torch_cuda.py`` holds the CUDA kernel to its plain version on the same
patterns.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singleshotpose_tpu.ops.pallas_kernels import \
    max_corner_confidence as jax_max_corner_confidence

from singleshotpose_tpu_torch.ops import max_corner_confidence as TK

from torch_port_helpers import K2_PATTERNS, k2_inputs, k2_valid

K = 9
SHAPES = [(8, 50, 169), (2, 50, 676)]     # (B, G, S)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(gt, valid, pred):
    """(the port on the CPU, the JAX kernel in interpret mode)."""
    before = TK.max_corner_confidence.launches
    got = TK.max_corner_confidence(_t(gt), _t(valid), _t(pred)).numpy()
    assert TK.max_corner_confidence.launches == before    # no kernel on CPU
    want = np.asarray(jax_max_corner_confidence(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(pred),
        interpret=True))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    return got


@pytest.mark.parametrize("B,G,S", SHAPES)
@pytest.mark.parametrize("pattern", K2_PATTERNS)
def test_k2_matches_jax_on_valid_patterns(pattern, B, G, S):
    rng = np.random.RandomState(B * S + len(pattern))
    valid = k2_valid(pattern, B, G, rng)
    gt, pred = k2_inputs(valid, S, rng)
    got = _both(gt, valid, pred)
    has = valid.any(axis=1)
    assert not got[~has].any()              # an image with no slot: zeros
    live = got[has]
    assert (live > 0.6).any() and ((live > 0) & (live < 0.6)).any()


@pytest.mark.parametrize("B,G,S", SHAPES)
def test_k2_takes_a_float_validity(B, G, S):
    rng = np.random.RandomState(B + S)
    valid = k2_valid("scattered", B, G, rng)
    gt, pred = k2_inputs(valid, S, rng)
    got = _both(gt, valid.astype(np.float32), pred)
    np.testing.assert_array_equal(
        got, TK.max_corner_confidence(_t(gt), _t(valid), _t(pred)).numpy())


@pytest.mark.parametrize("where", ["at", "inside"])
def test_k2_at_the_80px_threshold(where):
    """Every keypoint's x is 0.125 of 640 px = 80 px from the GT (d = 80,
    c = 0: the test is d < th), or one ulp of the prediction closer."""
    gt = np.full((1, 2, 2 * K), 0.5, np.float32)
    gt[0, 1] = 0.2                          # an invalid slot, never read
    px = np.float32(0.375)
    if where == "inside":
        px = np.nextafter(px, np.float32(1))
    pred = np.full((1, 2, 2 * K), 0.5, np.float32)
    pred[0, 0, 0::2] = px                   # cell 0 at the threshold
    valid = np.array([[True, False]])       # cell 1 exactly on the GT
    got = _both(gt, valid, pred)
    if where == "at":
        assert got[0, 0] == 0.0
    else:
        assert 0.0 < got[0, 0] < 1e-6
    assert got[0, 1] == pytest.approx(1.0, abs=1e-5)


def test_k2_with_two_slots_tied():
    """Slots 2 and 5 hold the same GT: each cell's max is their one mean."""
    rng = np.random.RandomState(3)
    B, G, S = 2, 8, 40
    valid = np.zeros((B, G), bool)
    valid[:, [2, 5]] = True
    gt, pred = k2_inputs(valid, S, rng)
    gt[:, 5] = gt[:, 2]
    got = _both(gt, valid, pred)
    one = valid.copy()
    one[:, 5] = False
    np.testing.assert_array_equal(
        got, TK.max_corner_confidence(_t(gt), _t(one), _t(pred)).numpy())
    assert (got > 0.6).any()


def test_k2_with_no_slot():
    """G = 0 gives zeros.  The JAX function cannot reduce over no slot, so
    its value for one slot that is not valid stands in."""
    rng = np.random.RandomState(4)
    B, S = 3, 169
    pred = rng.uniform(0, 1, (B, S, 2 * K)).astype(np.float32)
    got = TK.max_corner_confidence(torch.zeros((B, 0, 2 * K)),
                                   torch.zeros((B, 0), dtype=torch.bool),
                                   _t(pred)).numpy()
    assert got.shape == (B, S) and got.dtype == np.float32
    want = np.asarray(jax_max_corner_confidence(
        jnp.asarray(rng.uniform(0, 1, (B, 1, 2 * K)).astype(np.float32)),
        jnp.zeros((B, 1), bool), jnp.asarray(pred), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not got.any()
