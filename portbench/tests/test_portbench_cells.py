"""The serve runner end to end on the CPU at a tiny size: the program's
serve agrees with the plain reference (``correct``), and a run whose timed
path is broken underneath comes out not correct, once for each fault a
cell can have: a wrong answer where it is produced (two frames' answers
swapped; the per-class fold returning another kept cell than the rule's),
half of the batch left out, and a stale answer.  The lower-precision
control comes out not correct too."""

from __future__ import annotations

import pytest
import torch

from portbench.lib import harness
from portbench.reference import controls
from portbench.tests import tiny


def _swap_first_two(serve, parts):
    def f(images):
        out = serve(images).clone()
        out[[0, 1]] = out[[1, 0]]
        return out
    return f


def _half_batch(serve, parts):
    def f(images):
        images = torch.as_tensor(images).clone()
        half = images.shape[0] // 2
        images[half:] = images[:half]
        return serve(images)
    return f


def _stale(serve, parts):
    last = []

    def f(images):
        out = serve(images)
        answer = last[0] if last else out
        last[:] = [out]
        return answer
    return f


def _any_kept_cell(serve, parts):
    """The per-class fold returning, for each class, the kept cell of the
    lowest objectness instead of the highest (the same where one is kept)."""
    from singleshotpose_tpu_torch import serving
    grid_fn = serving.make_serving_fn(parts["spec"], parts["folded"],
                                      pick=("grid",))
    th = float(parts["pick"][1])

    def f(images):
        out = serve(images).clone()
        corners, det, probs = grid_fn(images)
        B, S, C = probs.shape
        K2 = corners.shape[-1]
        cmax, cid = probs.max(-1)
        keep = ((det * cmax) > th)[:, None, :] & \
            (cid[:, None, :] == torch.arange(C, device=cid.device)[None, :,
                                                                 None])
        low = torch.where(keep, det[:, None, :], float("inf")).argmin(-1)
        b = torch.arange(B, device=cid.device)[:, None]
        kept = keep.any(-1)
        alt = torch.cat([corners[b, low], det[b, low][..., None],
                         cmax[b, low][..., None]], -1).to(out.dtype)
        out[..., :K2 + 2] = torch.where(kept[..., None], alt,
                                        out[..., :K2 + 2])
        return out
    return f


@pytest.mark.parametrize("kind", sorted(tiny.CELLS))
def test_program_agrees_with_reference(kind):
    out = tiny.run(kind)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert harness.correct(out), out["checks"]


@pytest.mark.parametrize("kind, name, fault", [
    ("serve", "serve", _swap_first_two),
    ("serve", "serve", _half_batch),
    ("serve", "serve", _stale),
    ("serve_multi", "serve", _swap_first_two),
    ("serve_multi", "serve", _half_batch),
    ("serve_multi", "serve", _stale),
    ("serve_multi", "serve", _any_kept_cell),
], ids=lambda v: getattr(v, "__name__", v))
def test_broken_timed_path_is_not_correct(kind, name, fault):
    out = tiny.run(kind, {name: fault})
    assert not harness.correct(out), out["checks"]


@pytest.mark.parametrize("kind", ["serve", "serve_multi"])
def test_fp8_control_is_not_correct(kind):
    """The serve cells' control: the reference in fp8 in the program's
    place."""
    torch.set_num_threads(2)
    c = tiny.cell(kind)
    ctx = tiny.Context(c)
    ctx.program = lambda name, build, **parts: controls.stand_in(
        "fp8", name, ctx, build, parts)
    out = c.runner().run(ctx)
    assert not harness.correct(out), out["checks"]
