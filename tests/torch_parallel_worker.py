"""A jax-free worker for tests/test_torch_parallel.py: the port's
data-parallel paths on gloo ranks on the CPU.

    python torch_parallel_worker.py steps WORKDIR
        two spawned gloo ranks run the step-level checks on WORKDIR/
        inputs.npz (and the states and cfgs beside it) and the bank
        backends' rows over WORKDIR/corpus and WORKDIR/occ, and each writes
        WORKDIR/rank<r>.npz;
    python torch_parallel_worker.py cli ARGS...
        ``singleshotpose_tpu_torch.cli.main(ARGS)`` (``--dp N`` starts its
        ranks itself).

``jax`` and ``singleshotpose_tpu`` are blocked before anything is imported,
here and in every spawned rank (a spawned child runs this module's top level
again as its ``__mp_main__``), so the port's data-parallel paths are shown
to run without them.
"""

import json
import os
import sys

sys.modules["jax"] = None                  # any `import jax` now raises
sys.modules["singleshotpose_tpu"] = None   # and so does the JAX package
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)     # the ranks share the test run's cores

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from singleshotpose_tpu_torch.models import layers as L  # noqa: E402
from singleshotpose_tpu_torch.models.darknet import (Darknet,  # noqa: E402
                                                     DarknetSpec)
from singleshotpose_tpu_torch.ops import stem  # noqa: E402
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig  # noqa: E402
from singleshotpose_tpu_torch.ops.max_corner_confidence import (  # noqa: E402
    max_corner_confidence)
from singleshotpose_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed)
from singleshotpose_tpu_torch.parallel.sharding import (  # noqa: E402
    DPGroup, all_reduce_grads, free_port, make_dp_group, pad_rows,
    shard_host_batch)
from singleshotpose_tpu_torch.training import (  # noqa: E402
    init_train_state, make_train_step, shard_train_state)
# the bank backends' rows and preflight under a group, as the grid's
# worker takes them
from torch_tp_worker import _bank_rows, _preflight  # noqa: E402

WORLD = 2
LR, EPOCH, DECAY, MOMENTUM = 0.00025, 100, 0.002, 0.9
STEPS = 3
# (tag, compute dtype, fused stem): the f32 step and the bf16 step through
# the fused train stem
RUNS = (("f32", None, False), ("bf16", torch.bfloat16, True))


def _param(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), requires_grad=True)


def _stem(inp, group, out) -> None:
    """The fused train stem on this rank's rows, its parameter gradients
    summed over the ranks as the train step sums them."""
    img, cot = shard_host_batch(group, torch.from_numpy(inp["stem_img"]),
                                torch.from_numpy(inp["stem_cot"]))
    w, scale, bias = (_param(inp[k]) for k in
                      ("stem_w", "stem_scale", "stem_bias"))
    pooled, mean, var = stem.stem_conv_bn_pool_train(img, w, scale, bias,
                                                     group=group)
    (pooled.float() * cot).sum().backward()
    all_reduce_grads([w, scale, bias], group)
    out.update(stem_pooled=pooled.float(), stem_mean=mean, stem_var=var,
               stem_dw=w.grad, stem_dscale=scale.grad, stem_dbias=bias.grad)


def _bn(inp, group, out) -> None:
    """Sync-BN ``batch_norm_train`` on this rank's rows: the output, the
    statistics and the gradients (the input's for these rows; scale's and
    bias's summed over the ranks)."""
    x, cot = shard_host_batch(group, torch.from_numpy(inp["bn_x"]),
                              torch.from_numpy(inp["bn_cot"]))
    x = x.clone().requires_grad_(True)
    scale, bias = _param(inp["bn_scale"]), _param(inp["bn_bias"])
    y, mean, var = L.batch_norm_train(x, scale, bias, group=group)
    (y * cot).sum().backward()
    all_reduce_grads([scale, bias], group)
    out.update(bn_y=y, bn_mean=mean, bn_var=var, bn_dx=x.grad,
               bn_dscale=scale.grad, bn_dbias=bias.grad)


def _state(workdir, tag, group=None):
    with open(os.path.join(workdir, f"{tag}_blocks.json")) as f:
        model = Darknet(DarknetSpec(json.load(f)))
    model.load_state_dict(torch.load(os.path.join(workdir, f"{tag}.pt"),
                                     weights_only=True))
    state = init_train_state(model, weight_decay=DECAY, momentum=MOMENTUM)
    if group is not None:
        shard_train_state(group, state)
    return state


def _flat_state(state, prefix: str) -> dict:
    """Every tensor of the state — parameters, BN statistics, momentum —
    and ``seen``, keyed under ``prefix``."""
    out = {f"{prefix}/{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        out[f"{prefix}/momentum/{name}"] = \
            state.optimizer.state[p]["momentum_buffer"].clone()
    out[f"{prefix}/seen"] = torch.tensor(state.seen)
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _steps(inp, workdir, group, out) -> None:
    """Per run: the data-parallel step on this rank's rows, STEPS times
    from one state (the state after the first and after the last kept), the
    fused stem's calls counted."""
    calls = []
    real = stem.stem_conv_bn_pool_train
    stem.stem_conv_bn_pool_train = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for tag, dtype, fused in RUNS:
            state = _state(workdir, tag, group)
            step = make_train_step(RegionLossConfig(), compute_dtype=dtype,
                                   fused_stem=fused, group=group)
            images, target = shard_host_batch(
                group, torch.from_numpy(inp[f"{tag}_images"]),
                torch.from_numpy(inp[f"{tag}_target"]))
            del calls[:]
            losses = []
            for i in range(STEPS):
                losses.append(step(state, images, target, LR, EPOCH)["loss"])
                if i == 0:
                    out.update(_flat_state(state, f"{tag}/step1"))
            out.update(_flat_state(state, f"{tag}/last"))
            out[f"{tag}/losses"] = torch.stack(losses)
            out[f"{tag}/stem_calls"] = torch.tensor(len(calls))
    finally:
        stem.stem_conv_bn_pool_train = real


def _train(workdir, group, out) -> None:
    """``run_training`` on this rank's shard of the corpus under
    WORKDIR/corpus for one epoch, with the in-training eval (rows of ragged
    batches of 3 over the ranks) after it."""
    from singleshotpose_tpu_torch.drivers import TrainRunConfig, run_training
    rc = TrainRunConfig(eval_every=1, eval_after=-1, num_workers=0,
                        eval_batch_size=3, bg_dir="/nonexistent", log_every=1,
                        max_epochs_override=1, compute_dtype=None,
                        device="cpu", group=group)
    corpus = os.path.join(workdir, "corpus")
    r = run_training(os.path.join(corpus, "synth.data"),
                     os.path.join(corpus, "tiny.cfg"), None, 100, rc)
    hist = r["history"]
    for k in ("training_losses", "testing_accuracies", "testing_errors_pixel"):
        out[f"train/{k}"] = torch.tensor(hist[k], dtype=torch.float64)
    out.update(_flat_state(r["state"], "train/state"))


def _ragged_eval(workdir, group, out) -> None:
    """``drivers._eval_pass`` over the ranks on 7 of the corpus's frames in
    batches of 4 (the second ragged: 3 rows, zero-padded to 4), and in this
    process alone serving the same padded rows (each rank's 2 rows a call,
    concatenated in rank order, the pad row dropped): both artifacts kept,
    for the parent to hold bit for bit."""
    from singleshotpose_tpu_torch import drivers
    from singleshotpose_tpu_torch.config import (data_config_from_options,
                                                 read_data_cfg)
    from singleshotpose_tpu_torch.data.pipeline import Loader, PoseDataset
    from singleshotpose_tpu_torch.evaluate import EvalContext
    corpus = os.path.join(workdir, "corpus")
    dcfg = data_config_from_options(
        read_data_cfg(os.path.join(corpus, "synth.data")))
    spec = DarknetSpec.from_cfg(os.path.join(corpus, "tiny.cfg"))
    model = Darknet(spec)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        # random weights: each frame then has its own box (a fresh net's
        # head gives every frame the same one)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    ctx = EvalContext.from_data_config(dcfg)

    def loader():
        ds = PoseDataset(dcfg.valid, train=False)
        ds.lines = ds.lines[:7]
        return Loader(ds, 4, shuffle=False, schedule=None,
                      fixed_shape=(spec.net.test_width, spec.net.test_height),
                      num_workers=0, drop_last=False, out_uint8=True)

    real = drivers.make_serving_fn

    def rows_alone(*a, **k):
        serve = real(*a, **k)
        return lambda images: torch.cat(
            [serve(c) for c in pad_rows(torch.as_tensor(images),
                                        WORLD).chunk(WORLD)])[:len(images)]

    for tag, g in (("ranks", group), ("alone", None)):
        drivers.make_serving_fn = real if g is not None else rows_alone
        try:
            _, art = drivers._eval_pass(spec, model, loader(), ctx,
                                        compute_dtype=None, device="cpu",
                                        group=g)
        finally:
            drivers.make_serving_fn = real
        for k in ("corners_gt", "corners_pr", "image_idx"):
            out[f"ragged/{tag}/{k}"] = torch.from_numpy(art[k])
        for k, v in art["metrics"].items():
            out[f"ragged/{tag}/metrics/{k}"] = torch.from_numpy(
                np.asarray(v))


def _rank(rank: int, port: int, workdir: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=WORLD, rank=rank)
    group = make_dp_group(WORLD, device="cpu")
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    out = {}
    _stem(inp, group, out)
    _bn(inp, group, out)
    # K2 on this rank's rows, with no collective
    gt, valid = shard_host_batch(group, torch.from_numpy(inp["k2_gt"]),
                                 torch.from_numpy(inp["k2_valid"]))
    pred, _ = shard_host_batch(group, torch.from_numpy(inp["k2_pred"]), gt)
    out["k2"] = max_corner_confidence(gt, valid, pred)
    _steps(inp, workdir, group, out)
    # a group of this rank alone against no group, on the whole batch: the
    # same bits (a collective over one rank returns its input); every rank
    # makes every subgroup, in the same order (new_group's rule)
    ones = [dist.new_group([r]) for r in range(WORLD)]
    one = DPGroup("cpu", ones[rank])
    for tag, dtype, fused in RUNS:
        bits = []
        for g in (None, one):
            state = _state(workdir, tag)
            step = make_train_step(RegionLossConfig(), compute_dtype=dtype,
                                   fused_stem=fused, group=g)
            stats = step(state, torch.from_numpy(inp[f"{tag}_images"]),
                         torch.from_numpy(inp[f"{tag}_target"]), LR, EPOCH)
            bits.append(_flat_state(state, "s") | {"loss": stats["loss"]})
        out[f"{tag}/group_of_one_equal"] = torch.tensor(all(
            torch.equal(_bytes(bits[0][k]), _bytes(bits[1][k]))
            for k in bits[0]))
    _train(workdir, group, out)
    _ragged_eval(workdir, group, out)
    _bank_rows(workdir, group, out)
    _preflight(group, out)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
    dist.destroy_process_group()


def _spawn(fn, *args) -> None:
    """``fn(rank, port, *args)`` on WORLD spawned ranks; a rendezvous port
    lost to another process between its bind and the ranks' is retried."""
    for attempt in range(3):
        try:
            mp.spawn(fn, args=(free_port(), *args), nprocs=WORLD, join=True)
            return
        except mp.ProcessRaisedException as e:
            if attempt == 2 or "Address already in use" not in str(e):
                raise


def main(argv) -> int:
    if argv[0] == "steps":
        _spawn(_rank, argv[1])
        print("WORKER_OK")
        return 0
    if argv[0] == "cli":
        from singleshotpose_tpu_torch.cli import main as cli
        return cli(argv[1:])
    raise SystemExit(f"unknown mode {argv[0]!r}")


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
