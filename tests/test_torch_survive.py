"""A run that survives, at the port's ``Trainer`` on the CPU: mid-epoch
preemption and resume, the ``--on_nan`` policies, the guard's rollback,
torn heads and torn ``data_state`` records, and the refusals of the
resident path.

Tolerances: none.  The streaming epochs run a narrow VGG (32 images of
``synthetic``, batch 8, 4 steps an epoch, host crop/flip) or, for the
loss spike, DeepNN (no BatchNorm to absorb a scaled input).  A SIGTERM
before step 5 or 9 stops the run at the same ``(epoch, offset)`` as JAX's
streaming ``Trainer`` at the same loader shape, and ``--resume`` from its
emergency checkpoint lands on the uninterrupted run's weights, BatchNorm
buffers, momentum, step and losses bit for bit: batch content is a
function of ``(seed, epoch, k)`` and each step's draws of ``(seed, epoch,
step)``, so the resumed run repeats the same arithmetic.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from ddp_tpu.data import TrainLoader as JTrainLoader
from ddp_tpu.data import synthetic as jsynthetic
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim import SGDConfig as JSGDConfig
from ddp_tpu.optim import triangular_lr as jlr
from ddp_tpu.parallel import make_mesh
from ddp_tpu.resilience import faults as jfaults
from ddp_tpu.resilience.preemption import PreemptionGuard as JGuard
from ddp_tpu.resilience.preemption import \
    PreemptionInterrupt as JPreemptionInterrupt
from ddp_tpu.train import Trainer as JTrainer
from ddp_tpu.train import load_checkpoint as jload_checkpoint
from ddp_tpu_torch import cli
from ddp_tpu_torch.data import TrainLoader, synthetic
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.resilience import faults
from ddp_tpu_torch.resilience.guard import NonFiniteLossError
from ddp_tpu_torch.resilience.preemption import (PreemptionGuard,
                                                 PreemptionInterrupt)
from ddp_tpu_torch.train.checkpoint import CheckpointError, load_checkpoint
from ddp_tpu_torch.train.trainer import Trainer

NARROW = [8, "M", 16, "M", 512, "M"]
SEED, LR, BATCH, N = 3, 0.05, 8, 32
STEPS = N // BATCH  # an epoch's steps
CPU = torch.device("cpu")


def _trainer(path, *, epochs=3, resume=False, model=None, resident=False,
             **kw) -> Trainer:
    ds, _ = synthetic(n_train=N, n_test=8, seed=1)
    loader = TrainLoader(ds, BATCH, seed=SEED, augment=not resident,
                         local_replicas=[0])
    sched = functools.partial(triangular_lr, base_lr=LR, num_epochs=epochs,
                              steps_per_epoch=STEPS)
    model = model or VGG(NARROW, generator=torch.Generator().manual_seed(0))
    return Trainer(model, loader, device=CPU, lr_schedule=sched,
                   sgd_config=SGDConfig(lr=LR), seed=SEED,
                   snapshot_path=path, resume=resume, resident=resident,
                   **kw)


def _state(tr: Trainer):
    sd = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    return sd, [m.clone() for m in tr.state.momentum], tr.state.step


def _assert_bit_equal(a, b):
    (sa, ma, step_a), (sb, mb, step_b) = a, b
    assert step_a == step_b
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(ma, mb))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    tr = _trainer(str(tmp_path_factory.mktemp("full") / "full.pt"),
                  save_every=100)
    tr.train(3)
    return _state(tr), list(tr.loss_history)


def _jax_stop(tmp_path, kill_step: int) -> dict:
    """JAX's streaming trainer at the same loader shape (one replica of
    batch 8 over 32 images), SIGTERM before ``kill_step``: its emergency
    checkpoint's data_state."""
    ds, _ = jsynthetic(n_train=N, n_test=8, seed=1)
    loader = JTrainLoader(ds, per_replica_batch=BATCH, num_replicas=1,
                          seed=SEED)
    model = jget_model("deepnn")
    params, stats = model.init(jax.random.key(0))
    sched = functools.partial(jlr, base_lr=LR, num_epochs=3,
                              steps_per_epoch=len(loader))
    path = str(tmp_path / "jax.pt")
    guard = JGuard().install()
    try:
        tr = JTrainer(model, loader, params, stats, mesh=make_mesh(1),
                      lr_schedule=sched, sgd_config=JSGDConfig(lr=LR),
                      save_every=100, snapshot_path=path, seed=SEED,
                      preemption=guard)
        jfaults.sigterm_at_step(tr, kill_step)
        with pytest.raises(JPreemptionInterrupt):
            tr.train(3)
    finally:
        guard.uninstall()
    return jload_checkpoint(path).data_state


@pytest.mark.parametrize("kill_step", [5, 9])
def test_midepoch_sigterm_resume_bit_equal(kill_step, uninterrupted,
                                           tmp_path, capfd):
    """SIGTERM before step ``kill_step`` -> the emergency checkpoint at the
    next step boundary, mid-epoch, at JAX's ``(epoch, offset)``; its
    manifest's head carries the same data_state; ``resume`` fast-forwards
    to that batch and ends bit for bit on the uninterrupted run."""
    want_state, want_losses = uninterrupted
    path = str(tmp_path / "half.pt")
    guard = PreemptionGuard().install()
    try:
        half = _trainer(path, save_every=100, preemption=guard)
        faults.sigterm_at_step(half, kill_step)
        with pytest.raises(PreemptionInterrupt):
            half.train(3)
    finally:
        guard.uninstall()
    err = capfd.readouterr().err
    assert "preemption notice" in err and "emergency checkpoint" in err
    ds = load_checkpoint(path).data_state
    assert ds["epoch"] * STEPS + ds["offset"] == kill_step + 1
    assert 0 < ds["offset"] < STEPS
    assert (ds["version"], ds["seed"], ds["rng_folds"]) == (1, SEED, 0)
    with open(path + ".manifest.json") as f:
        assert json.load(f)["head"]["data_state"] == ds
    assert _jax_stop(tmp_path, kill_step) == ds

    resumed = _trainer(path, save_every=100, resume=True)
    assert (resumed.start_epoch, resumed._resume_offset) == \
        (ds["epoch"], ds["offset"])
    resumed.train(3)
    assert "fast-forwarding epoch" in capfd.readouterr().out
    _assert_bit_equal(_state(resumed), want_state)
    assert resumed.loss_history == want_losses[kill_step + 1:]


def test_resident_stops_at_the_epoch_boundary(tmp_path):
    """The resident path's stop point is the epoch: SIGTERM after epoch 0
    (save_every 2, so the gate skipped it) takes epoch 0's checkpoint."""
    path = str(tmp_path / "res.pt")
    guard = PreemptionGuard().install()
    try:
        tr = _trainer(path, resident=True, save_every=2, preemption=guard)
        faults.sigterm_at_epoch(tr, 0)
        with pytest.raises(PreemptionInterrupt):
            tr.train(3)
    finally:
        guard.uninstall()
    ck = load_checkpoint(path)
    assert (ck.epoch, ck.step) == (0, STEPS)
    assert ck.data_state["epoch"] == 1 and ck.data_state["offset"] == 0


def test_resident_refuses_midepoch_files_and_the_drift_audit(tmp_path):
    path = str(tmp_path / "half.pt")
    guard = PreemptionGuard().install()
    try:
        half = _trainer(path, preemption=guard)
        faults.sigterm_at_step(half, 1)
        with pytest.raises(PreemptionInterrupt):
            half.train(1)
    finally:
        guard.uninstall()
    with pytest.raises(CheckpointError, match="drop --resident"):
        _trainer(path, resident=True, resume=True)
    with pytest.raises(ValueError, match="drift_audit_every"):
        _trainer(None, resident=True, drift_audit_every=2)
    with pytest.raises(ValueError, match="drift_audit_every"):
        cli.main(["1", "1", "--batch_size", "8", "--resident", "--synthetic",
                  "--synthetic_size", "16", "--device", "cpu",
                  "--drift_audit_every", "2", "--snapshot_path",
                  str(tmp_path / "c.pt")])


@pytest.mark.parametrize("policy", ["abort", "skip", "restore"])
def test_on_nan_policies(policy, tmp_path, capfd):
    """A NaN loss at step 5 (epoch 1): ``abort`` raises before epoch 1 is
    saved; ``skip`` goes on with the NaN recorded; ``restore`` reloads the
    epoch-0 file, re-keys the draws (``rng_folds`` 1 in every later file
    and in ``data_state()``) and completes with finite losses, one a
    step."""
    path = str(tmp_path / "ck.pt")
    tr = _trainer(path, on_nan=policy)
    faults.poison_loss(tr, STEPS + 1)
    if policy == "abort":
        with pytest.raises(NonFiniteLossError, match="step"):
            tr.train(3)
        assert load_checkpoint(path).epoch == 0
        return
    tr.train(3)
    assert tr.state.step == 3 * STEPS
    if policy == "skip":
        assert "--on_nan skip" in capfd.readouterr().err
        assert np.isnan(tr.loss_history).any()
        return
    assert "restored last-good checkpoint" in capfd.readouterr().err
    assert tr.restores == 1 and tr.data_state()["rng_folds"] == 1
    assert len(tr.loss_history) == 3 * STEPS
    assert np.isfinite(tr.loss_history).all()
    ck = load_checkpoint(path)
    assert ck.epoch == 2 and ck.data_state["rng_folds"] == 1


def test_on_nan_restore_budget_exhausts(tmp_path):
    tr = _trainer(str(tmp_path / "ck.pt"), on_nan="restore")
    tr._health.max_restores = 2
    orig = tr._flush_losses

    def always_poison(epoch, start_step, losses):  # a persistent divergence
        if start_step + len(losses) > STEPS:
            losses = list(losses[:-1]) + [float("nan")]
        return orig(epoch, start_step, losses)

    tr._flush_losses = always_poison
    with pytest.raises(NonFiniteLossError, match="budget exhausted"):
        tr.train(3)
    assert tr.restores == 2


def test_guard_spike_rollback_skips_poisoned_window(tmp_path, capfd):
    """The batch of step 9 at 40 times its raw pixels spikes DeepNN's
    loss; ``rollback`` restores the epoch-1 file and drops the condemned
    batches on the replay: fewer steps than 4 epochs, every loss finite,
    no step probe call for a dropped batch."""
    tr = _trainer(str(tmp_path / "ck.pt"), epochs=4,
                  model=get_model("deepnn"), guard_spike_factor=2.0,
                  guard_window=8, guard_action="rollback")
    probed = []
    tr._step_probe = probed.append
    faults.poison_batch(tr, 2 * STEPS + 1, scale=40)
    tr.train(4)
    assert "poisoned batch window" in capfd.readouterr().err
    assert tr._health.decisions["spike_rollback"] == 1
    skipped = sorted(k for e, k in tr._skip_batches if e == 2)
    assert skipped and tr.state.step == 4 * STEPS - len(skipped)
    assert np.isfinite(tr.loss_history).all()
    assert len(tr.loss_history) == tr.state.step
    # Probed after every step run: the final trajectory's and the
    # discarded first pass over epoch 2.
    assert len(probed) == tr.state.step + STEPS


def test_resume_falls_back_on_a_torn_head(tmp_path, capfd):
    path = str(tmp_path / "ck.pt")
    _trainer(path, keep_checkpoints=2).train(2)
    faults.tear_file(path)
    res = _trainer(path, keep_checkpoints=2, resume=True)
    out = capfd.readouterr()
    assert "FALLBACK" in out.err and "fallback snapshot" in out.out
    assert (res.start_epoch, res.state.step) == (1, STEPS)
    res.train(3)
    assert load_checkpoint(path).epoch == 2


def test_torn_data_state_degrades_to_epoch_boundary(tmp_path, capfd):
    path = str(tmp_path / "ck.pt")
    _trainer(path).train(2)
    faults.torn_data_state(path)
    res = _trainer(path, resume=True)
    assert "no data_state record" in capfd.readouterr().err
    assert (res.start_epoch, res._resume_offset) == (2, 0)


def test_each_train_call_starts_at_the_start_epoch(tmp_path):
    """``train`` starts at ``start_epoch`` on every call, as the JAX
    trainer's does (the bench's ``--e2e`` warms up with ``train(2)`` and
    times ``train(3)``); ``data_state()`` is where a resume would start."""
    tr = _trainer(None, resident=True)
    tr.train(1)
    assert tr.data_state()["epoch"] == 1
    tr.train(2)
    assert tr.state.step == 3 * STEPS and len(tr.loss_history) == 3 * STEPS
    assert (tr.data_state()["epoch"], tr.data_state()["offset"]) == (2, 0)
