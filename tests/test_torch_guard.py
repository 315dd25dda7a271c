"""The port's resilience units against ``ddp_tpu``'s on the same seeded
inputs, and its world-2 drills through the CLI over gloo.

Tolerances: none.  ``_leaf_fingerprint`` equals JAX's uint32 bit for bit
(float32, int32, uint32 near 2^32 and bfloat16 arrays); the step health
guard gives JAX's decisions, restores, LR scales, raised errors (type,
message, condemned steps) and metrics events on the same loss arrays,
for every ``--on_nan`` policy and spike action; a drift event names the
leaf JAX's would.  The CLI drills at world 2 (``--spawn 2``, gloo): a
flipped bit is caught within K steps and aborts with exit 1 or restores
and completes; a stalled rank makes the watchdog exit 124.
"""
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import get_model as jget_model
from ddp_tpu.resilience import drift as jdrift
from ddp_tpu.resilience import guard as jguard
from ddp_tpu.resilience.watchdog import WATCHDOG_EXIT_STATUS as J_WD_EXIT
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.obs.registry import MetricsRegistry
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.resilience import drift, faults, guard
from ddp_tpu_torch.resilience.preemption import PreemptionGuard
from ddp_tpu_torch.resilience.watchdog import (WATCHDOG_EXIT_STATUS,
                                               Watchdog)
from ddp_tpu_torch.train.trainer import (_DROPOUT_STREAM, _seed_of,
                                         draw_seed, dropout_seed)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
# A narrow world-2 streaming DeepNN (16 images a rank, batch 4: 4 steps an
# epoch), the drills' command.
DRILL = ["3", "1", "--batch_size", "4", "--synthetic", "--synthetic_size",
         "32", "--device", "cpu", "--model", "deepnn", "--lr", "0.05",
         "--seed", "3", "--spawn", "2"]


# ----------------------------------------------------------- fingerprint


def _fingerprint_case(kind: str):
    rng = np.random.default_rng(11)
    if kind == "float32":
        a = rng.standard_normal(4099).astype(np.float32)
        a[:4] = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0x80000000, 0x7FFFFFFF],
                         np.uint32).view(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)
    if kind == "int32":
        a = rng.integers(-2**31, 2**31, 4099).astype(np.int32)
        a[:4] = [-1, -2, -2**31, 2**31 - 1]
        return jnp.asarray(a), torch.from_numpy(a)
    if kind == "uint32":
        u = (2**32 - rng.integers(1, 1 << 20, 4099)).astype(np.uint32)
        return jnp.asarray(u), torch.from_numpy(u.view(np.int32)).view(
            torch.uint32)
    a = rng.standard_normal(4099).astype(np.float32) * 1e3
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


@pytest.mark.parametrize("kind", ["float32", "int32", "uint32", "bfloat16"])
def test_leaf_fingerprint_bit_equal_to_jax(kind):
    """The same 1-D array (values near 2^32 included, 4,099 positions)
    gives JAX's uint32 fingerprint; bfloat16 goes through float32 in
    both."""
    j, t = _fingerprint_case(kind)
    want = int(np.asarray(jdrift._leaf_fingerprint(j)))
    got = drift._leaf_fingerprint(t)
    assert got.dtype == torch.int64 and int(got) == want


def test_leaf_fingerprint_sees_one_flipped_bit():
    x = torch.randn(1000)
    y = x.clone()
    y.view(torch.int32)[500] ^= 1
    assert int(drift._leaf_fingerprint(x)) != \
        int(drift._leaf_fingerprint(y))


@pytest.mark.parametrize("name", ["vgg", "deepnn", "resnet18"])
def test_leaf_paths_are_jax_flatten_order(name):
    """The audit's leaves are taken and named as JAX's ``leaf_paths``
    names its parameter tree, so an event names the same leaf."""
    params, _ = jax.eval_shape(lambda: jget_model(name).init(
        jax.random.key(0)))
    assert drift.leaf_paths(get_model(name, device="meta")) == \
        jdrift.leaf_paths(params)


# ----------------------------------------------------------------- guard


class _Events:
    def __init__(self):
        self.events = []

    def log_event(self, kind, **fields):
        self.events.append((kind, fields))


def _guard_log(mod, policy, action):
    """Feed six seeded epochs of losses (NaNs, infs and spikes placed in
    them) to ``mod``'s guard; record after each check its decisions,
    restores, LR scale, last decision and what it raised."""
    rng = np.random.default_rng(5)
    epochs = [2.0 + 0.05 * rng.standard_normal(10) for _ in range(6)]
    epochs[1][3] = np.nan
    epochs[2][5] = 50.0
    epochs[3][0], epochs[3][7] = np.inf, 40.0
    epochs[4][[2, 6]] = 60.0, 70.0
    epochs[5][9] = np.nan
    metrics = _Events()
    g = mod.StepHealthGuard(policy, max_restores=2, window=8,
                            spike_factor=2.0, spike_action=action,
                            metrics=metrics)
    scales = []
    g.on_lr_backoff = scales.append
    log = []
    for e, losses in enumerate(epochs):
        raised = None
        try:
            g.check(losses.astype(np.float32), epoch=e, start_step=10 * e)
        except (mod.NonFiniteLossError, mod.LossSpikeError,
                mod.RestoreFromLastGood) as err:
            raised = (type(err).__name__, str(err),
                      getattr(err, "skip_steps", None),
                      getattr(err, "skip_epoch", None))
        log.append((dict(g.decisions), g.restores, g.lr_scale,
                    g.last_decision, raised))
    return log, metrics.events, scales


@pytest.mark.parametrize("action", guard.SPIKE_ACTIONS)
@pytest.mark.parametrize("policy", guard.POLICIES)
def test_guard_decisions_equal_jax(policy, action, capfd):
    assert (guard.POLICIES, guard.SPIKE_ACTIONS) == \
        (jguard.POLICIES, jguard.SPIKE_ACTIONS)
    got = _guard_log(guard, policy, action)
    printed = capfd.readouterr().err
    want = _guard_log(jguard, policy, action)
    assert got == want and printed == capfd.readouterr().err
    assert got[0][-1][0]  # every case decided something


def test_guard_rejects_bad_knobs():
    with pytest.raises(ValueError, match="on_nan"):
        guard.StepHealthGuard("explode")
    with pytest.raises(ValueError, match="guard_action"):
        guard.StepHealthGuard(window=8, spike_action="explode")
    with pytest.raises(ValueError, match="guard_spike_factor"):
        guard.StepHealthGuard(window=8, spike_factor=-1.0)


def test_guard_decisions_reach_the_registry():
    reg = MetricsRegistry()
    g = guard.StepHealthGuard("skip", registry=reg)
    g.check(np.array([1.0, np.nan]), epoch=0, start_step=0)
    assert 'ddp_guard_decisions_total{decision="nonfinite_skip"} 1' in \
        reg.exposition()


# -------------------------------------------------------------- watchdog


def test_watchdog_fires_on_stall_and_is_fast(capfd):
    assert WATCHDOG_EXIT_STATUS == J_WD_EXIT == 124
    fired = []
    reg = MetricsRegistry()
    wd = Watchdog(0.3, tag="unit", registry=reg)
    wd._exit = fired.append  # not the test process
    t0 = time.monotonic()
    wd.start()
    try:
        for _ in range(200):
            if fired:
                break
            time.sleep(0.05)
    finally:
        wd.stop()
    assert fired == [WATCHDOG_EXIT_STATUS]
    assert time.monotonic() - t0 < 5.0
    assert "WATCHDOG" in capfd.readouterr().err
    text = reg.exposition()
    assert "ddp_watchdog_expirations_total 1" in text
    assert "ddp_watchdog_beats_total 1" in text  # start()'s beat


def test_watchdog_heartbeats_prevent_firing():
    fired = []
    wd = Watchdog(0.5, tag="unit")
    wd._exit = fired.append
    wd.start()
    try:
        for _ in range(15):
            time.sleep(0.1)
            wd.beat()
    finally:
        wd.stop()
    assert not fired and wd.beats == 16


def test_abort_never_blocks_and_any_rank_without_a_group():
    t0 = time.monotonic()
    dist.abort()  # no group here: nothing to give up
    dist._aborted = False
    assert time.monotonic() - t0 < 1.0
    assert dist.any_rank(True) and not dist.any_rank(False)
    assert "stop_vote" not in dist.collective_calls


# ------------------------------------------------------------ preemption


def test_preemption_guard_second_signal_restores_previous_handler():
    prev = signal.getsignal(signal.SIGUSR1)
    g = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        assert not g.should_stop_step(0) and not g.should_stop(0)
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if g.noticed():
                break
            time.sleep(0.01)
        # World 1: the decision is the flag, at either boundary.
        assert g.should_stop_step(7) and g.should_stop(0)
        assert signal.getsignal(signal.SIGUSR1) in (prev, signal.SIG_DFL)
    finally:
        g.uninstall()
    assert signal.getsignal(signal.SIGUSR1) in (prev, signal.SIG_DFL)


# ------------------------------------------------------------------ keys


@pytest.mark.parametrize("seed,epoch,step,rank,micro", [
    (0, 0, 0, 0, 0), (3, 7, 97, 0, 0), (3, 7, 97, 1, 0), (3, 7, 97, 0, 1),
    (5, 2, 40, 3, 2), (2**40, 19, 1959, 7, 3)])
def test_draw_keys_without_folds_are_unchanged(seed, epoch, step, rank,
                                               micro):
    """``folds=0`` leaves every key as it was before restores re-keyed
    them; ``folds > 0`` moves every one, a different key per count."""
    key = [seed, epoch, step] + ([rank] if rank or micro else []) + \
        ([micro] if micro else [])
    assert draw_seed(seed, epoch, step, rank, micro) == \
        draw_seed(seed, epoch, step, rank, micro, folds=0) == _seed_of(key)
    assert dropout_seed(seed, epoch, step, rank, micro, folds=0) == \
        _seed_of([seed, epoch, step, rank, micro, _DROPOUT_STREAM])
    seeds = {draw_seed(seed, epoch, step, rank, micro, folds=f)
             for f in range(4)}
    seeds |= {dropout_seed(seed, epoch, step, rank, micro, folds=f)
              for f in range(4)}
    assert len(seeds) == 8


# ----------------------------------------------------------------- faults


def test_env_fault_vocabulary(monkeypatch):
    monkeypatch.setenv(faults.FAULT_ENV, "explode@step=1")
    with pytest.raises(ValueError, match="unknown"):
        faults.install_env_faults(object())
    for spec, item in (("fail_ckpt_write@epoch=1", "A7b"),
                       ("fail_put@n=2", "A7b"), ("torn_publish@", "A9"),
                       ("crash_replica@requests=3,replica=0", "A9")):
        monkeypatch.setenv(faults.FAULT_ENV, spec)
        with pytest.raises(ValueError, match=f"not ported.*{item}"):
            faults.install_env_faults(object())


# ----------------------------------------------------- world-2 CLI drills


def _multigpu(args, tmp_path, fault, timeout=240):
    env = dict(ENV, **{faults.FAULT_ENV: fault})
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "ddp_tpu_torch.multigpu",
                        *args], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return r, time.monotonic() - t0


@pytest.mark.parametrize("action", ["abort", "restore"])
def test_drift_drill_world2(action, tmp_path):
    """``flip_param_bit@step=6,replica=1`` with ``--drift_audit_every 2``:
    the audit after step 8 names JAX's first leaf and replica 1 (the
    metrics stream's ``drift_detected`` event); ``abort`` exits 1,
    ``restore`` reloads the epoch-0 file on both ranks, re-keys, finishes
    with finite losses and ``restores`` 1 in its summary."""
    metrics, res = tmp_path / "m.jsonl", tmp_path / "r.json"
    r, _ = _multigpu(DRILL + ["--drift_audit_every", "2", "--drift_action",
                              action, "--metrics_path", str(metrics),
                              "--result_json", str(res)],
                     tmp_path, "flip_param_bit@step=6,replica=1")
    events = [json.loads(line) for line in open(metrics)]
    ev = [e for e in events if e.get("event") == "drift_detected"]
    first = drift.leaf_paths(get_model("deepnn", device="meta"))[0]
    assert len(ev) == 1 and ev[0]["step"] == 8, ev
    assert ev[0]["leaves"] == [first] and ev[0]["replicas"] == [1]
    assert "silent data corruption" in r.stderr
    if action == "abort":
        assert r.returncode == 1, r.stderr[-3000:]
        assert "DriftDetectedError" in r.stderr
        return
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(res.read_text())
    assert out["restores"] == 1 and out["data_state"]["rng_folds"] == 1
    assert len(out["loss_history"]) == 12
    assert np.isfinite(out["loss_history"]).all()
    # Audits after steps 2, 4, 6 and 8, and after the rewind to step 4
    # after 6, 8, 10 and 12: two sums each.
    assert out["collectives"]["drift_audit"] == 2 * 8


def test_watchdog_unsticks_a_stalled_world2_run(tmp_path):
    """Rank 1 sleeps 600 s after epoch 0; rank 0 waits in the epoch's stop
    vote.  Both watchdogs (5 s) exit 124 well within a minute."""
    r, secs = _multigpu(DRILL + ["--watchdog_secs", "5", "--snapshot_path",
                                 str(tmp_path / "wd.pt")],
                        tmp_path, "stall@epoch=0,rank=1,secs=600")
    assert r.returncode == WATCHDOG_EXIT_STATUS, r.stderr[-3000:]
    assert "WATCHDOG" in r.stderr and secs < 60
