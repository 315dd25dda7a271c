"""The run-shape flags of the port's CLI against ``ddp_tpu/cli.py``'s:
``--schedule_epochs``/``--schedule_steps_per_epoch`` give JAX's schedule,
a split run resumed at epoch 1 takes the uninterrupted run's steps bit for
bit, ``--eval_every`` evaluates at JAX's epochs and the final accuracy
reuses the last such eval, and ``--num_devices`` is the world size."""
import json

import numpy as np
import pytest
import torch

from ddp_tpu import cli as jcli
from ddp_tpu_torch import cli
from ddp_tpu_torch.data import TrainLoader, synthetic


@pytest.mark.parametrize("flags", [
    [], ["--schedule_epochs", "20"], ["--schedule_steps_per_epoch", "98"],
    ["--schedule_epochs", "7", "--schedule_steps_per_epoch", "3"],
    ["--grad_accum", "3", "--schedule_epochs", "4"]])
def test_schedule_equals_jax(flags):
    argv = ["5", "1", "--lr", "0.3", "--batch_size", "8"] + flags
    args, jargs = (cli.build_parser("x").parse_args(argv),
                   jcli.build_parser("x").parse_args(argv))
    ds, _ = synthetic(n_train=100, n_test=1)
    loader = TrainLoader(ds, 8, 1)
    port = cli.build_schedule(args, loader)
    ref = jcli.build_schedule(
        jargs, loader.optimizer_steps_per_epoch(jargs.grad_accum))
    steps = range(0, 5 * 13 + 3)
    # JAX computes the clip and product in float32, the port in float64:
    # two roundings of float32 apart at most.
    np.testing.assert_allclose([port(s) for s in steps],
                               [float(ref(s)) for s in steps],
                               rtol=3e-7, atol=0)


_ARGS = ["--batch_size", "8", "--synthetic", "--synthetic_size", "32",
         "--device", "cpu", "--model", "deepnn", "--lr", "0.05"]


def test_split_run_equals_uninterrupted(tmp_path):
    """``1 1 --schedule_epochs 2`` then ``2 1 --resume --schedule_epochs
    2`` (streaming, host crop and flip, DeepNN's dropout) against ``2 1``:
    the same losses and weights, bit for bit."""
    split = str(tmp_path / "split.pt")
    first = cli.main(["1", "1", *_ARGS, "--schedule_epochs", "2",
                      "--snapshot_path", split])
    second = cli.main(["2", "1", *_ARGS, "--schedule_epochs", "2",
                       "--resume", "--snapshot_path", split])
    whole = cli.main(["2", "1", *_ARGS,
                      "--snapshot_path", str(tmp_path / "whole.pt")])
    assert len(first["loss_history"]) == len(second["loss_history"]) == 4
    assert first["loss_history"] + second["loss_history"] == \
        whole["loss_history"]
    got, want = second["state"], whole["state"]
    assert got.step == want.step == 8
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(torch.equal(a, b) for a, b in zip(got.momentum,
                                                 want.momentum))
    assert second["accuracy"] == whole["accuracy"]


def _jax_eval_epochs(total: int, every: int):
    """``ddp_tpu/cli.py:1169``'s rule."""
    return [e for e in range(total) if every and (e + 1) % every == 0]


@pytest.mark.parametrize("every", [1, 2])
def test_eval_every_prints_logs_and_reuses_the_final_eval(
        tmp_path, capsys, monkeypatch, every):
    calls = []
    evaluate = cli.evaluate
    monkeypatch.setattr(cli, "evaluate",
                        lambda *a, **k: calls.append(1) or evaluate(*a, **k))
    metrics = tmp_path / "m.jsonl"
    out = cli.main(["3", "1", *_ARGS, "--eval_every", str(every),
                    "--metrics_path", str(metrics), "--log_every", "0",
                    "--snapshot_path", str(tmp_path / "c.pt")])
    printed = capsys.readouterr().out
    epochs = _jax_eval_epochs(3, every)
    assert [e for e, _ in out["eval_history"]] == epochs
    for e, acc in out["eval_history"]:
        assert f"Epoch {e} | eval accuracy={acc:.2f}%" in printed
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    evals = [r for r in recs if "eval_accuracy" in r]
    assert [(r["epoch"], r.get("final", False)) for r in evals] == \
        [(e, False) for e in epochs] + [(2, True)]
    assert evals[-1]["eval_accuracy"] == round(out["accuracy"], 4)
    # After the last epoch the periodic eval's accuracy is the final one.
    reused = epochs[-1] == 2
    assert len(calls) == len(epochs) + (0 if reused else 1)
    if reused:
        assert out["accuracy"] == out["eval_history"][-1][1]
    steps = [r for r in recs if "loss" in r]
    assert [r["step"] for r in steps] == list(range(12))
    assert recs[-1] == evals[-1]


def test_metrics_stream_live_records_and_lrs(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    argv = ["2", "1", *_ARGS, "--metrics_path", str(metrics),
            "--log_every", "3", "--schedule_epochs", "5",
            "--snapshot_path", str(tmp_path / "c.pt")]
    out = cli.main(argv)
    recs = [json.loads(x) for x in metrics.read_text().splitlines()]
    steps = [r for r in recs if "loss" in r]
    schedule = cli.build_schedule(cli.build_parser("x").parse_args(argv),
                                  TrainLoader(synthetic(32, 8)[0], 8, 1))
    assert [r["lr"] for r in steps] == [round(schedule(s), 8)
                                        for s in range(8)]
    assert [r["loss"] for r in steps] == [round(x, 6)
                                          for x in out["loss_history"]]
    lives = [r for r in recs if r.get("event") == "live"]
    assert [r["step"] for r in lives] == [2, 5]
    for r in lives:
        assert r["compute_dtype"] == "float32" and r["mfu"] > 0
        assert 0.0 <= r["prefetch_occupancy"] <= 1.0
    # Resident: no consumer loop to time, so a note instead of records.
    cli.main(["1", "1", *_ARGS, "--resident", "--metrics_path",
              str(tmp_path / "r.jsonl"), "--log_every", "1",
              "--snapshot_path", str(tmp_path / "r.pt")])
    assert "live telemetry (--log_every) covers the streaming path only" \
        in capsys.readouterr().err
    assert not [r for r in (tmp_path / "r.jsonl").read_text().splitlines()
                if '"live"' in r]


def test_num_devices(monkeypatch):
    with pytest.raises(SystemExit, match="--num_devices 2 belongs to "
                                         "multigpu"):
        cli.main(["1", "1", *_ARGS, "--num_devices", "2"])
    with pytest.raises(SystemExit, match="contradicts --spawn 3"):
        cli.main_multi(["1", "1", *_ARGS, "--num_devices", "2",
                        "--spawn", "3"])
    with pytest.raises(SystemExit, match="at least 1"):
        cli.main_multi(["1", "1", *_ARGS, "--num_devices", "0"])
    spawned = []
    monkeypatch.setattr(cli.dist, "spawn_local",
                        lambda n, module, argv: spawned.append(n) or 0)
    with pytest.raises(SystemExit) as e:
        cli.main_multi(["1", "1", *_ARGS, "--num_devices", "2"])
    assert e.value.code == 0 and spawned == [2]
    # A rank whose world differs from --num_devices refuses to train.
    monkeypatch.setattr(cli.dist, "in_rendezvous", lambda: True)
    monkeypatch.setattr(cli.dist, "initialize",
                        lambda device, backend=None: device)
    with pytest.raises(SystemExit, match="contradicts this run's world "
                                         "of 1"):
        cli.main_multi(["1", "1", *_ARGS, "--num_devices", "2"])
