"""The port's package boundary: it imports neither JAX nor ``ddp_tpu``, its
CLI runs end to end on the CPU when asked to, and refuses to run without a
card otherwise."""
import math
import os
import subprocess
import sys

import pytest
import torch

from ddp_tpu_torch import cli
from ddp_tpu_torch.device import NoCardError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ddp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ddp_tpu_torch.__path__,
                                                "ddp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ddp_tpu" or m.startswith("ddp_tpu."))
print(len(names), bad)
assert len(names) >= 20 and not bad, bad
new = {"ddp_tpu_torch.multigpu", "ddp_tpu_torch.parallel",
       "ddp_tpu_torch.parallel.dist", "ddp_tpu_torch.parallel.drill",
       "ddp_tpu_torch.repeat_check", "ddp_tpu_torch.data.native",
       "ddp_tpu_torch.data.augment", "ddp_tpu_torch.data.prefetch",
       "ddp_tpu_torch.models.deepnn", "ddp_tpu_torch.models.resnet",
       "ddp_tpu_torch.models.modules", "ddp_tpu_torch.bench",
       "ddp_tpu_torch.obs.live", "ddp_tpu_torch.obs.aggregate",
       "ddp_tpu_torch.utils", "ddp_tpu_torch.utils.metrics",
       "ddp_tpu_torch.resilience.lineage", "ddp_tpu_torch.resilience.guard",
       "ddp_tpu_torch.resilience.watchdog", "ddp_tpu_torch.resilience.drift",
       "ddp_tpu_torch.resilience.faults", "ddp_tpu_torch.obs.blackbox",
       "ddp_tpu_torch.obs.registry", "ddp_tpu_torch.train.ckpt_shard",
       "ddp_tpu_torch.resilience.store",
       "ddp_tpu_torch.resilience.supervisor", "ddp_tpu_torch.supervise",
       "ddp_tpu_torch.chaos_campaign", "ddp_tpu_torch.obs.export",
       "ddp_tpu_torch.obs.ledger", "ddp_tpu_torch.obs.inspect",
       "ddp_tpu_torch.obs.__main__", "ddp_tpu_torch.serve.router",
       "ddp_tpu_torch.serve.fleet", "ddp_tpu_torch.utils.profiling",
       "ddp_tpu_torch.fleet_load", "ddp_tpu_torch.bench_trend"}
assert new <= set(names), sorted(new - set(names))
"""


def test_port_imports_no_jax_and_no_ddp_tpu():
    """A subprocess: this test process has JAX loaded by conftest."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


_ARGS = ["2", "1", "--batch_size", "8", "--resident", "--synthetic",
         "--synthetic_size", "32"]


def test_cli_runs_on_cpu_when_asked(capsys, tmp_path):
    snapshot = str(tmp_path / "checkpoint.pt")
    out = cli.main(_ARGS + ["--device", "cpu", "--lr", "0.05",
                            "--snapshot_path", snapshot])
    printed = capsys.readouterr().out
    assert len(out["loss_history"]) == 2 * 4  # 32 / 8 steps, two epochs
    assert all(math.isfinite(x) for x in out["loss_history"])
    assert 0.0 <= out["accuracy"] <= 100.0
    assert out["step_ms"] == []  # device step times exist on a card only
    for line in ("Total training time:", "fp32 model has size=35.20 MiB",
                 f"Epoch 0 | Training checkpoint saved at {snapshot}",
                 f"Epoch 1 | Training checkpoint saved at {snapshot}",
                 "fp32 model has accuracy="):
        assert line in printed
    assert os.path.exists(snapshot)


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError, match="--device cpu"):
        cli.main(_ARGS)


def test_cli_data_path_follows_resident(tmp_path):
    """``--resident`` is what selects the resident data path; without it
    the CLI streams batches from the host instead of refusing."""
    out = cli.main(["1", "1", "--synthetic", "--synthetic_size", "16",
                    "--batch_size", "8", "--device", "cpu",
                    "--snapshot_path", str(tmp_path / "c.pt")])
    assert len(out["loss_history"]) == 2 and out["data_path"] == "streaming"
    resident = cli.main(["1", "1", "--synthetic", "--synthetic_size", "16",
                         "--batch_size", "8", "--device", "cpu",
                         "--resident", "--snapshot_path",
                         str(tmp_path / "r.pt")])
    assert len(resident["loss_history"]) == 2
    assert resident["data_path"] == "resident"


def test_singlegpu_module_entry_point(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.singlegpu", *_ARGS,
         "--device", "cpu", "--lr", "0.05",
         "--snapshot_path", str(tmp_path / "checkpoint.pt")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "fp32 model has accuracy=" in r.stdout
