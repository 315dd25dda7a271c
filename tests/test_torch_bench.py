"""``python -m ddp_tpu_torch.bench`` on the CPU: one parseable stdout line
with ``bench.py``'s record fields plus ``device`` and ``power_limit_w``, the
secondary record on stderr, the ``--e2e`` record with its ``phase_ms``, the
refusals of ``bench.py``'s other modes by ROADMAP item, and no run without
a card unless asked for the CPU."""
import json
import math

import pytest
import torch

from ddp_tpu_torch import bench
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.obs import live

SMALL = ["--device", "cpu", "--batch_size", "4", "--steps", "2",
         "--warmup", "1", "--repeats", "2"]


def _records(capsys):
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), [json.loads(x) for x in
                                  err.strip().splitlines() if x]


def test_cpu_run_prints_one_line_with_every_field(capsys, tmp_path):
    path = tmp_path / "bench.json"
    summary = bench.main(SMALL + ["--model", "vgg", "--no_bf16",
                                  "--result_json", str(path)])
    rec, secondary = _records(capsys)
    assert tuple(rec) == bench.RECORD_FIELDS
    assert rec["metric"] == ("vgg train samples/sec/chip (batch 4/chip, "
                             "fp32, 1 chip(s), 2-step window, per-step "
                             "dispatch)")
    assert rec["unit"] == "samples/sec/chip" and rec["vs_baseline"] == 1.0
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert len(rec["window_ms_per_step"]) == 2
    assert rec["median_ms_per_step"] == rec["wall_ms_per_step"] == \
        pytest.approx(sum(rec["window_ms_per_step"]) / 2, abs=2e-3)
    assert rec["best_window_ms_per_step"] == min(rec["window_ms_per_step"])
    assert rec["device"] == {"name": "cpu", "count": 1}
    assert rec["power_limit_w"] is None
    # MFU: the counted FLOPs at the record's rate over the CPU's probe
    # (this process's, unrounded; the record rounds it to 3 decimals).  The
    # record's value is rounded to 0.01 and its mfu to 1e-4, so the mfu
    # lies within those roundings of the value's.
    peak, source = live.mfu_peak("cpu")
    assert rec["mfu_peak_source"] == source == "probed"
    assert rec["mfu_peak_tflops"] == round(peak, 3)
    per_sample = live.train_gflop_per_sample("vgg") / 1e3 / peak
    assert (rec["value"] - 0.005) * per_sample - 5e-5 <= rec["mfu"] <= \
        (rec["value"] + 0.005) * per_sample + 5e-5
    assert [tuple(r) for r in secondary] == [bench.RECORD_FIELDS]
    assert secondary[0]["metric"].endswith("(resident-epoch mode))")
    # 1 + 2 x 2 steps in each record; the CPU runs the plain version, so
    # the kernel's counter does not move.
    assert summary["steps"] == {"float32": 10, "bfloat16": 0}
    assert summary["launches"] == {"gather_batch": 0,
                                   "gather_batch_bf16": 0}
    assert json.loads(path.read_text()) == json.loads(json.dumps(summary))


def test_bf16_primary_only(capsys):
    bench.main(SMALL + ["--model", "deepnn", "--bf16", "--primary_only",
                        "--shard_update"])
    rec, secondary = _records(capsys)
    assert secondary == []
    assert "bf16, 1 chip(s), zero-sharded update, 2-step window" in \
        rec["metric"]
    assert rec["value"] > 0 and rec["mfu"] > 0


@pytest.mark.parametrize("resident", [False, True])
def test_e2e_prints_its_line_with_phase_ms(capsys, resident):
    summary = bench.main(["--device", "cpu", "--e2e", "--model", "deepnn",
                          "--batch_size", "4", "--e2e_steps", "2"]
                         + (["--resident"] if resident else []))
    rec, secondary = _records(capsys)
    assert secondary == [] and tuple(rec) == bench.E2E_FIELDS
    assert rec["value"] > 0 and rec["mfu"] > 0
    feed = "HBM-resident data" if resident else "host-fed, prefetch depth 2"
    assert rec["metric"] == (f"deepnn e2e train samples/sec/chip (batch "
                             f"4/chip, fp32, 1 chip(s), {feed}, 2-step "
                             f"epochs, incl. input pipeline)")
    phases = {"dispatch", "loss_flush"} | (
        set() if resident else {"data_wait", "h2d", "host_augment"})
    assert set(rec["phase_ms"]) == phases
    assert all(v >= 0 for v in rec["phase_ms"].values())
    assert summary["steps"]["float32"] == 5 * 2  # 2 warm-up + 3 timed


REFUSALS = [([flag] + ([] if flag in ("--serve", "--pipeline") else ["x"]),
             item.split(":")[0]) for flag, item in bench.REFUSED.items()]
REFUSALS += [(["--dispatch", "scan"], "no eager counterpart"),
             (["--num_devices", "2"], "A13b")]


@pytest.mark.parametrize("argv,item", REFUSALS,
                         ids=[a[0] for a, _ in REFUSALS])
def test_other_modes_refused_by_roadmap_item(argv, item):
    with pytest.raises(SystemExit, match=item):
        bench.main(argv + ["--device", "cpu"])


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError, match="--device cpu"):
        bench.main(["--steps", "1"])
