"""The port's run supervisor against ``ddp_tpu``'s, and one supervised run.

Tolerances: none.  ``classify_exit``, ``backoff_delay`` (seeded) and
``_failure_signature`` give JAX's answers on the same inputs.  Both
supervisors, driven by the same scripted launcher (no subprocess; the
child's deaths, metrics events and postmortem bundles are written by the
script) and the same clock, sleep alike, relaunch with the same argv and
environment, keep the same failure-ledger entries, write the same
``.supervisor.prom`` bytes and exit alike: 0, 86 (budget) or 87
(deterministic, with ``diagnosis.json``).  The port manages
``--num_devices`` and ``--mesh_shape`` (``shrink_mesh``, stage axis first;
``tests/test_torch_pp.py`` holds it and the relaunches against JAX's over a
grid); its probe counts cards with torch in a throwaway interpreter.  End to end, a
DeepNN run on the CPU under ``python -m ddp_tpu_torch.supervise`` with
``sigterm@step=2`` exits 0 on the uninterrupted run's bytes, through the
chaos campaign's ``sigterm_step`` drill.
"""
import json
import os
import random
import subprocess
import sys

import pytest

from ddp_tpu.resilience import supervisor as jsup
from ddp_tpu_torch import chaos_campaign
from ddp_tpu_torch.obs.blackbox import FlightRecorder
from ddp_tpu_torch.resilience import supervisor as tsup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pure_helpers_equal_jax():
    for rc in (0, 1, 2, 75, 124, 137, -9, -15, 86, 87):
        assert tsup.classify_exit(rc) == jsup.classify_exit(rc)
    for seed in range(4):
        a, b = random.Random(seed), random.Random(seed)
        for k in range(8):
            kw = dict(base=0.3, cap=5.0, jitter=0.25)
            assert tsup.backoff_delay(k, rng=a, **kw) == \
                jsup.backoff_delay(k, rng=b, **kw)
    cases = [[], [{"event": "drift_detected", "step": 7}],
             [{"event": "guard_decision", "decision": "spike_abort",
               "step": 12}, {"event": "batch_skipped", "step": 13}],
             [{"event": "guard_decision", "decision": "nonfinite_restore",
               "step": 3}, {"event": "guard_decision", "decision": "ok",
                            "step": 4}],
             [{"event": "drift_detected"}, {"event": "live", "step": 1}]]
    for events in cases:
        assert tsup._failure_signature(events) == \
            jsup._failure_signature(events)
    argv = ["x", "--num_devices", "4", "--lr=0.05"]
    assert tsup._set_flag(argv, "--num_devices", "2") == \
        jsup._set_flag(argv, "--num_devices", "2")
    assert tsup._ensure_resume(argv) == jsup._ensure_resume(argv)


class _Script:
    """A scripted child: each launch appends its metrics events, writes
    its postmortem bundle (through the port's flight recorder) and returns
    its exit code."""

    def __init__(self, workdir, deaths):
        self.workdir, self.deaths, self.launches = workdir, deaths, []

    def __call__(self, argv, env):
        self.launches.append((list(argv), {k: env.get(k) for k in (
            tsup.SUPERVISED_ENV, "DDP_TPU_FAULT")}))
        code, events, reason = self.deaths[len(self.launches) - 1]
        with open(os.path.join(self.workdir, "m.jsonl"), "a") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        if reason:
            FlightRecorder(os.path.join(self.workdir, "postmortem.json"),
                           config={"model": "deepnn"}).dump(
                reason, exit_status=code, error="scripted")
        return code


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _run_both(tmp_path, deaths, child_extra=(), probe=8, **kw):
    out = {}
    for name, mod in (("port", tsup), ("jax", jsup)):
        d = tmp_path / name
        d.mkdir()
        script = _Script(str(d), deaths)
        sleeps = []
        child = ["train.py", "--metrics_path", str(d / "m.jsonl"),
                 *child_extra]
        sup = mod.Supervisor(child, launcher=script, sleep=sleeps.append,
                             clock=_Clock(), device_probe=lambda e: probe,
                             seed=0, backoff_base=0.5,
                             env={"DDP_TPU_FAULT": "sigterm@step=2",
                                  "PATH": "x"}, **kw)
        rc = sup.run()
        ledger = [dict(e, postmortem=e["postmortem"] and {
            k: v for k, v in e["postmortem"].items() if k != "path"})
            for e in sup.ledger.deaths]
        launches = [([a.replace(str(d), "D") for a in argv], env)
                    for argv, env in script.launches]
        diag = d / "diagnosis.json"
        doc = None
        if diag.exists():
            doc = json.loads(diag.read_text().replace(str(d), "D"))
            doc["postmortem"].pop("path")
            for death in doc["deaths"]:
                death["postmortem"].pop("path")
        out[name] = dict(rc=rc, sleeps=sleeps, ledger=ledger,
                         launches=launches, diagnosis=doc,
                         prom=(d / "m.jsonl.supervisor.prom").read_bytes())
    assert out["port"] == out["jax"]
    return out["port"]


SPIKE = [{"event": "guard_decision", "decision": "spike_abort", "step": 12}]


@pytest.mark.parametrize("scenario", ["clean", "preempted", "backoff",
                                      "budget", "deterministic"])
def test_supervisor_loop_equals_jax(scenario, tmp_path):
    deaths, kw, want = {
        "clean": ([(0, [], None)], {}, 0),
        "preempted": ([(75, [], "preemption"), (0, [], None)], {}, 0),
        "backoff": ([(124, [], "watchdog_stall"),
                     (1, [{"event": "drift_detected", "step": 3}],
                      "drift_abort"), (1, SPIKE, "guard_abort"),
                     (0, [], None)], {}, 0),
        "budget": ([(1, [], "crash")] * 3, {"max_restarts": 2},
                   tsup.SUPERVISOR_BUDGET_EXIT_STATUS),
        "deterministic": ([(1, SPIKE, "guard_abort")] * 3,
                          {"keep_fault_env": True},
                          tsup.SUPERVISOR_DETERMINISTIC_EXIT_STATUS),
    }[scenario]
    got = _run_both(tmp_path, deaths, **kw)
    assert got["rc"] == want
    assert got["launches"][0][1] == {tsup.SUPERVISED_ENV: "1",
                                     "DDP_TPU_FAULT": "sigterm@step=2"}
    for argv, env in got["launches"][1:]:
        assert argv[-1] == "--resume"
        assert env["DDP_TPU_FAULT"] == (
            "sigterm@step=2" if kw.get("keep_fault_env") else None)
    for entry, (code, _, reason) in zip(got["ledger"], deaths):
        assert entry["exit_code"] == code
        assert entry["postmortem"] == (
            {"valid": True, "reason": reason, "exit_status": code}
            if reason else None)
    if scenario == "deterministic":
        assert len(got["launches"]) == 2
        assert got["diagnosis"]["signature"] == {
            "what": "spike_abort", "step": 12, "occurrences": 2}
        assert got["diagnosis"]["postmortem"]["reason"] == "guard_abort"
    if scenario == "backoff":
        assert len(got["sleeps"]) == 3


def test_num_devices_follows_the_probe_and_mesh_shape_is_refused(
        tmp_path, monkeypatch, capsys):
    """The probe sets a ``--num_devices`` child's world; a ``--mesh_shape``
    child, refused before pipeline parallelism came, is now managed as the
    JAX supervisor manages it: relaunched on ``shrink_mesh`` of the full
    mesh (parsed from the original command in either spelling) and the
    probe, the ledger naming each death's mesh."""
    (tmp_path / "n").mkdir()
    got = _run_both(tmp_path / "n", [(75, [], None), (0, [], None)],
                    child_extra=("--num_devices", "4"), probe=2)
    assert tsup._get_flag(got["launches"][1][0], "--num_devices") == "2"
    (tmp_path / "m").mkdir()
    got = _run_both(tmp_path / "m", [(75, [], None), (0, [], None)],
                    child_extra=("--mesh_shape", "2,1,2"), probe=2)
    assert tsup._get_flag(got["launches"][1][0], "--mesh_shape") == "2,1,1"
    assert [d["mesh"] for d in got["ledger"]] == ["2,1,2"]
    assert "shrinking mesh 2,1,2 -> 2,1,1" in capsys.readouterr().err
    for argv in (["x", "--mesh_shape", "2,4"], ["x", "--mesh_shape=8,1"]):
        assert tsup.Supervisor(argv)._full_mesh == \
            jsup.Supervisor(argv)._full_mesh
    assert tsup.probe_device_count({tsup.PROBE_ENV: "3"}) == 3
    seen = []
    monkeypatch.setattr(subprocess, "run", lambda argv, **kw: seen.append(
        argv) or subprocess.CompletedProcess(argv, 0, "1\n", ""))
    assert tsup.probe_device_count({}) == 1
    assert seen == [[sys.executable, "-c",
                     "import torch; print(torch.cuda.device_count())"]]


def test_supervised_cpu_run_resumes_bit_equal(tmp_path):
    """``sigterm@step=2``: exit 75, one immediate relaunch with
    ``--resume``, exit 0, and the final checkpoint bit for bit the
    uninterrupted control's, with a valid preemption postmortem and the
    restart on the supervisor's scrape file."""
    out = tmp_path / "card.json"
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.chaos_campaign", "--device",
         "cpu", "--drills", "sigterm_step", "--out", str(out),
         "--workdir", str(tmp_path / "w")], cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    card = json.loads(out.read_text())
    drill = card["drills"]["sigterm_step"]
    assert card["verdict"] == "PASS" and card["schema"] == \
        chaos_campaign.SCHEMA
    assert drill["supervisor_exit"] == 0 and drill["bit_identical"]
    assert drill["restart_reasons"] == {"preempted": 1}
    assert drill["postmortem"] == {"present": True, "valid": True,
                                   "reason": "preemption",
                                   "exit_status": 75}
    assert "the supervisor relaunches with --resume automatically" in \
        r.stderr


def test_campaign_refuses_kill_stage_by_name(monkeypatch, capsys,
                                            tmp_path):
    """``kill_stage``, refused by name before pipeline parallelism came, is
    in the matrix now: its config P is the pipelined one on each device
    (``--gloo_mesh`` on a card, which starts the mesh's ranks), and the
    campaign runs it; an unknown drill is still refused by name."""
    seen = []
    monkeypatch.setattr(chaos_campaign, "run_campaign",
                        lambda drills, *a: seen.append(drills) or {
                            "verdict": "PASS"})
    out = tmp_path / "c.json"
    assert chaos_campaign.main(["--device", "cpu", "--drills",
                                "kill_stage", "--out", str(out)]) == 0
    assert seen == [["kill_stage"]]
    assert chaos_campaign._DRILLS["kill_stage"] == ("P", "sigterm@step=2",
                                                    [])
    cpu = chaos_campaign._child_argv("P", [], "w", "cpu")
    card = chaos_campaign._child_argv("P", [], "w", "cuda")
    assert tsup._get_flag(cpu, "--mesh_shape") == "2,1,2"
    assert tsup._get_flag(card, "--mesh_shape") == "1,1,2"
    assert card[:3] == ["-m", "ddp_tpu_torch.chaos_campaign", "--gloo_mesh"]
    with pytest.raises(SystemExit):
        chaos_campaign.main(["--device", "cpu", "--drills", "kill_stages"])
    assert "unknown drill(s) ['kill_stages']" in capsys.readouterr().err
