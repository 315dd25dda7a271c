"""The port's mesh bench modes and its slot-wise resharding restore, against
the JAX package's.

- ``ckpt_shard.load_for_mesh`` restores a (2,4) sharded DeepNN set onto
  (4,2), (2,2), (8,1) and no plan bit for bit as the gathered file, reading
  only the overlapping slots: its ``HostBytesProbe`` ends at 0 and peaks
  below half the tree (the counterpart of ``tests/test_tp.py``'s
  portability matrix).
- ``python -m ddp_tpu_torch.bench --mesh_shape``, ``--tp_sweep``,
  ``--pp_sweep`` and ``--ckpt_bench`` as gloo ranks on the CPU at tiny
  sizes: each record's fields and its dict's keys are those of the JAX
  package's records (``BENCH_r07.json``, ``BENCH_r15.json``,
  ``BENCH_r08.json``), plus the port's ``device``, ``power_limit_w`` and
  ``backend``; the refusals use the JAX package's words.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddp_tpu_torch import bench as tbench
from ddp_tpu_torch import interop
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.parallel.tp import plan as tplan
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import ckpt_shard as tckpt_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _jax_record(name: str) -> dict:
    with open(os.path.join(REPO, name)) as f:
        return json.loads(json.load(f)["tail"])


# -- the slot-wise restore ----------------------------------------------------


@pytest.fixture(scope="module")
def deepnn_sets(tmp_path_factory):
    """One DeepNN state (random weights, a momentum from them) written as a
    gathered v1 file and as a (2,4) sharded v2 set of four slots, each
    slot written from its own slices as a model-sharded run writes it."""
    d = tmp_path_factory.mktemp("sets")
    model = get_model("deepnn", generator=torch.Generator().manual_seed(3))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mom = {n: p.detach() * 0.5 + 1.0 for n, p in model.named_parameters()}
    g_path, s_path = str(d / "gathered.pt"), str(d / "sharded.pt")
    tckpt.write_gathered(g_path, tckpt.state_arrays("deepnn", sd, mom), 7, 2)
    plan = tplan.plan_for_model("deepnn", model, model_size=4)
    for k in (3, 2, 1, 0):  # rank 0 writes last: it awaits the sidecars
        arrays = tckpt.state_arrays("deepnn", interop.shard_state(plan, sd, k),
                                    interop.shard_state(plan, mom, k))
        if k:
            tckpt_shard.write_slot(s_path, arrays, 7, 2, slot=k, n_slots=4,
                                   tree_specs=plan.tree_specs)
        else:
            tckpt_shard.save_checkpoint_sharded(
                s_path, arrays, 7, 2, n_slots=4, tree_specs=plan.tree_specs,
                mesh_shape=(2, 4))
    return g_path, s_path


def test_sharded_restore_portability_matrix(deepnn_sets):
    """A (2,4) set onto (4,2), (2,2), (8,1) and no plan: every model index's
    slices bit for bit the gathered file's cut, the probe back at 0 and its
    peak below half of the tree (params plus momentum): no rank stages the
    whole tree."""
    g_path, s_path = deepnn_sets
    whole = tckpt.load_checkpoint(g_path)
    full_bytes = sum(a.nbytes for a in _flat(whole.params).values()) * 2
    meta = get_model("deepnn", device="meta")
    for shape in [(4, 2), (2, 2), (8, 1), None]:
        m = 1 if shape is None else shape[1]
        plan = (None if shape is None
                else tplan.plan_for_model("deepnn", meta, model_size=m))
        for k in range(m):
            probe = tckpt_shard.HostBytesProbe()
            ck = tckpt_shard.load_for_mesh(s_path, plan, k, probe=probe)
            want = tckpt_shard.shard_checkpoint(whole, plan, k)
            assert (ck.step, ck.epoch) == (7, 2)
            for section in ("params", "momentum", "batch_stats"):
                got, exp = (_flat(getattr(ck, section)),
                            _flat(getattr(want, section)))
                assert got.keys() == exp.keys()
                for key in exp:
                    assert got[key].dtype == exp[key].dtype
                    np.testing.assert_array_equal(got[key], exp[key])
            assert probe.current == 0, (shape, k)
            assert 0 < probe.peak < full_bytes / 2, \
                (f"restore onto {shape} staged {probe.peak} host bytes, "
                 f"more than half the {full_bytes}-byte tree")
        # The v1 file is read whole, and stages the whole tree.
        probe = tckpt_shard.HostBytesProbe()
        ck = tckpt_shard.load_for_mesh(g_path, plan, 0, probe=probe)
        assert probe.current == 0 and probe.peak >= full_bytes


def test_sharded_restore_reads_only_overlapping_slots(deepnn_sets,
                                                      monkeypatch):
    """Model index k of 2 reads saved slots 2k and 2k+1 of each sharded
    leaf (and slot 0 for a replicated one), never the other two."""
    _, s_path = deepnn_sets
    plan = tplan.plan_for_model("deepnn", get_model("deepnn", device="meta"),
                                model_size=2)
    read = []
    real = tckpt_shard._member

    def spy(zs, key, slot, path):
        read.append((key, slot))
        return real(zs, key, slot, path)

    monkeypatch.setattr(tckpt_shard, "_member", spy)
    index = tckpt_shard.read_shard_index(s_path)
    for k in range(2):
        read.clear()
        tckpt_shard.load_for_mesh(s_path, plan, k)
        for key, entry in index["leaves"].items():
            slots = sorted(s for kk, s in read if kk == key)
            if entry["shard_dim"] is None:
                assert slots == [0], key
            else:
                assert slots == [2 * k, 2 * k + 1], key


# -- the mesh bench modes -----------------------------------------------------

# Tiny CPU runs: gloo ranks, DeepNN at batch 8, two steps.
TINY = ["--device", "cpu", "--model", "deepnn", "--batch_size", "8",
        "--steps", "2", "--warmup", "1", "--repeats", "2"]
PORT_FIELDS = {"device", "power_limit_w", "backend"}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``--tp_sweep 1,2``, ``--pp_sweep 1,2 --pp_micro 2`` (both over 2
    gloo ranks) and ``--ckpt_bench --ckpt_sizes 16`` (8 then 4 ranks), run
    at once: each mode's record line and its ``--result_json`` summary."""
    d = tmp_path_factory.mktemp("mesh")
    modes = {
        "tp": TINY + ["--tp_sweep", "1,2", "--num_devices", "2"],
        "pp": TINY + ["--pp_sweep", "1,2", "--num_devices", "2",
                      "--pp_micro", "2"],
        "ckpt": ["--device", "cpu", "--ckpt_bench", "--ckpt_sizes", "16"],
    }
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.bench", *argv,
         "--result_json", str(d / f"{name}.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in modes.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        with open(d / f"{name}.json") as f:
            out[name] = (json.loads(stdout.strip().splitlines()[0]),
                         json.load(f))
    return out


def test_tp_sweep_record_matches_bench_py(mesh_runs):
    rec, summary = mesh_runs["tp"]
    jax = _jax_record("BENCH_r07.json")
    assert set(rec) == set(jax) | PORT_FIELDS
    assert list(rec["tp_sweep"]) == ["2x1", "1x2"]
    want = set(next(iter(jax["tp_sweep"].values())))
    for cell in rec["tp_sweep"].values():
        assert set(cell) == want and cell["ms_per_step"] > 0
    assert rec["metric"].startswith(
        "deepnn tensor-parallel mesh sweep (cpu mesh, global batch 8, 2 "
        "devices, fp32, shapes ['2x1', '1x2'])")
    assert rec["unit"] == "ms/step ratio, 2x1 vs 1x2 (data x model)"
    assert rec["value"] == round(rec["tp_sweep"]["2x1"]["ms_per_step"]
                                 / rec["tp_sweep"]["1x2"]["ms_per_step"], 4)
    assert rec["backend"] == "gloo" and rec["device"]["count"] == 2
    # Each child ran its shape's ranks, every rank its steps (a warm-up
    # step, then two windows of two).
    assert [len(c["ranks"]) for c in summary["children"]] == [2, 2]
    for child in summary["children"]:
        assert all(r["steps"] == 1 + 2 * 2 for r in child["ranks"])


def test_pp_sweep_record_matches_bench_py(mesh_runs):
    rec, summary = mesh_runs["pp"]
    jax = _jax_record("BENCH_r15.json")
    assert set(rec) == set(jax) | PORT_FIELDS
    assert list(rec["pp_sweep"]) == ["2x1x1", "1x1x2"]
    want = set(next(iter(jax["pp_sweep"].values())))
    for cell in rec["pp_sweep"].values():
        assert set(cell) == want
    assert rec["pp_sweep"]["2x1x1"]["pp"] is None
    pp = rec["pp_sweep"]["1x1x2"]["pp"]
    assert set(pp) == set(jax["pp_sweep"]["1x1x4"]["pp"])
    assert (pp["schedule"], pp["num_stages"], pp["num_micro"]) == \
        ("1f1b", 2, 2)
    assert pp["bubble_predicted"] == pytest.approx(1 / 3)
    assert 0.0 <= pp["bubble_measured"] < 1.0
    assert rec["value"] == round(pp["bubble_measured"], 4)
    assert rec["unit"] == ("measured bubble fraction at 1x1x2 (static "
                           "prediction 0.3333)")
    # The staged child warms up with two steps: the second is PPStep's
    # timed one, which measures the bubble.
    staged = summary["children"][1]["ranks"]
    assert [(r["stage"], r["steps"]) for r in staged] == [(0, 6), (1, 6)]


def test_ckpt_bench_record_matches_bench_py(mesh_runs):
    rec, summary = mesh_runs["ckpt"]
    jax = _jax_record("BENCH_r08.json")
    assert set(rec) == set(jax) | PORT_FIELDS
    assert list(rec["ckpt_bench"]) == ["16MB"]
    jcell = next(iter(jax["ckpt_bench"].values()))
    assert set(rec["ckpt_bench"]["16MB"]) == set(jcell) == \
        {"gathered", "sharded"}
    for fmt in ("gathered", "sharded"):
        assert set(rec["ckpt_bench"]["16MB"][fmt]) == set(jcell[fmt])
    # 8 ranks save on (2,4), 4 restore onto (2,2), every restore bit exact;
    # the sharded set's restore stages half a leaf of each of params and
    # momentum at most (two of its four 2 MiB slots), the v1 file the
    # whole tree (16 MiB).
    children = summary["children"]
    assert [(c["phase"], c["format"], c["mesh"], c["ranks"])
            for c in children] == [
        ("save", "gathered", "2x4", 8), ("restore", "gathered", "2x2", 4),
        ("save", "sharded", "2x4", 8), ("restore", "sharded", "2x2", 4)]
    assert all(c["exact"] for c in children if c["phase"] == "restore")
    cells = rec["ckpt_bench"]["16MB"]
    assert cells["sharded"]["restore_engine_peak_staging_mb"] <= 4.1
    assert cells["gathered"]["restore_engine_peak_staging_mb"] >= 16.0


def _jax_bench():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--mesh_shape", "2"],
    ["--mesh_shape", "2,x"],
    ["--mesh_shape", "1,1,2", "--shard_update"],
    ["--mesh_shape", "1,1,2", "--dispatch", "scan"],
    ["--mesh_shape", "1,1,2", "--dump_hlo", "h.txt"],
])
def test_mesh_refusals_use_bench_py_words(argv, monkeypatch):
    jbench = _jax_bench()
    monkeypatch.setattr(sys, "argv", ["bench.py", "--model", "deepnn",
                                      *argv])
    with pytest.raises(SystemExit) as jax_exit:
        jbench._bench_step(jbench._parse_args(), bf16=False)
    with pytest.raises(SystemExit) as port_exit:
        tbench.check_args(tbench.build_parser().parse_args(
            ["--model", "deepnn", *argv]))
    assert str(port_exit.value) == str(jax_exit.value)


@pytest.mark.parametrize("argv", [
    ["--tp_sweep", "3", "--num_devices", "2"],
    ["--tp_sweep", "1,2", "--num_devices", "4", "--batch_size", "6"],
    ["--pp_sweep", "3", "--num_devices", "2"],
    ["--pp_sweep", "1,2", "--num_devices", "4", "--batch_size", "6"],
])
def test_sweep_refusals_use_bench_py_words(argv, monkeypatch):
    jbench = _jax_bench()
    monkeypatch.setattr(sys, "argv", ["bench.py", "--model", "deepnn",
                                      "--sweep_platform", "cpu", *argv])
    jargs = jbench._parse_args()
    with pytest.raises(SystemExit) as jax_exit:
        (jbench._bench_tp_sweep if jargs.tp_sweep
         else jbench._bench_pp_sweep)(jargs)
    args = tbench.build_parser().parse_args(["--device", "cpu", *argv])
    tbench.check_args(args)
    bench = tbench._Bench(args, torch.device("cpu"))
    with pytest.raises(SystemExit) as port_exit:
        (tbench.tp_sweep_record if args.tp_sweep
         else tbench.pp_sweep_record)(bench)
    assert str(port_exit.value) == str(jax_exit.value)


def test_mesh_shape_refuses_other_modes():
    with pytest.raises(SystemExit, match="does not compose with --e2e"):
        tbench.check_args(tbench.build_parser().parse_args(
            ["--mesh_shape", "1,2", "--e2e"]))
    with pytest.raises(SystemExit, match="contradicts --mesh_shape 1,2"):
        tbench.check_args(tbench.build_parser().parse_args(
            ["--mesh_shape", "1,2", "--num_devices", "4"]))
    with pytest.raises(SystemExit, match="no TP_RECIPE"):
        tbench.main(["--device", "cpu", "--model", "vgg", "--mesh_shape",
                     "1,1", "--steps", "1", "--repeats", "1"])
