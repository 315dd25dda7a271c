"""The port's checkpoint lineage against ``ddp_tpu``'s, the serve engine's
walk of it, and the CLI's preemption exit and resume.

Tolerances: none.  A lineage written by either package is walked by the
other to the same candidate (file, epoch, step), whole or damaged: a torn
head, a missing manifest, a stale sha.  Both packages' commits of the same
files write the same manifest bytes.  The serve engine resolves a
directory and falls back past a torn head.  Through the CLI (a DeepNN
streaming run in a subprocess), ``DDP_TPU_FAULT=sigterm@step=3`` exits 75
with a mid-epoch checkpoint, and ``--resume`` completes on the
uninterrupted run's file bit for bit.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.resilience import lineage as jlineage
from ddp_tpu.train import save_checkpoint as jsave_checkpoint
from ddp_tpu.train.step import init_train_state as jinit_train_state
import ddp_tpu_torch.models.vgg as tvgg
from ddp_tpu_torch import cli
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.resilience import faults, lineage
from ddp_tpu_torch.serve import ServeEngine
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train.checkpoint import (CheckpointError,
                                            UnportedFormatError)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
NARROW = [8, "M", 16, "M", 512, "M"]
EPOCHS, KEEP = 4, 3


def _ds(epoch):
    return {"version": 1, "epoch": epoch + 1, "offset": 0, "seed": 0,
            "rng_folds": 0}


def _write(pkg, path, epoch):
    """One checkpoint of ``epoch`` at ``path`` by ``pkg``'s saver (a narrow
    VGG's state for the port, a one-leaf tree for JAX); its sha256."""
    if pkg == "port":
        model = VGG(NARROW, generator=torch.Generator().manual_seed(epoch))
        return tckpt.save_checkpoint(
            path, model, [torch.full_like(p, epoch)
                          for p in model.parameters()], step=10 * epoch,
            epoch=epoch, data_state=_ds(epoch))
    return jsave_checkpoint(
        path, {"w": np.full(4, float(epoch), np.float32)}, {},
        SGDState({"w": np.zeros(4, np.float32)}), step=10 * epoch,
        epoch=epoch, data_state=_ds(epoch))


def _build(pkg, path, epochs=EPOCHS, keep=KEEP):
    lin = (lineage if pkg == "port" else jlineage).CheckpointLineage(
        path, keep=keep)
    for e in range(epochs):
        lin.preserve_head()
        sha = _write(pkg, path, e)
        lin.commit(epoch=e, step=10 * e, sha256=sha, data_state=_ds(e))


def _walk(mod, path):
    ck, used = mod.latest_verifiable(path)
    return os.path.basename(used), int(ck.epoch), int(ck.step)


def test_lineage_rotation_manifest_and_fallback_order(tmp_path):
    """Five commits at keep 3: the head and the two newest rotated
    snapshots stay, the manifest's shas are the files', its head's
    data_state is the head file's, and tearing candidates newest first
    walks back until an error naming every candidate."""
    path = str(tmp_path / "ck.pt")
    _build("port", path, epochs=5)
    assert sorted(os.listdir(tmp_path)) == [
        "ck.pt", "ck.pt.ep00000002", "ck.pt.ep00000003",
        "ck.pt.manifest.json"]
    m = json.load(open(path + ".manifest.json"))
    assert m["format"] == lineage.MANIFEST_FORMAT == 1
    assert m["head"]["sha256"] == tckpt.sha256_of_file(path)
    assert m["head"]["data_state"] == tckpt.load_checkpoint(path).data_state
    assert [e["epoch"] for e in m["retained"]] == [3, 2]
    for e in m["retained"]:
        assert e["sha256"] == tckpt.sha256_of_file(str(tmp_path / e["file"]))
    for want in (4, 3, 2):
        name, epoch, _ = _walk(lineage, path)
        assert epoch == want
        faults.tear_file(str(tmp_path / name))
    with pytest.raises(CheckpointError) as ei:
        lineage.latest_verifiable(path)
    for name in ("ck.pt", "ep00000003", "ep00000002"):
        assert name in str(ei.value)


def test_lineage_keep1_is_head_only(tmp_path):
    path = str(tmp_path / "ck.pt")
    _build("port", path, keep=1)
    assert sorted(os.listdir(tmp_path)) == ["ck.pt", "ck.pt.manifest.json"]
    assert _walk(lineage, path)[1] == EPOCHS - 1


@pytest.mark.parametrize("damage", ["none", "torn_head", "missing_manifest",
                                    "stale_sha", "deleted_snapshot"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_walks_the_others_lineage(writer, damage, tmp_path,
                                               capfd):
    path = str(tmp_path / "ck.pt")
    _build(writer, path)
    if damage in ("torn_head", "missing_manifest"):
        faults.tear_file(path)
    if damage == "missing_manifest":
        os.unlink(path + ".manifest.json")
    if damage == "stale_sha":
        _write(writer, path, 9)  # the head rewritten, the manifest not
    if damage == "deleted_snapshot":
        faults.tear_file(path)
        os.unlink(lineage.lineage_name(path, EPOCHS - 2))
    got = _walk(lineage, path)
    err = capfd.readouterr().err
    assert got == _walk(jlineage, path)
    want = {"none": ("ck.pt", 3), "torn_head": ("ck.pt.ep00000002", 2),
            "missing_manifest": ("ck.pt.ep00000002", 2),
            "stale_sha": ("ck.pt", 9),
            "deleted_snapshot": ("ck.pt.ep00000001", 1)}[damage]
    assert got[:2] == want
    if damage == "stale_sha":
        assert "sha256 mismatch" in err
    if damage == "deleted_snapshot":
        assert "the file is gone" in err


def test_manifests_are_byte_equal(tmp_path):
    """The same checkpoint files committed by each package's lineage give
    the same manifest bytes (and the same rotated names)."""
    src = str(tmp_path / "src.pt")
    trees = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        trees[pkg] = ((lineage if pkg == "port" else jlineage)
                      .CheckpointLineage(str(d / "ck.pt"), keep=KEEP), d)
    for e in range(EPOCHS):
        sha = _write("port", src, e)
        for lin, d in trees.values():
            lin.preserve_head()
            shutil.copyfile(src, d / "ck.pt")
            lin.commit(epoch=e, step=10 * e, sha256=sha, data_state=_ds(e))
    (_, port_dir), (_, jax_dir) = trees["port"], trees["jax"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert (port_dir / "ck.pt.manifest.json").read_bytes() == \
        (jax_dir / "ck.pt.manifest.json").read_bytes()
    assert lineage.head_fingerprint(str(port_dir)) == \
        jlineage.head_fingerprint(str(jax_dir))


def test_sharded_entries_and_the_mirror_are_refused(tmp_path):
    path = str(tmp_path / "ck.pt")
    _build("port", path)
    m = json.load(open(path + ".manifest.json"))
    m["retained"][0]["shards"] = ["ck.pt.ep00000002.shard0"]
    json.dump(m, open(path + ".manifest.json", "w"))
    with pytest.raises(UnportedFormatError, match="sharded.*A7b"):
        lineage.latest_verifiable(path)
    with pytest.raises(UnportedFormatError, match="mirror.*A7b"):
        lineage.latest_verifiable(path, store=object())
    assert lineage.latest_verifiable(str(tmp_path / "none.pt")) is None


@pytest.fixture
def narrow_models(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    monkeypatch.setattr(tvgg, "ARCH", NARROW)


def test_serve_engine_walks_a_directory_and_a_torn_head(tmp_path,
                                                       narrow_models):
    """The engine on the lineage's directory serves its head; with the head
    torn, the newest retained snapshot, and names the file it used."""
    path = str(tmp_path / "ck.pt")
    _build("port", path)
    eng = ServeEngine.from_checkpoint(str(tmp_path), "vgg", device="cpu",
                                      buckets=(8,))
    assert (eng.checkpoint_file, eng.checkpoint_epoch) == (path, 3)
    faults.tear_file(path)
    eng = ServeEngine.from_checkpoint(str(tmp_path), "vgg", device="cpu",
                                      buckets=(8,))
    assert eng.checkpoint_file.endswith("ck.pt.ep00000002")
    assert (eng.checkpoint_epoch, eng.checkpoint_step) == (2, 20)
    want = VGG(NARROW, generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(a, b) for a, b in
               zip(eng.model.state_dict().values(),
                   want.state_dict().values()))
    # A JAX-written narrow file in another directory serves the same way.
    jdir = tmp_path / "jax"
    jdir.mkdir()
    state = jinit_train_state(*jvgg.init(jax.random.key(3)))
    jsave_checkpoint(str(jdir / "checkpoint.pt"), state.params,
                     state.batch_stats, state.opt_state, step=5, epoch=1)
    eng = ServeEngine.from_checkpoint(str(jdir), "vgg", device="cpu",
                                      buckets=(8,))
    assert eng.checkpoint_step == 5


def test_cli_refuses_the_storage_half(tmp_path):
    args = ["1", "1", "--synthetic", "--synthetic_size", "16", "--device",
            "cpu", "--snapshot_path", str(tmp_path / "c.pt")]
    for extra in (["--mirror", str(tmp_path / "m")],
                  ["--ckpt_format", "sharded"]):
        with pytest.raises(SystemExit, match="A7b"):
            cli.main(args + extra)
    assert not os.listdir(tmp_path)


CLI_RUN = ["3", "1", "--batch_size", "8", "--synthetic", "--synthetic_size",
           "48", "--device", "cpu", "--model", "deepnn", "--lr", "0.05",
           "--seed", "3"]


def test_cli_sigterm_exits_75_and_resume_completes(tmp_path):
    """6 steps an epoch: SIGTERM before step 3 stops before step 4 with
    data_state (0, 4) and exit 75; ``--resume`` fast-forwards, exits 0,
    and ends on the uninterrupted run's file (weights, momentum, step)."""
    full, half = str(tmp_path / "full.pt"), str(tmp_path / "half.pt")

    def run(*extra, path=half, fault=None):
        env = dict(ENV, **({faults.FAULT_ENV: fault} if fault else {}))
        return subprocess.run(
            [sys.executable, "-m", "ddp_tpu_torch.singlegpu", *CLI_RUN,
             "--snapshot_path", path, *extra], cwd=tmp_path, env=env,
            capture_output=True, text=True, timeout=240)

    assert run(path=full).returncode == 0
    r = run(fault="sigterm@step=3")
    assert r.returncode == 75, r.stderr[-3000:]
    assert "relaunch with --resume" in r.stderr
    ds = tckpt.load_checkpoint(half).data_state
    assert (ds["epoch"], ds["offset"]) == (0, 4)
    r = run("--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "fast-forwarding epoch 0 to batch offset 4" in r.stdout
    want, got = tckpt.load_checkpoint(full), tckpt.load_checkpoint(half)
    assert (got.step, got.epoch) == (want.step, want.epoch) == (18, 2)
    for section in ("params", "momentum"):
        a = jax.tree_util.tree_leaves_with_path(getattr(want, section))
        b = jax.tree_util.tree_leaves_with_path(getattr(got, section))
        assert [k for k, _ in a] == [k for k, _ in b]
        for (k, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=str(k))
