"""The port's object store and checkpoint mirror against ``ddp_tpu``'s.

Tolerances: none.  ``DirStore`` objects and their integrity sidecars put
by either package are read by the other, and a torn object fails both
packages' verified ``get``.  The two packages' uploaders, fed the same
commits, publish the same mirror manifest bytes.  ``MirrorUploader``
retries failed puts (counted on the registry), times out stalled ones and
reports its lag on the ``ddp_mirror_lag_epochs`` gauge until it drains.
A wiped local directory restores from the mirror in either package's
walk, past a torn newest object.
"""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from ddp_tpu.obs import registry as jregistry
from ddp_tpu.resilience import lineage as jlineage, store as jstore
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.obs.registry import MetricsRegistry, parse_exposition
from ddp_tpu_torch.resilience import lineage, store
from ddp_tpu_torch.train import checkpoint as tckpt

NARROW = [8, "M", 16, "M", 512, "M"]
KEEP = 2


def _head(path, epoch):
    """A narrow VGG's v1 checkpoint of ``epoch`` at ``path``; its sha."""
    model = VGG(NARROW, generator=torch.Generator().manual_seed(epoch))
    return tckpt.save_checkpoint(
        path, model, [torch.full_like(p, epoch) for p in model.parameters()],
        step=10 * epoch, epoch=epoch,
        data_state={"version": 1, "epoch": epoch + 1, "offset": 0,
                    "seed": 0, "rng_folds": 0})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dirstore_objects_cross_read(writer, tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(os.urandom(3000))
    root = str(tmp_path / "remote")
    put, get = ((store.DirStore(root), jstore.DirStore(root))
                if writer == "port" else
                (jstore.DirStore(root), store.DirStore(root)))
    sha = put.put(str(src), "obj")
    assert put.put_bytes("blob", b"manifest") == \
        jstore.hashlib.sha256(b"manifest").hexdigest()
    assert get.stat("obj") == {"size": 3000, "sha256": sha}
    assert get.get("obj", str(tmp_path / "back.bin")) == sha
    assert (tmp_path / "back.bin").read_bytes() == src.read_bytes()
    assert get.get_bytes("blob") == b"manifest"
    assert get.list() == ["blob", "obj"]
    # A torn upload (half the bytes under the full sha) fails both gets.
    put.inject_torn_next_put()
    put.put(str(src), "torn")
    for s in (get, put):
        with pytest.raises(Exception, match="sha-256 verification"):
            s.get("torn", str(tmp_path / "torn.bin"))
    assert not (tmp_path / "torn.bin").exists()
    get.delete("obj")
    assert put.stat("obj") is None


def _mirror(mod, snapshot, remote, registry=None, **kw):
    return mod.MirrorUploader(mod.DirStore(remote), snapshot, keep=KEEP,
                              registry=registry, **kw)


def _commit_and_mirror(lin_mod, up, path, epochs):
    lin = lin_mod.CheckpointLineage(path, keep=KEEP)
    lin.mirror_state = up.state_of_epoch
    for e in epochs:
        lin.preserve_head()
        sha = _head(path, e)
        ds = {"version": 1, "epoch": e + 1, "offset": 0, "seed": 0,
              "rng_folds": 0}
        lin.commit(epoch=e, step=10 * e, sha256=sha, data_state=ds)
        up.enqueue(epoch=e, step=10 * e, sha256=sha, data_state=ds)
        assert up.drain(30.0)


def test_mirror_manifests_are_byte_equal(tmp_path):
    """The same commits through each package's lineage and uploader give
    the same remote objects and manifest bytes, and the same local
    manifest (its mirror stamps included)."""
    dirs = {}
    for pkg, (lin_mod, st_mod) in (("port", (lineage, store)),
                                   ("jax", (jlineage, jstore))):
        d = tmp_path / pkg
        (d / "ck").mkdir(parents=True)
        path = str(d / "ck" / "ck.pt")
        up = _mirror(st_mod, path, str(d / "remote"))
        # The same bytes in both runs: each head is copied from one source.
        lin = lin_mod.CheckpointLineage(path, keep=KEEP)
        lin.mirror_state = up.state_of_epoch
        for e in range(3):
            src = tmp_path / f"src{e}.pt"
            if not src.exists():
                _head(str(src), e)
            lin.preserve_head()
            shutil.copyfile(src, path)
            sha = tckpt.sha256_of_file(path)
            lin.commit(epoch=e, step=10 * e, sha256=sha)
            up.enqueue(epoch=e, step=10 * e, sha256=sha)
            assert up.drain(30.0)
        lin.commit(epoch=2, step=20, sha256=sha)  # re-stamp: mirrored
        up.close()
        dirs[pkg] = d
    port, jax_ = dirs["port"], dirs["jax"]
    assert sorted(os.listdir(port / "remote")) == sorted(
        os.listdir(jax_ / "remote"))
    for f in os.listdir(port / "remote"):
        assert (port / "remote" / f).read_bytes() == \
            (jax_ / "remote" / f).read_bytes(), f
    assert (port / "ck" / "ck.pt.manifest.json").read_bytes() == \
        (jax_ / "ck" / "ck.pt.manifest.json").read_bytes()
    m = json.loads((port / "remote" / "ck.pt.manifest.json").read_bytes())
    assert m["mirror"] is True and m["head"]["epoch"] == 2
    assert [e["epoch"] for e in m["retained"]] == [1]


def _series(registry, name, family=None):
    fams = parse_exposition(registry.exposition())
    return sum(v for (n, _), v in fams[family or name]["samples"].items()
               if n == name)


def test_uploader_retries_times_out_and_reports_lag(tmp_path):
    path = str(tmp_path / "ck.pt")
    reg = MetricsRegistry()
    up = _mirror(store, path, str(tmp_path / "remote"), registry=reg,
                 policy=store.RetryPolicy(retries=3, base=0.01, cap=0.02),
                 op_timeout=0.3)
    # Two failed puts: retried, the epoch lands.
    up.store.inject_fail_puts(2)
    _commit_and_mirror(lineage, up, path, [0])
    assert _series(reg, "ddp_ckpt_upload_retries_total") == 2
    assert _series(reg, "ddp_ckpt_upload_failures_total") == 0
    assert up.state_of_epoch(0) == "mirrored"
    assert _series(reg, "ddp_mirror_lag_epochs") == 0
    # A remote slower than the per-op deadline: every attempt times out,
    # the epoch stays pending, the lag gauge shows it, training would not
    # have waited.
    up.store.inject_slow_put(5.0)
    lin = lineage.CheckpointLineage(path, keep=KEEP)
    lin.preserve_head()
    sha = _head(path, 1)
    lin.commit(epoch=1, step=10, sha256=sha)
    t0 = time.monotonic()
    up.enqueue(epoch=1, step=10, sha256=sha)
    assert time.monotonic() - t0 < 0.2
    assert _series(reg, "ddp_mirror_lag_epochs") == 1
    assert up.drain(30.0)
    assert _series(reg, "ddp_mirror_lag_epochs") == 1
    assert _series(reg, "ddp_ckpt_upload_failures_total") == 1
    assert up.state_of_epoch(1) == "pending"
    # The remote recovers: the next epoch lands and covers the lag.
    up.store.inject_slow_put(0.0)
    _commit_and_mirror(lineage, up, path, [2])
    assert _series(reg, "ddp_mirror_lag_epochs") == 0
    assert _series(reg, "ddp_ckpt_upload_seconds_count",
                   "ddp_ckpt_upload_seconds") == 2
    # The port's exposition parses in JAX's strict parser too.
    assert jregistry.parse_exposition(reg.exposition()).keys() == \
        parse_exposition(reg.exposition()).keys()
    up.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wiped_local_directory_restores_from_the_mirror(writer, tmp_path,
                                                        capfd):
    """Three mirrored epochs, the newest mirror object torn on upload,
    then the whole local directory removed: both packages' walks
    download the newest verifiable object (epoch 1) into place."""
    lin_mod, st_mod = ((lineage, store) if writer == "port"
                       else (jlineage, jstore))
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    path = str(ckdir / "ck.pt")
    remote = str(tmp_path / "remote")
    up = _mirror(st_mod, path, remote)
    _commit_and_mirror(lin_mod, up, path, [0, 1])
    up.store.inject_torn_next_put()
    _commit_and_mirror(lin_mod, up, path, [2])
    up.close()
    for walk, st in ((lineage, store), (jlineage, jstore)):
        shutil.rmtree(ckdir)
        ck, used = walk.latest_verifiable(path, store=st.DirStore(remote))
        assert (os.path.basename(used), ck.epoch, ck.step) == \
            ("ck.pt.ep00000001", 1, 10)
        err = capfd.readouterr().err
        assert "restored checkpoint from MIRROR object" in err
        assert "sha-256 verification" in err
    want = tckpt.load_checkpoint(used)
    np.testing.assert_array_equal(
        want.momentum["classifier"]["weight"],
        np.ones_like(want.momentum["classifier"]["weight"]))


def test_open_store_uris(tmp_path):
    assert isinstance(store.open_store(str(tmp_path)), store.DirStore)
    assert isinstance(store.open_store(f"dir://{tmp_path}"), store.DirStore)
    assert isinstance(store.open_store(f"local://{tmp_path}"),
                      store.LocalStore)
    with pytest.raises(store.StoreError, match="no gs backend"):
        store.open_store("gs://bucket/x")
