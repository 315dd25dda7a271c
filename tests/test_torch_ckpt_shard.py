"""The port's sharded (v2) checkpoint and asynchronous writer against
``ddp_tpu``'s, both directions.

Tolerances: none; a file carries its arrays unchanged.  JAX's v2 sets
(DeepNN tensor-parallel at mesh (2,4), and at (4,1)) load in the port equal
leaf for leaf to JAX's own load.  A port set at m = 1 is read by JAX's
``read_shard_index``, ``assemble_checkpoint`` and ``load_for_mesh``, and is
byte for byte the set JAX's save writes of the same state.  A torn or
missing shard fails with a named error and the walk falls back; a dropped
epoch's shards are trimmed.  The trainer's asynchronous save writes the
bytes of the synchronous ``save_checkpoint`` of the same state, and a
failed write raises at the next join.  Zip entries carry the time of
writing, so the byte comparisons freeze ``zipfile``'s clock.
"""
import functools
import os
import time
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.parallel.mesh import make_mesh
from ddp_tpu.parallel.tp.plan import plan_for_model, state_shardings
from ddp_tpu.resilience import lineage as jlineage
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train import ckpt_shard as jshard
from ddp_tpu.train.step import init_train_state as jinit_train_state
from ddp_tpu_torch.data import TrainLoader, synthetic
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.resilience import faults, lineage
from ddp_tpu_torch.train import checkpoint as tckpt, ckpt_shard
from ddp_tpu_torch.train.trainer import Trainer

NARROW = [8, "M", 16, "M", 512, "M"]
DS = {"version": 1, "epoch": 2, "offset": 0, "seed": 0, "rng_folds": 0}


@pytest.fixture
def frozen_zip_clock(monkeypatch):
    """Every zip entry stamped with one time, so two saves of one state
    give one byte stream."""
    t = time.time()
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: t, localtime=time.localtime))


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree))


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _assert_same(port_ck, jax_ck):
    for section in ("params", "batch_stats"):
        _assert_trees_equal(getattr(port_ck, section),
                            getattr(jax_ck, section))
    _assert_trees_equal(port_ck.momentum, jax_ck.opt_state.momentum_buf)
    assert (port_ck.step, port_ck.epoch, port_ck.data_state) == \
        (jax_ck.step, jax_ck.epoch, jax_ck.data_state)


@pytest.mark.parametrize("shape,tp", [((2, 4), True), ((4, 1), False)])
def test_jax_sets_load_leaf_equal(shape, tp, tmp_path):
    """JAX's DeepNN at mesh (2,4) under the m = 4 plan (four slots, its
    leaves split over the model axis) and at (4,1) (one slot)."""
    model = jget_model("deepnn")
    params, stats = model.init(jax.random.key(0))
    mesh = make_mesh(shape=shape)
    plan = plan_for_model("deepnn", jax.device_get(params), stats,
                          model_size=shape[1])
    state = jinit_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                              {})
    state = state._replace(opt_state=SGDState(jax.tree_util.tree_map(
        lambda p: p * 0.5 + 1.0, state.params)))
    if tp:
        state = jax.device_put(state, state_shardings(plan, mesh))
    path = str(tmp_path / "ck.pt")
    _, names = jshard.save_checkpoint_sharded(
        path, state.params, state.batch_stats, state.opt_state, 7, 1,
        mesh=mesh, data_state=DS)
    assert len(names) == shape[1]
    index = ckpt_shard.read_shard_index(path)
    assert index["n_slots"] == shape[1]
    assert any(e["shard_dim"] is not None
               for e in index["leaves"].values()) == tp
    _assert_same(tckpt.load_checkpoint(path), jckpt.load_checkpoint(path))


def _port_state(seed=0):
    model = VGG(NARROW, generator=torch.Generator().manual_seed(seed))
    momentum = {n: torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(seed + i))
                for i, (n, p) in enumerate(model.named_parameters())}
    return tckpt.state_arrays("vgg", model.state_dict(), momentum)


def test_port_set_is_jax_set_and_jax_reads_it(tmp_path, monkeypatch,
                                              frozen_zip_clock):
    """The port's m = 1 save of a state and JAX's save of the same host
    trees at mesh (1, 1): the same index and shard bytes; JAX's three
    readers give the port's arrays back."""
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    arrays = _port_state()
    port, jax_path = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    sha, names = ckpt_shard.save_checkpoint_sharded(port, arrays, 7, 1,
                                                    data_state=DS)
    ck = tckpt.load_checkpoint(port)
    jsha, jnames = jshard.save_checkpoint_sharded(
        jax_path, ck.params, ck.batch_stats, SGDState(ck.momentum), 7, 1,
        mesh=make_mesh(1), data_state=DS)
    assert [n.replace("port", "jax") for n in names] == jnames
    assert tckpt.sha256_of_file(str(tmp_path / names[0])) == \
        tckpt.sha256_of_file(str(tmp_path / jnames[0]))
    # The index names its shard file, so compare the parsed index and
    # the other members.
    assert jshard.read_shard_index(port)["leaves"] == \
        jshard.read_shard_index(jax_path)["leaves"]
    assert jshard.read_shard_index(port)["mesh_shape"] == [1, 1]
    for reader in (jckpt.load_checkpoint, jshard.assemble_checkpoint,
                   functools.partial(jshard.load_for_mesh,
                                     mesh=make_mesh(1))):
        got = reader(port)
        flat = {f"{s}/{'/'.join(str(k.key) for k in p)}": np.asarray(v)
                for s, tree in (("params", got.params),
                                ("batch_stats", got.batch_stats),
                                ("momentum", got.opt_state.momentum_buf))
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}
        assert flat.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(flat[k], arrays[k], err_msg=k)
        assert (got.step, got.epoch, got.data_state) == (7, 1, DS)
    assert sha == tckpt.sha256_of_file(port)


def test_specs_are_jax_lists():
    from jax.sharding import PartitionSpec as P
    from ddp_tpu.parallel.tp.plan import spec_to_json as jspec_to_json
    for spec in ((), (None, "model"), ("model", None, None),
                 (("data", "model"), None)):
        want = jspec_to_json(P(*spec))
        assert ckpt_shard.spec_to_json(spec) == want
        assert ckpt_shard.spec_to_json(ckpt_shard.spec_from_json(want)) == \
            want


def test_n_slots_above_1_is_refused_by_name(tmp_path):
    # More than one slot needs the plan's leaf specs, which say what each
    # slot holds (tests/test_torch_tp.py writes such sets).
    with pytest.raises(ValueError, match="tree_specs"):
        ckpt_shard.save_checkpoint_sharded(str(tmp_path / "ck.pt"),
                                           _port_state(), 0, 0, n_slots=2)
    assert not os.listdir(tmp_path)


def _trees(arrays):
    """``state_arrays``' flat leaves as JAX's (params, batch_stats,
    momentum) trees."""
    return [tckpt._unflatten({k.partition("/")[2]: v
                              for k, v in arrays.items()
                              if k.partition("/")[0] == section})
            for section in ("params", "batch_stats", "momentum")]


def _sharded_lineage(path, epochs, keep, pkg="port"):
    lin = (lineage if pkg == "port" else jlineage).CheckpointLineage(
        path, keep=keep)
    for e in range(epochs):
        arrays, ds = _port_state(e), dict(DS, epoch=e + 1)
        lin.preserve_head()
        if pkg == "port":
            sha, shards = ckpt_shard.save_checkpoint_sharded(
                path, arrays, 10 * e, e, data_state=ds)
        else:
            params, stats, momentum = _trees(arrays)
            sha, shards = jshard.save_checkpoint_sharded(
                path, params, stats, SGDState(momentum), 10 * e, e,
                mesh=make_mesh(1), data_state=ds)
        lin.commit(epoch=e, step=10 * e, sha256=sha, shards=shards,
                   data_state=ds)


@pytest.mark.parametrize("damage", ["torn", "missing"])
def test_torn_or_missing_shard_is_named_and_walked_past(damage, tmp_path,
                                                       capfd):
    path = str(tmp_path / "ck.pt")
    _sharded_lineage(path, 3, 2)
    shard = str(tmp_path / ckpt_shard.shard_file_name(path, 2, 0, 1))
    if damage == "torn":
        faults.tear_file(shard)
    else:
        os.unlink(shard)
    word = "sha256 mismatch" if damage == "torn" else "MISSING"
    with pytest.raises(tckpt.CheckpointError, match=word):
        tckpt.load_checkpoint(path)
    ck, used = lineage.latest_verifiable(path)
    assert (os.path.basename(used), ck.epoch) == ("ck.pt.ep00000001", 1)
    assert word in capfd.readouterr().err
    jck, jused = jlineage.latest_verifiable(path)
    assert (jused, jck.epoch) == (used, 1)


def test_dropped_epochs_shards_are_trimmed_as_jax_trims(tmp_path,
                                                        frozen_zip_clock):
    """Four epochs at keep 2: the head's and the retained epoch's shard
    files stay, the rest go, and the JAX lineage over the same saves keeps
    the same files and writes the same manifest."""
    dirs = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        _sharded_lineage(str(d / "ck.pt"), 4, 2, pkg)
        dirs[pkg] = d
    assert sorted(os.listdir(dirs["port"])) == sorted(
        os.listdir(dirs["jax"])) == [
        "ck.pt", "ck.pt.ep00000002", "ck.pt.ep00000002.shard00000-of-00001"
        ".npz", "ck.pt.ep00000003.shard00000-of-00001.npz",
        "ck.pt.manifest.json"]
    assert lineage.read_manifest(str(dirs["port"] / "ck.pt"))["head"][
        "shards"] == ["ck.pt.ep00000003.shard00000-of-00001.npz"]
    for f in os.listdir(dirs["port"]):
        assert (dirs["port"] / f).read_bytes() == \
            (dirs["jax"] / f).read_bytes(), f


def _trainer(path, fmt="gathered"):
    ds, _ = synthetic(n_train=24, n_test=8, seed=1)
    loader = TrainLoader(ds, 8, seed=2)
    sched = functools.partial(triangular_lr, base_lr=0.05, num_epochs=2,
                              steps_per_epoch=len(loader))
    return Trainer(VGG(NARROW), loader, device=torch.device("cpu"),
                   lr_schedule=sched, sgd_config=SGDConfig(lr=0.05),
                   seed=2, save_every=1, snapshot_path=path,
                   keep_checkpoints=2, ckpt_format=fmt)


@pytest.mark.parametrize("fmt", ["gathered", "sharded"])
def test_async_save_writes_the_synchronous_bytes(fmt, tmp_path,
                                                 frozen_zip_clock):
    """The writer thread's file (v1, or the v2 index and its shard) has
    the sha256 of the synchronous save of the same state; the save record
    names its bytes."""
    tr = _trainer(str(tmp_path / "ck.pt"), fmt)
    tr.train(1)
    (tmp_path / "sync").mkdir()
    sync = str(tmp_path / "sync" / "ck.pt")
    model, mom = tr.state.model, tr.state.momentum
    if fmt == "gathered":
        tckpt.save_checkpoint(sync, model, mom, tr.state.step, 0,
                              data_state=tr._data_state(1, 0))
    else:
        ckpt_shard.save_checkpoint_sharded(
            sync, tckpt.state_arrays("vgg", model.state_dict(),
                                     tckpt._named_momentum(model, mom)),
            tr.state.step, 0, data_state=tr._data_state(1, 0))
    synced = sorted(os.listdir(tmp_path / "sync"))
    assert len(synced) == (1 if fmt == "gathered" else 2)
    for f in synced:
        assert tckpt.sha256_of_file(str(tmp_path / f)) == \
            tckpt.sha256_of_file(str(tmp_path / "sync" / f)), f
    (rec,) = tr.saves
    assert rec["epoch"] == 0 and rec["writer_s"] > 0 and \
        rec["main_ms"] >= 0 and rec["bytes"] == sum(
            os.path.getsize(tmp_path / f) for f in synced)


def test_failed_write_raises_at_the_next_join(tmp_path, monkeypatch):
    """``fail_ckpt_write@epoch=0``: the error surfaces at epoch 1's save,
    the lineage untouched by the failed write."""
    monkeypatch.setenv(faults.FAULT_ENV, "fail_ckpt_write@epoch=0")
    tr = _trainer(str(tmp_path / "ck.pt"))
    faults.install_env_faults(tr)
    with pytest.raises(OSError, match="injected checkpoint write failure "
                                      "at epoch 0"):
        tr.train(2)
    assert not os.listdir(tmp_path)
    assert [s["epoch"] for s in tr.saves] == [0]
    assert "writer_s" not in tr.saves[0]
