"""The port's checkpoint against ``ddp_tpu``'s, both directions, and resume.

A file written by either package restores in the other: the same v1 keys
and layouts (``ddp_tpu_torch.train.checkpoint`` through
``ddp_tpu_torch.interop``).  Tolerances: weights, buffers and momentum
move through the file unchanged, so they compare exactly; eval logits of
the restored models compare at 1e-5 (XLA and PyTorch sum the
convolutions in different orders).  A resumed CPU run repeats the
uninterrupted one bit for bit.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.parallel import make_mesh
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.ckpt_shard import save_checkpoint_sharded
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.data import TrainLoader, synthetic
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train.step import make_eval_apply
from ddp_tpu_torch.train.trainer import Trainer

NARROW = [8, "M", 16, "M", 512, "M"]
DATA_STATE = {"version": 1, "epoch": 4, "offset": 0, "seed": 3,
              "rng_folds": 0}


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    return NARROW


def _images(seed=0, n=4):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _jax_logits(params, stats, imgs):
    logits, _ = jvgg.apply(params, stats,
                           jnp.asarray(imgs).astype(jnp.float32) / 255.0,
                           train=False)
    return np.asarray(logits)


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree))


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _jax_state(seed):
    params, stats = jvgg.init(jax.random.key(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    # Trained-looking BN statistics, not the init's zeros and ones.
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, _random_like(stats, seed + 1))
    return params, stats, _random_like(params, seed + 2)


def test_jax_checkpoint_restores_in_the_port(narrow, tmp_path):
    params, stats, momentum = _jax_state(0)
    path = str(tmp_path / "jax.pt")
    jckpt.save_checkpoint(path, params, stats, SGDState(momentum), step=37,
                          epoch=3, data_state=DATA_STATE)
    ck = tckpt.load_checkpoint(path)
    assert (ck.step, ck.epoch, ck.data_state) == (37, 3, DATA_STATE)

    model = VGG(narrow)
    buffers = [torch.zeros_like(p) for p in model.parameters()]
    tckpt.restore(ck, model, buffers)
    imgs = _images()
    got = make_eval_apply(model)(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), _jax_logits(params, stats, imgs),
                               rtol=1e-5, atol=1e-5)
    _assert_trees_equal(interop.momentum_tree_from_list(model, buffers),
                        momentum)
    _assert_trees_equal(interop.jax_from_state_dict("vgg", model.state_dict()),
                        (params, stats))


def test_port_checkpoint_restores_in_jax(narrow, tmp_path):
    model = VGG(narrow, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # trained-looking BN statistics
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape) + 0.25)
    momentum = [torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(i)) for i, p in
                enumerate(model.parameters())]
    path = str(tmp_path / "port.pt")
    sha = tckpt.save_checkpoint(path, model, momentum, step=12, epoch=1,
                                data_state=DATA_STATE)
    assert sha == jckpt.sha256_of_file(path)

    ck = jckpt.load_checkpoint(path)
    assert (ck.step, ck.epoch, ck.data_state) == (12, 1, DATA_STATE)
    params = jax.tree_util.tree_map(np.asarray, ck.params)
    stats = jax.tree_util.tree_map(np.asarray, ck.batch_stats)
    imgs = _images(1)
    want = make_eval_apply(model)(torch.from_numpy(imgs))
    np.testing.assert_allclose(_jax_logits(params, stats, imgs),
                               want.numpy(), rtol=1e-5, atol=1e-5)
    _assert_trees_equal(ck.opt_state.momentum_buf,
                        interop.momentum_tree_from_list(model, momentum))


def test_both_packages_write_the_same_file(narrow, tmp_path):
    """Key for key, dtype for dtype and value for value."""
    params, stats, momentum = _jax_state(7)
    jpath, tpath = str(tmp_path / "j.pt"), str(tmp_path / "t.pt")
    jckpt.save_checkpoint(jpath, params, stats, SGDState(momentum), step=9,
                          epoch=2, data_state=DATA_STATE)
    model = VGG(narrow)
    model.load_state_dict(interop.state_dict_from_jax("vgg", params, stats))
    tckpt.save_checkpoint(tpath, model,
                          interop.momentum_list_from_tree(model, momentum),
                          step=9, epoch=2, data_state=DATA_STATE)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "momentum/backbone/conv0/kernel" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_momentum_tree_mapping_round_trips(narrow):
    model = VGG(narrow)
    buffers = [torch.randn(p.shape) for p in model.parameters()]
    tree = interop.momentum_tree_from_list(model, buffers)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(_jax_state(0)[0])
    back = interop.momentum_list_from_tree(model, tree)
    assert all(torch.equal(a, b) for a, b in zip(buffers, back))


_CLI = ["2", "2", "--batch_size", "8", "--resident", "--synthetic",
        "--synthetic_size", "32", "--device", "cpu", "--lr", "0.05"]


def test_cli_resume_repeats_the_uninterrupted_run(tmp_path, capsys):
    """``2 2`` saves after epoch 0 only; ``2 2 --resume`` from that file
    trains epoch 1 alone and ends where the uninterrupted run ended, bit
    for bit (losses, weights, buffers, momentum, step).  Both runs use the
    same two-epoch LR schedule: a ``1 1`` run's schedule spans one epoch
    and would not continue into ``2 1``'s."""
    path = str(tmp_path / "checkpoint.pt")
    full = cli.main(_CLI + ["--snapshot_path", path])
    printed = capsys.readouterr().out
    assert f"Epoch 0 | Training checkpoint saved at {path}" in printed
    assert "Epoch 1 | Training checkpoint saved" not in printed
    resumed = cli.main(_CLI + ["--snapshot_path", path, "--resume"])
    assert "Resuming training from snapshot at Epoch 0" in \
        capsys.readouterr().out
    assert len(full["loss_history"]) == 8
    assert resumed["loss_history"] == full["loss_history"][4:]
    a, b = full["state"], resumed["state"]
    assert a.step == b.step == 8
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(a.momentum, b.momentum))
    assert resumed["accuracy"] == full["accuracy"]


def _trainer(path, narrow, resume=False, seed=2):
    ds, _ = synthetic(n_train=24, n_test=8, seed=1)
    loader = TrainLoader(ds, 8, seed=seed)
    sched = functools.partial(triangular_lr, base_lr=0.05, num_epochs=3,
                              steps_per_epoch=len(loader))
    return Trainer(VGG(narrow), loader, device=torch.device("cpu"),
                   lr_schedule=sched, sgd_config=SGDConfig(lr=0.05),
                   seed=seed, save_every=1, snapshot_path=path,
                   resume=resume)


def test_trainer_resume_continues_exactly(narrow, tmp_path):
    """The JAX package's resume test at the Trainer: 3 epochs straight, or
    2 epochs, a restart, and the third; the checkpoint is written at every
    epoch with the next epoch as its resume position."""
    full = _trainer(str(tmp_path / "full.pt"), narrow)
    full.train(3)
    half_path = str(tmp_path / "half.pt")
    _trainer(half_path, narrow).train(2)
    ck = tckpt.load_checkpoint(half_path)
    assert ck.epoch == 1 and ck.step == 6
    assert ck.data_state == {"version": 1, "epoch": 2, "offset": 0,
                             "seed": 2, "rng_folds": 0}
    resumed = _trainer(half_path, narrow, resume=True)
    assert resumed.start_epoch == 2 and resumed.state.step == 6
    resumed.train(3)
    assert resumed.loss_history == full.loss_history[6:]
    sa = full.state.model.state_dict()
    sb = resumed.state.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_resume_without_a_file_starts_fresh(narrow, tmp_path):
    t = _trainer(str(tmp_path / "missing.pt"), narrow, resume=True)
    assert t.start_epoch == 0 and t.state.step == 0


def test_resume_without_data_state_starts_after_the_saved_epoch(
        narrow, tmp_path, capsys):
    params, stats, momentum = _jax_state(3)
    path = str(tmp_path / "old.pt")
    jckpt.save_checkpoint(path, params, stats, SGDState(momentum), step=3,
                          epoch=0)
    t = _trainer(path, narrow, resume=True)
    assert t.start_epoch == 1 and t.state.step == 3
    assert "no data_state record" in capsys.readouterr().err


def _valid_file(tmp_path, narrow):
    model = VGG(narrow)
    path = str(tmp_path / "valid.pt")
    tckpt.save_checkpoint(path, model, [torch.zeros_like(p) for p in
                                        model.parameters()], 1, 0)
    return path


def test_torn_file_is_a_named_error(narrow, tmp_path):
    path = _valid_file(tmp_path, narrow)
    torn = str(tmp_path / "torn.pt")
    with open(path, "rb") as f, open(torn, "wb") as g:
        g.write(f.read()[: os.path.getsize(path) // 2])
    with pytest.raises(tckpt.CheckpointError, match="torn"):
        tckpt.load_checkpoint(torn)


def test_damaged_member_fails_its_crc(narrow, tmp_path):
    path = _valid_file(tmp_path, narrow)
    with np.load(path) as z:
        info = z.zip.getinfo("params/classifier/weight.npy")
    data = bytearray(open(path, "rb").read())
    # The member's data follows its local header (30 bytes, the name and
    # the extra field); flip a byte near its end, inside the stored array.
    name_len, extra_len = np.frombuffer(
        bytes(data[info.header_offset + 26:info.header_offset + 30]),
        "<u2")
    start = info.header_offset + 30 + int(name_len) + int(extra_len)
    data[start + info.compress_size - 8] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(tckpt.CheckpointError, match="torn"):
        tckpt.load_checkpoint(path)


def test_foreign_npz_is_a_named_error(tmp_path):
    path = str(tmp_path / "foreign.npz")
    np.savez(path, weights=np.zeros(3))
    with pytest.raises(tckpt.CheckpointError, match="not a ddp_tpu"):
        tckpt.load_checkpoint(path)


def test_sharded_v2_index_is_refused_by_name(narrow, tmp_path):
    params, stats, momentum = _jax_state(4)
    path = str(tmp_path / "sharded.pt")
    save_checkpoint_sharded(path, params, stats, SGDState(momentum), 3, 1,
                            mesh=make_mesh(1))
    with pytest.raises(tckpt.CheckpointError,
                       match="sharded.*not ported yet"):
        tckpt.load_checkpoint(path)


def test_mid_epoch_file_is_refused_on_resume(narrow, tmp_path):
    """A JAX mid-epoch emergency save (offset > 0) resumes on the streaming
    path only: the resident path dispatches whole epochs."""
    params, stats, momentum = _jax_state(5)
    path = str(tmp_path / "midepoch.pt")
    jckpt.save_checkpoint(path, params, stats, SGDState(momentum), step=5,
                          epoch=1, data_state=dict(DATA_STATE, epoch=1,
                                                   offset=2))
    assert tckpt.load_checkpoint(path).data_state["offset"] == 2
    with pytest.raises(tckpt.CheckpointError, match="mid-epoch"):
        _trainer(path, narrow, resume=True)


def test_snapshot_path_none_writes_nothing(narrow, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t = _trainer(None, narrow)
    t.train(1)
    assert os.listdir(tmp_path) == []


def test_data_state_blob_is_json(narrow, tmp_path):
    path = str(tmp_path / "ds.pt")
    model = VGG(narrow)
    tckpt.save_checkpoint(path, model, [torch.zeros_like(p) for p in
                                        model.parameters()], 4, 2,
                          data_state=DATA_STATE)
    with np.load(path) as z:
        blob = z["meta/data_state_json"]
        assert blob.dtype == np.uint8
        assert json.loads(blob.tobytes()) == DATA_STATE
        assert int(z["meta/format_version"]) == 1
