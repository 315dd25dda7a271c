"""Port parity, op by op: ``ddp_tpu_torch`` against ``ddp_tpu`` on the same
numpy inputs (both on the CPU; the port's wrappers take their plain
versions there).

Tolerances: gather, crop/flip, samplers and synthetic data move or draw the
same values, so they are compared exactly.  Float32 ops compare at rtol/atol
1e-5 (a few ulps): XLA and PyTorch reduce in different orders, which moves
the last bits of sums and means.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import device_augment as jaug
from ddp_tpu.data import loader as jloader
from ddp_tpu.data import sampler as jsampler
from ddp_tpu.ops import gather as jgather
from ddp_tpu.ops import layers as jlayers
from ddp_tpu.ops import losses as jlosses
from ddp_tpu.optim import schedule as jschedule
from ddp_tpu.optim import sgd as jsgd
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data import device_augment as taug
from ddp_tpu_torch.data import loader as tloader
from ddp_tpu_torch.data import resident as tresident
from ddp_tpu_torch.data import sampler as tsampler
from ddp_tpu_torch.ops import gather as tgather
from ddp_tpu_torch.ops import layers as tlayers
from ddp_tpu_torch.ops import losses as tlosses
from ddp_tpu_torch.optim import schedule as tschedule
from ddp_tpu_torch.optim import sgd as tsgd

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run ``pl.pallas_call`` in interpret mode (the CPU has no TPU)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def test_gather_matches_pallas_row_gather(pallas_interpret):
    rng = np.random.default_rng(0)
    table = rng.integers(0, 256, (40, 256), dtype=np.uint8)
    idx = rng.integers(0, 40, 9).astype(np.int32)
    want = jgather._pallas_row_gather(jnp.asarray(table), jnp.asarray(idx))
    got = tgather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_clamps_like_pallas_branch(pallas_interpret, monkeypatch,
                                          idx_dtype):
    """Out-of-range and negative indices clamp to [0, M-1] exactly as the
    JAX wrapper's Pallas branch does."""
    monkeypatch.setattr(jgather, "_use_pallas", lambda: True)
    rng = np.random.default_rng(1)
    table = rng.integers(0, 256, (30, 4, 8, 4), dtype=np.uint8)  # D = 128
    idx = np.array([-7, -1, 0, 5, 29, 30, 1000, 3], dtype=idx_dtype)
    want = jgather.gather_rows(jnp.asarray(table),
                               jnp.asarray(idx.astype(np.int32)))
    got = tgather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgather.gather_rows.launches == 0  # the CPU never launches


def test_gather_rejects_mixed_devices():
    table = torch.zeros(4, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tgather.gather_rows(table, torch.zeros(2, dtype=torch.int32))


def _bn_inputs(seed=0, shape=(4, 6, 6, 5)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    mean = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    var = (1 + 0.2 * rng.random(shape[-1])).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, mean, var, ct


def test_bn_relu_train_forward_stats_and_grads():
    x, scale, bias, mean, var, ct = _bn_inputs()
    jstate = jlayers.BatchNormState(jnp.asarray(mean), jnp.asarray(var))

    def f(x_, s_, b_):
        return jlayers.bn_relu(x_, s_, b_, jstate, train=True)

    (jz, jnew), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias))
    zero_state = jax.tree_util.tree_map(jnp.zeros_like, jnew)
    jdx, jds, jdb = vjp((jnp.asarray(ct), zero_state))

    tx = _nchw(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    tz, tnew = tlayers.bn_relu(
        tx, ts, tb, tlayers.BatchNormState(torch.from_numpy(mean),
                                           torch.from_numpy(var)),
        train=True)
    tz.backward(_nchw(ct))

    np.testing.assert_allclose(_nhwc(tz), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tnew.mean.numpy(), np.asarray(jnew.mean),
                               **TOL)
    np.testing.assert_allclose(tnew.var.numpy(), np.asarray(jnew.var), **TOL)
    np.testing.assert_allclose(_nhwc(tx.grad), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), **TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), **TOL)


def test_bn_relu_matches_unfused_composition_in_torch():
    """The hand-written backward against autograd of batch_norm + relu."""
    x, scale, bias, mean, var, ct = _bn_inputs(seed=3)
    st = tlayers.BatchNormState(torch.from_numpy(mean), torch.from_numpy(var))
    grads = []
    for fused in (True, False):
        tx = _nchw(x).requires_grad_(True)
        ts = torch.from_numpy(scale).requires_grad_(True)
        tb = torch.from_numpy(bias).requires_grad_(True)
        if fused:
            z, new = tlayers.bn_relu(tx, ts, tb, st, train=True)
        else:
            y, new = tlayers.batch_norm(tx, ts, tb, st, train=True)
            z = torch.relu(y)
        z.backward(_nchw(ct))
        grads.append((z.detach(), new, tx.grad, ts.grad, tb.grad))
    (z1, n1, *g1), (z2, n2, *g2) = grads
    torch.testing.assert_close(z1, z2, **TOL)
    torch.testing.assert_close(n1.mean, n2.mean, **TOL)
    torch.testing.assert_close(n1.var, n2.var, **TOL)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_eval_mode_batch_norm(fused):
    x, scale, bias, mean, var, _ = _bn_inputs(seed=1)
    jop, top = ((jlayers.bn_relu, tlayers.bn_relu) if fused
                else (jlayers.batch_norm, tlayers.batch_norm))
    jy, _ = jop(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                jlayers.BatchNormState(jnp.asarray(mean), jnp.asarray(var)),
                train=False)
    ty, tst = top(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                  tlayers.BatchNormState(torch.from_numpy(mean),
                                         torch.from_numpy(var)), train=False)
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.mean.numpy(), mean)


def test_conv_pool_linear_and_global_pool():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    jy = jlayers.conv2d(jnp.asarray(x), jnp.asarray(k))
    ty = tlayers.conv2d(_nchw(x), torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1))))
    np.testing.assert_allclose(_nhwc(ty), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(
        _nhwc(tlayers.max_pool(_nchw(x))),
        np.asarray(jlayers.max_pool(jnp.asarray(x), 2, 2)))
    np.testing.assert_allclose(
        tlayers.global_avg_pool(_nchw(x)).numpy(),
        np.asarray(jlayers.global_avg_pool(jnp.asarray(x))), **TOL)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    v = x[:, 0, 0, :]
    np.testing.assert_allclose(
        tlayers.linear(torch.from_numpy(v), torch.from_numpy(w.T.copy()),
                       torch.from_numpy(b)).numpy(),
        np.asarray(jlayers.linear(jnp.asarray(v), jnp.asarray(w),
                                  jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_sum_count(masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((7, 10))).astype(np.float32)
    labels = rng.integers(0, 10, 7).astype(np.int32)
    mask = (rng.random(7) < 0.6).astype(np.float32) if masked else None
    js, jc = jlosses.cross_entropy_sum_count(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    ts, tc = tlosses.cross_entropy_sum_count(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    assert float(tc) == float(jc)


def _jax_draws(key, n):
    """The draws ``_crop_flip_onehot`` makes from ``key``
    (ddp_tpu/data/device_augment.py, its first three lines)."""
    k_off, k_flip = jax.random.split(key)
    ys, xs = jax.random.randint(k_off, (2, n), 0, 2 * jaug.PAD + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (n,))
    return (torch.from_numpy(np.asarray(ys).astype(np.int64)),
            torch.from_numpy(np.asarray(xs).astype(np.int64)),
            torch.from_numpy(np.array(flip)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip_matches_onehot(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    key = jax.random.key(seed)
    want = jaug._crop_flip_onehot(key, jnp.asarray(imgs))
    got = taug.crop_flip(torch.from_numpy(imgs), *_jax_draws(key, 12))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_crop_flip_matches():
    rng = np.random.default_rng(5)
    table = rng.integers(0, 256, (50, 32, 32, 3), dtype=np.uint8)
    idx = rng.integers(0, 50, 9).astype(np.int32)
    key = jax.random.key(7)
    want = jaug.gather_crop_flip(key, jnp.asarray(table), jnp.asarray(idx))
    got = taug.gather_crop_flip(torch.from_numpy(table),
                                torch.from_numpy(idx), _jax_draws(key, 9))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch_inputs(seed, m=50, n=9):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (m, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, m).astype(np.int64)
    idx = rng.integers(0, m, n).astype(np.int32)
    return table, labels, idx


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_batch_matches_jax_as_input(pallas_interpret, monkeypatch,
                                           mode, seed):
    """The resident step's whole input, bit for bit (atol 0): JAX's
    ``_as_input(gather_crop_flip(key, ...))`` with the draws of ``key``, or
    ``_as_input(gather_rows(...))`` for eval, the Pallas gather in
    interpret mode.  JAX's eager cast divides by 255 as IEEE does, like
    the port (a ``jit`` would fold it into a multiply by 1/255, which is
    one ulp off for 126 byte values)."""
    from ddp_tpu.train.step import _as_input as jax_as_input
    monkeypatch.setattr(jgather, "_use_pallas", lambda: True)
    table, labels, idx = _batch_inputs(seed)
    key = jax.random.key(seed + 11)
    if mode == "train":
        want = jax_as_input(jaug.gather_crop_flip(key, jnp.asarray(table),
                                                  jnp.asarray(idx)))
        draws = _jax_draws(key, idx.shape[0])
    else:
        want = jax_as_input(jgather.gather_rows(jnp.asarray(table),
                                                jnp.asarray(idx)))
        draws = None
    images, got_labels = tgather.gather_batch(
        torch.from_numpy(table), torch.from_numpy(labels),
        torch.from_numpy(idx), draws)
    assert images.dtype == torch.float32 and images.shape == want.shape
    np.testing.assert_array_equal(images.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_labels.numpy(), labels[idx])
    assert tgather.gather_batch.launches == 0  # the CPU never launches


def test_u8_over_255_is_the_ieee_division_everywhere():
    """All 256 byte values: the port's plain version, JAX's eager cast and
    numpy's float32 division agree bit for bit, and a multiply by the
    reciprocal does not (why the kernel divides)."""
    from ddp_tpu.train.step import _as_input as jax_as_input
    u = np.arange(256, dtype=np.uint8)
    want = u.astype(np.float32) / np.float32(255)
    table = np.zeros((1, 32, 32, 3), dtype=np.uint8)
    table.reshape(-1)[:256] = u
    images, _ = tgather.gather_batch(torch.from_numpy(table),
                                     torch.zeros(1, dtype=torch.int64),
                                     torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(images.numpy().reshape(-1)[:256], want)
    np.testing.assert_array_equal(
        np.asarray(jax_as_input(jnp.asarray(u))), want)
    reciprocal = u.astype(np.float32) * (np.float32(1) / np.float32(255))
    assert int((reciprocal != want).sum()) == 126


def test_gather_batch_clamps_image_and_label_rows_alike():
    table, labels, _ = _batch_inputs(2, m=30)
    idx = np.array([-7, -1, 0, 5, 29, 30, 1000, 3], dtype=np.int64)
    rows = np.clip(idx, 0, 29)
    images, got_labels = tgather.gather_batch(
        torch.from_numpy(table), torch.from_numpy(labels),
        torch.from_numpy(idx))
    np.testing.assert_array_equal(got_labels.numpy(), labels[rows])
    np.testing.assert_array_equal(
        images.numpy(), table[rows].astype(np.float32) / np.float32(255))


def test_gather_batch_stores_channels_first():
    """``_as_input`` of the NHWC result returns its buffer without a copy."""
    from ddp_tpu_torch.train.step import _as_input
    table, labels, idx = _batch_inputs(3)
    images, _ = tgather.gather_batch(
        torch.from_numpy(table), torch.from_numpy(labels),
        torch.from_numpy(idx), _jax_draws(jax.random.key(0), idx.shape[0]))
    nchw = _as_input(images)
    assert nchw.is_contiguous() and nchw.shape == (idx.shape[0], 3, 32, 32)
    assert nchw.data_ptr() == images.data_ptr()


def _meta_batch_args():
    """Valid arguments of ``gather_batch``, on the meta device."""
    meta = dict(device="meta")
    return [torch.empty((10, 32, 32, 3), dtype=torch.uint8, **meta),
            torch.empty(10, dtype=torch.int64, **meta),
            torch.empty(4, dtype=torch.int32, **meta),
            (torch.empty(4, dtype=torch.int64, **meta),
             torch.empty(4, dtype=torch.int64, **meta),
             torch.empty(4, dtype=torch.bool, **meta))]


@pytest.mark.parametrize("what,change,match", [
    ("table", lambda a: a.float(), "table"),
    ("table", lambda a: a[:, :16], "table"),
    ("table", lambda a: a.permute(0, 2, 1, 3), "table"),
    ("table", lambda a: a[:0], "table"),
    ("labels", lambda a: a.int(), "labels"),
    ("labels", lambda a: a[:9], "labels"),
    ("idx", lambda a: a.float(), "idx"),
    ("idx", lambda a: a.view(2, 2), "idx"),
    ("draws", lambda d: d[:2], "draws"),
    ("draws", lambda d: (d[0][:3],) + d[1:], "ys"),
    ("draws", lambda d: d[:1] + (d[1].int(), d[2]), "xs"),
    ("draws", lambda d: d[:2] + (d[2].to(torch.uint8),), "flip"),
    (None, None, "CUDA device"),
])
def test_gather_batch_rejects_what_the_kernel_does_not_take(what, change,
                                                            match):
    """The wrapper's checks, without a card: each bad argument raises a
    ValueError naming it, and valid tensors off the CPU and off CUDA (meta)
    are refused as such."""
    table, labels, idx, draws = _meta_batch_args()
    args = dict(table=table, labels=labels, idx=idx, draws=draws)
    if what is not None:
        args[what] = change(args[what])
    with pytest.raises(ValueError, match=match):
        tgather.gather_batch(**args)


def test_make_draws_distribution():
    g = torch.Generator().manual_seed(0)
    ys, xs, flip = taug.make_draws(g, 20000, torch.device("cpu"))
    for d in (ys, xs):
        assert int(d.min()) == 0 and int(d.max()) == 2 * taug.PAD
    assert abs(flip.float().mean().item() - 0.5) < 0.02


def test_sgd_matches_apply_updates():
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 3, 3, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg = (0.9, 5e-4)
    jp = [jnp.asarray(p) for p in params]
    jst = jsgd.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tbuf = tsgd.init(tp)
    for step, lr in enumerate((0.0, 0.1, 0.37)):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, jst = jsgd.apply_updates(
            jp, [jnp.asarray(g) for g in grads], jst, lr,
            jsgd.SGDConfig(lr=0.4, momentum=cfg[0], weight_decay=cfg[1]))
        tsgd.apply_updates(tp, [torch.from_numpy(g) for g in grads], tbuf, lr,
                           tsgd.SGDConfig(0.4, *cfg))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_sgd_matches_torch_optim_sgd():
    """The hand loop is ``torch.optim.SGD`` with dampening 0."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    ref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.SGD([ref], lr=0.2, momentum=0.9, weight_decay=5e-4)
    mine = [torch.from_numpy(p0.copy())]
    buf = tsgd.init(mine)
    for _ in range(3):
        g = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
        ref.grad = g.clone()
        opt.step()
        tsgd.apply_updates(mine, [g], buf, 0.2, tsgd.SGDConfig(0.2))
    torch.testing.assert_close(mine[0], ref.detach(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, dict(base_lr=0.1, num_epochs=3,
                                         steps_per_epoch=7)])
def test_triangular_lr(kw):
    for step in range(0, 2100, 13):
        np.testing.assert_allclose(
            tschedule.triangular_lr(step, **kw),
            float(jschedule.triangular_lr(step, **kw)), rtol=1e-6,
            atol=1e-7)


@pytest.mark.parametrize("world,shuffle,drop_last", [
    (1, True, False), (3, True, False), (4, False, False), (3, True, True)])
def test_distributed_shard_sampler(world, shuffle, drop_last):
    for rank in range(world):
        j = jsampler.DistributedShardSampler(103, world, rank, shuffle,
                                             seed=5, drop_last=drop_last)
        t = tsampler.DistributedShardSampler(103, world, rank, shuffle,
                                             seed=5, drop_last=drop_last)
        for epoch in (0, 1, 7):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            np.testing.assert_array_equal(t.indices(), j.indices())
            assert len(t) == len(j)


@pytest.mark.parametrize("replicas,batch", [(1, 8), (1, 16), (2, 5)])
def test_index_matrices(replicas, batch):
    jtr, jte = jcifar.synthetic(n_train=37, n_test=21)
    ttr, tte = tcifar.synthetic(n_train=37, n_test=21)
    jl = jloader.TrainLoader(jtr, batch, replicas, seed=3, augment=False)
    tl = tloader.TrainLoader(ttr, batch, replicas, seed=3)
    assert len(tl) == len(jl)
    for epoch in (0, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        (jf, jt), (tf, tt) = jl.epoch_index_matrix(), tl.epoch_index_matrix()
        np.testing.assert_array_equal(tf, jf)
        assert (jt is None) == (tt is None)
        if jt is not None:
            np.testing.assert_array_equal(tt, jt)
    je = jloader.EvalLoader(jte, batch, replicas).epoch_index_matrix()
    te = tloader.EvalLoader(tte, batch, replicas).epoch_index_matrix()
    for a, b in zip(te, je):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise", [0.0, 0.25])
def test_synthetic_identical(noise):
    for a, b in zip(tcifar.synthetic(64, 16, seed=3, label_noise=noise),
                    jcifar.synthetic(64, 16, seed=3, label_noise=noise)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_load_reads_pickle_layout(tmp_path):
    import pickle
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(8)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 3))}, f)
    for a, b in zip(tcifar.load(str(tmp_path)),
                    jcifar.load(str(tmp_path), download=False)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        tcifar.load(str(tmp_path / "missing"))


def test_resident_memory_guard(monkeypatch):
    ds, _ = tcifar.synthetic(n_train=16, n_test=4)
    res = tresident.ResidentData(ds, torch.device("cpu"))
    assert res.images.dtype == torch.uint8
    np.testing.assert_array_equal(res.images.numpy(), ds.images)
    monkeypatch.setattr(tresident, "_device_bytes_free", lambda d: 1000)
    with pytest.raises(ValueError, match="resident mode"):
        tresident.ResidentData(ds, torch.device("cpu"))
