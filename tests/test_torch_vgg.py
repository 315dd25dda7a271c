"""Port parity for VGG and the resident epoch: ``ddp_tpu_torch`` against
``ddp_tpu`` from the same weights (mapped by ``ddp_tpu_torch.interop``) and
the same data, both on the CPU with augmentation off.

Tolerances:
- full-width eval logits, rtol/atol 1e-4: eight float32 convolutions whose
  sums XLA and PyTorch take in different orders (measured 2e-9 here, on
  logits of ~1e-2; the bound leaves room for other CPU kernels);
- narrow train-mode forward and BN statistics, 1e-5 (measured 2e-6: batch
  statistics of activations of order 1-10);
- the 4-step resident epoch (3 full batches and a ragged tail), 1e-4 on
  losses, weights and BN buffers: rounding differences grow through
  training (measured 9e-7 at lr 0.05);
- eval counters exactly (the same argmax on logits that agree to 1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import loader as jloader
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.parallel import make_mesh
from ddp_tpu.train.epoch import (make_eval_epoch, make_train_epoch,
                                 put_index_matrix)
from ddp_tpu.train.step import init_train_state
from ddp_tpu_torch import interop
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data import loader as tloader
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.train import epoch as tepoch
from ddp_tpu_torch.train import step as tstep
from ddp_tpu_torch.train.evaluate import evaluate_resident
from ddp_tpu_torch.data.resident import ResidentData

NARROW = [8, "M", 16, "M", 512, "M"]


def _port_model(params, stats, arch=None):
    model = VGG(arch)
    model.load_state_dict(interop.state_dict_from_jax("vgg", params, stats))
    return model


def _jax_state(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    return NARROW


def test_parameter_count_and_names():
    model = VGG()
    assert sum(p.numel() for p in model.parameters()) == 9_228_362
    params, stats = jvgg.init(jax.random.key(0))
    sd = interop.state_dict_from_jax("vgg", _jax_state(params),
                                         _jax_state(stats))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


def test_interop_roundtrip_exact():
    params, stats = _jax_state(jvgg.init(jax.random.key(1)))
    back_p, back_s = interop.jax_from_state_dict("vgg",
        interop.state_dict_from_jax("vgg", params, stats))
    for a, b in zip(jax.tree_util.tree_leaves((params, stats)),
                    jax.tree_util.tree_leaves((back_p, back_s))):
        np.testing.assert_array_equal(a, b)
    assert (jax.tree_util.tree_structure((params, stats))
            == jax.tree_util.tree_structure((back_p, back_s)))


def test_full_width_eval_logits():
    params, stats = jvgg.init(jax.random.key(2))
    imgs = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)
    want, _ = jvgg.apply(params, stats,
                         jnp.asarray(imgs).astype(jnp.float32) / 255.0,
                         train=False)
    model = _port_model(_jax_state(params), _jax_state(stats))
    got = tstep.make_eval_apply(model)(torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_narrow_train_forward_and_new_stats(narrow):
    params, stats = jvgg.init(jax.random.key(3))
    imgs = np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    want, new_stats = jvgg.apply(
        params, stats, jnp.asarray(imgs).astype(jnp.float32) / 255.0,
        train=True)
    model = _port_model(_jax_state(params), _jax_state(stats), narrow)
    model.train()
    got = model(tstep._as_input(torch.from_numpy(imgs)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    _, port_stats = interop.jax_from_state_dict("vgg", model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(port_stats),
                    jax.tree_util.tree_leaves(_jax_state(new_stats))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_resident_epoch_and_eval_match(narrow):
    seed, lr, batch = 3, 0.05, 8
    jtrain, jtest = jcifar.synthetic(n_train=28, n_test=20)
    ttrain, ttest = tcifar.synthetic(n_train=28, n_test=20)
    params, stats = jvgg.init(jax.random.key(seed))
    model = _port_model(_jax_state(params), _jax_state(stats), narrow)

    # JAX: the scan-per-epoch program on a 1-device mesh.
    mesh = make_mesh(1)
    jl = jloader.TrainLoader(jtrain, batch, seed=seed, augment=False)
    jl.set_epoch(0)
    full, tail = jl.epoch_index_matrix()
    assert full.shape == (3, batch) and tail.shape == (4,)
    jsched = functools.partial(jlr, base_lr=lr, num_epochs=1,
                               steps_per_epoch=len(jl))
    from ddp_tpu.models import get_model as jget_model
    jmodel = jget_model("vgg")
    epoch_fn = make_train_epoch(jmodel, JSGDConfig(lr=lr), jsched, mesh)
    state = init_train_state(params, stats)
    images, labels = jnp.asarray(jtrain.images), jnp.asarray(jtrain.labels)
    rng = jax.random.key(seed)
    state, l_full = epoch_fn(state, images, labels,
                             put_index_matrix(full, mesh), rng)
    state, l_tail = epoch_fn(state, images, labels,
                             put_index_matrix(tail[None], mesh), rng)
    jlosses = np.concatenate([np.asarray(l_full), np.asarray(l_tail)])

    # Port: the same epoch, same index rows, same schedule.
    tl = tloader.TrainLoader(ttrain, batch, seed=seed)
    tl.set_epoch(0)
    tfull, ttail = tl.epoch_index_matrix()
    np.testing.assert_array_equal(tfull, full)
    tsched = functools.partial(triangular_lr, base_lr=lr, num_epochs=1,
                               steps_per_epoch=len(tl))
    res = ResidentData(ttrain, torch.device("cpu"))
    tstate = tstep.init_train_state(model)
    run = tepoch.make_train_epoch(model, SGDConfig(lr=lr), tsched)
    tlosses = torch.cat([
        run(tstate, res.images, res.labels, torch.from_numpy(tfull)),
        run(tstate, res.images, res.labels, torch.from_numpy(ttail[None]))])
    assert tstate.step == int(state.step) == 4

    np.testing.assert_allclose(tlosses.numpy(), jlosses, rtol=1e-4,
                               atol=1e-4)
    port_p, port_s = interop.jax_from_state_dict("vgg", model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves((port_p, port_s)),
                    jax.tree_util.tree_leaves(
                        _jax_state((state.params, state.batch_stats)))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    # Eval counters over the padded test index matrix, trained weights.
    jidx, jmask = jloader.EvalLoader(jtest, batch).epoch_index_matrix()
    jc, jt = make_eval_epoch(jmodel, mesh)(
        state.params, state.batch_stats, jnp.asarray(jtest.images),
        jnp.asarray(jtest.labels), put_index_matrix(jidx, mesh),
        put_index_matrix(jmask, mesh))
    eval_loader = tloader.EvalLoader(ttest, batch)
    tidx, tmask = eval_loader.epoch_index_matrix()
    tres = ResidentData(ttest, torch.device("cpu"))
    tc, tt = tepoch.make_eval_epoch(model)(
        tres.images, tres.labels, torch.from_numpy(tidx),
        torch.from_numpy(tmask))
    assert (float(tc), float(tt)) == (float(jc), float(jt)) and \
        float(tt) == 20.0
    assert evaluate_resident(model, tres, eval_loader) == \
        pytest.approx(float(jc) / 20.0 * 100.0)
