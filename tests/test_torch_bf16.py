"""The port's bfloat16 compute (``--bf16``) on the CPU, against ``ddp_tpu``
with ``compute_dtype=jnp.bfloat16`` on identical numpy inputs.

Tolerances (``pytest -s`` prints each measured error):

- Input: ``gather_batch_plain(..., dtype=bfloat16)`` against JAX's
  ``_as_input(u8, jnp.bfloat16)`` for all 256 byte values, and the
  crop/flip and eval forms with the draws passed in: bit for bit (both
  round the float32 quotient u/255 to nearest even).
- One layer: ``bn_relu`` on a bfloat16 input with float32 γ/β, forward and
  VJP, against JAX's, per rank and at world 2 over gloo against
  ``bn_sync_axis`` in a ``shard_map``: ``z`` and ``dx`` within 1 bfloat16
  ulp of the reference value (both compute in float32 and round once;
  float32 sums taken in another order can cross one rounding boundary);
  dγ, dβ (float32) and the batch statistics within 1e-5 of the tensor's
  largest magnitude.
- Whole model (narrow VGG), train and eval mode: logits within
  2^-5 · max|logit| of JAX's eager ``apply`` (each layer rounds its output
  to bfloat16, 2^-8 relative, and roundings that differ in one layer
  compound through the next); the dtypes of activations, parameters,
  gradients, momentum, buffers, the ZeRO slice and the logits.
- One resident step, and the world-2 ``--grad_accum 2 --sync_bn
  --shard_update`` epoch, against JAX's jitted epochs on a CPU mesh: losses
  within 1e-2 relative; each tensor's change (weights, BN buffers; the
  epoch's momentum too) within 2^-3 of that change's largest magnitude.
  XLA keeps some bfloat16 intermediates in float32 on the CPU (its excess
  precision: a product feeding a float32 cast is not rounded), where the
  port rounds each op's output, so the two part by bfloat16 roundings, and
  in sums that cancel (the first BatchNorm's dγ, conv1's kernel gradient)
  those are as large as bfloat16's own effect: JAX's bfloat16 step lies
  4.5e-2 to 5.4e-2 of max from its float32 step at batches 16 to 64, its
  epoch here 6.6e-2.  2^-3 is twice that; a misplaced cast or a wrong
  scale moves a change by its whole size.  The eval counters may differ by
  one image of the 20: a logit margin below that noise flips one argmax.
- CLI and serving, within the port: the compute dtype recorded, the
  checkpoint float32 and read by JAX, a resumed epoch equal to the
  uninterrupted one and served logits equal to the eager bfloat16 forward,
  bit for bit.
"""
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import device_augment as jaug
from ddp_tpu.data import loader as jloader
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.ops import gather as jgather
from ddp_tpu.ops import layers as jlayers
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.parallel import make_mesh
from ddp_tpu.parallel.mesh import DATA_AXIS
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.epoch import (make_eval_epoch, make_train_epoch,
                                 put_index_matrix)
from ddp_tpu.train.step import _as_input as jax_as_input
from ddp_tpu.train.step import init_train_state
from ddp_tpu.train.zero import (init_opt_shard, make_train_epoch_zero_accum,
                                opt_shard_to_pytree)
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data.resident import ResidentData
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops import gather as tgather
from ddp_tpu_torch.ops import layers as tlayers
from ddp_tpu_torch.optim import SGDConfig
from ddp_tpu_torch.parallel import dist, drill
from ddp_tpu_torch.train import epoch as tepoch
from ddp_tpu_torch.train import zero as tzero
from ddp_tpu_torch.train.checkpoint import save_checkpoint
from ddp_tpu_torch.train.step import (_as_input, init_train_state as tinit,
                                      make_eval_apply, make_local_grads)
from torch_procs import in_background

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 16, "M", 512, "M"]
TIMEOUT = 120
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
BF16 = torch.bfloat16
SEED, LR, BATCH = 3, 0.05, 8
LOGIT_TOL, LOSS_TOL, UPDATE_TOL, STAT_TOL = 2.0 ** -5, 1e-2, 2.0 ** -3, 1e-5


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    return NARROW


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run ``pl.pallas_call`` in interpret mode (the CPU has no TPU)."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _bits(a) -> np.ndarray:
    """The raw 16 bits of a bfloat16 tensor or JAX array, as int16."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _ulps(got: torch.Tensor, want) -> float:
    """The largest ``|got - want|`` in units of the bfloat16 spacing at
    ``|want|`` (the reference value)."""
    w = torch.from_numpy(np.asarray(want, np.float64))
    g = got.detach().double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
                     - 7)
    return float(((g - w).abs() / ulp).max())


def _of_max(got: torch.Tensor, want) -> float:
    """``max|got - want|`` as a share of ``max|want|``."""
    w = torch.from_numpy(np.asarray(want, np.float64))
    return float((got.detach().double() - w).abs().max()
                 / w.abs().max().clamp_min(1e-30))


def _nhwc_of(a) -> np.ndarray:
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


# ------------------------------------------------------------------ input


def test_input_every_byte_value_bit_for_bit():
    u = np.arange(256, dtype=np.uint8)
    table = np.zeros((1, 32, 32, 3), dtype=np.uint8)
    table.reshape(-1)[:256] = u
    images, _ = tgather.gather_batch(
        torch.from_numpy(table), torch.zeros(1, dtype=torch.int64),
        torch.zeros(1, dtype=torch.int32), dtype=BF16)
    assert images.dtype == BF16
    got = images.reshape(-1)[:256]
    want = jax_as_input(jnp.asarray(u), jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The port's step input from a uint8 batch: the same bits.
    again = _as_input(torch.from_numpy(table), BF16).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_bits(again.reshape(-1)[:256]),
                                  _bits(want))


def _jax_draws(key, n):
    """The draws ``_crop_flip_onehot`` makes from ``key``
    (ddp_tpu/data/device_augment.py, its first three lines)."""
    k_off, k_flip = jax.random.split(key)
    ys, xs = jax.random.randint(k_off, (2, n), 0, 2 * jaug.PAD + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (n,))
    return (torch.from_numpy(np.asarray(ys).astype(np.int64)),
            torch.from_numpy(np.asarray(xs).astype(np.int64)),
            torch.from_numpy(np.array(flip)))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_input_crop_flip_and_eval_forms_bit_for_bit(pallas_interpret,
                                                    monkeypatch, mode):
    """``gather_batch(..., dtype=bfloat16)`` against JAX's
    ``_as_input(gather_crop_flip(key, ...), bf16)`` with the draws of
    ``key`` (or ``gather_rows`` through the Pallas gather for eval)."""
    monkeypatch.setattr(jgather, "_use_pallas", lambda: True)
    rng = np.random.default_rng(4)
    table = rng.integers(0, 256, (50, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 50).astype(np.int64)
    idx = rng.integers(0, 50, 9).astype(np.int32)
    key = jax.random.key(17)
    if mode == "train":
        rows = jaug.gather_crop_flip(key, jnp.asarray(table),
                                     jnp.asarray(idx))
        draws = _jax_draws(key, 9)
    else:
        rows = jgather.gather_rows(jnp.asarray(table), jnp.asarray(idx))
        draws = None
    want = jax_as_input(rows, jnp.bfloat16)
    images, got_labels = tgather.gather_batch(
        torch.from_numpy(table), torch.from_numpy(labels),
        torch.from_numpy(idx), draws, dtype=BF16)
    assert images.dtype == BF16 and tuple(images.shape) == want.shape
    assert images.permute(0, 3, 1, 2).is_contiguous()
    np.testing.assert_array_equal(_bits(images), _bits(want))
    np.testing.assert_array_equal(got_labels.numpy(), labels[idx])


def test_gather_batch_refuses_other_dtypes():
    table = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    for dtype in (torch.float16, torch.float64, torch.uint8):
        with pytest.raises(ValueError, match="dtype"):
            tgather.gather_batch(table, torch.zeros(2, dtype=torch.int64),
                                 torch.zeros(1, dtype=torch.int32),
                                 dtype=dtype)


# -------------------------------------------------------------- one layer


def _bn_inputs(n=8, c=6, h=5):
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, (n, h, h, c)).astype(jnp.bfloat16)  # NHWC
    ct = rng.normal(0.0, 1.0, (n, h, h, c)).astype(jnp.bfloat16)
    scale = rng.normal(1.0, 0.3, c).astype(np.float32)
    bias = rng.normal(0.0, 0.3, c).astype(np.float32)
    mean = rng.normal(0.0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, ct, scale, bias, mean, var


def _bf16_nchw(a) -> torch.Tensor:
    """A bfloat16 numpy array (NHWC) as a bfloat16 NCHW tensor, same bits."""
    bits = np.ascontiguousarray(np.asarray(a).view(np.int16)
                                .transpose(0, 3, 1, 2))
    return torch.from_numpy(bits).view(BF16)


def _check_bn(got: dict, want: dict, what: str) -> dict:
    errs = {"z_ulps": _ulps(got["z"].float(), _nhwc_of(want["z"])),
            "dx_ulps": _ulps(got["dx"].float(), _nhwc_of(want["dx"]))}
    for k in ("mean", "var", "dscale", "dbias"):
        errs[k] = _of_max(got[k], want[k])
    print(f"bn_relu bf16 {what}: {errs}")
    assert got["z"].dtype == got["dx"].dtype == BF16
    assert all(got[k].dtype == torch.float32
               for k in ("mean", "var", "dscale", "dbias"))
    assert errs["z_ulps"] <= 1 and errs["dx_ulps"] <= 1, errs
    assert all(errs[k] <= STAT_TOL for k in ("mean", "var", "dscale",
                                             "dbias")), errs
    return errs


def test_bn_relu_bf16_matches_jax():
    x, ct, scale, bias, mean, var = _bn_inputs()
    jstate = jlayers.BatchNormState(jnp.asarray(mean), jnp.asarray(var))
    (jz, jnew), vjp = jax.vjp(
        lambda x_, s_, b_: jlayers.bn_relu(x_, s_, b_, jstate, train=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp((jnp.asarray(ct),
                         jax.tree_util.tree_map(jnp.zeros_like, jnew)))
    assert jz.dtype == jdx.dtype == jnp.bfloat16

    tx = _bf16_nchw(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tz, tnew = tlayers.bn_relu(
        tx, ts, tb, tlayers.BatchNormState(torch.from_numpy(mean),
                                           torch.from_numpy(var)),
        train=True)
    dx, ds, db = torch.autograd.grad(tz, (tx, ts, tb), _bf16_nchw(ct))
    _check_bn({"z": tz, "dx": dx, "mean": tnew.mean, "var": tnew.var,
               "dscale": ds, "dbias": db},
              {"z": jz, "dx": jdx, "mean": jnew.mean, "var": jnew.var,
               "dscale": jds, "dbias": jdb}, "per rank")


_BN_WORKER = r'''
import sys
import torch
from ddp_tpu_torch.ops import layers
from ddp_tpu_torch.parallel import dist

torch.set_num_threads(1)
s = torch.load(sys.argv[1], weights_only=True)
dist.initialize(torch.device("cpu"))
try:
    r, w = dist.rank(), dist.world_size()
    half = lambda t: t[r * t.shape[0] // w:(r + 1) * t.shape[0] // w]
    x, scale, bias = (t.clone().requires_grad_() for t in
                      (half(s["x"]), s["scale"], s["bias"]))
    z, new = layers.bn_relu(x, scale, bias,
                            layers.BatchNormState(s["mean"], s["var"]),
                            train=True, sync=True)
    dx, dscale, dbias = torch.autograd.grad(z, (x, scale, bias),
                                            half(s["ct"]))
    torch.save({"z": z.detach(), "mean": new.mean.detach(),
                "var": new.var.detach(), "dx": dx, "dscale": dscale,
                "dbias": dbias}, f"{sys.argv[2]}/rank{r}.pt")
finally:
    dist.shutdown()
'''


def test_sync_bn_relu_bf16_world2_matches_jax(tmp_path):
    """Two gloo ranks, each half of the batch, against JAX's ``bn_relu``
    under ``bn_sync_axis`` in a ``shard_map`` over ``make_mesh(2)``
    (``check_vma=False``: per-shard dγ/dβ come back local, as the port's)."""
    x, ct, scale, bias, mean, var = _bn_inputs()
    state = jlayers.BatchNormState(jnp.asarray(mean), jnp.asarray(var))

    def body(x, scale, bias, ct):
        with jlayers.bn_sync_axis(DATA_AXIS):
            (z, new), vjp = jax.vjp(
                lambda x, s, b: jlayers.bn_relu(x, s, b, state, train=True),
                x, scale, bias)
            dx, ds, db = vjp((ct, jax.tree_util.tree_map(jnp.zeros_like,
                                                         new)))
        return z, new.mean[None], new.var[None], dx, ds[None], db[None]

    d = P(DATA_AXIS)
    jz, jmean, jvar, jdx, jds, jdb = jax.jit(jax.shard_map(
        body, mesh=make_mesh(2), in_specs=(d, P(), P(), d),
        out_specs=(d,) * 6, check_vma=False))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(ct))
    spec = {"x": _bf16_nchw(x), "ct": _bf16_nchw(ct),
            "scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
            "mean": torch.from_numpy(mean), "var": torch.from_numpy(var)}
    torch.save(spec, tmp_path / "spec.pt")
    code = dist.launch_local(
        [sys.executable, "-c", _BN_WORKER, str(tmp_path / "spec.pt"),
         str(tmp_path)], 2, env=ENV, timeout=TIMEOUT)
    assert code == 0
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        sl = slice(4 * r, 4 * (r + 1))
        _check_bn(got, {"z": jz[sl], "dx": jdx[sl], "mean": jmean[r],
                        "var": jvar[r], "dscale": jds[r], "dbias": jdb[r]},
                  f"sync, rank {r}")


# ------------------------------------------------------------ whole model


def _narrow_start(seed=SEED):
    """JAX's narrow VGG at ``seed`` with BatchNorm buffers drawn from it,
    and the port's model loaded with the same values."""
    params, stats = jvgg.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    stats = {k: {"mean": rng.normal(0, 0.2, v["mean"].shape)
                 .astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, v["var"].shape)
                 .astype(np.float32)} for k, v in stats.items()}
    params = jax.tree_util.tree_map(np.asarray, params)
    model = VGG(NARROW)
    model.load_state_dict(interop.state_dict_from_jax("vgg", params, stats))
    return params, stats, model


@pytest.mark.parametrize("train", [True, False])
def test_vgg_bf16_forward_matches_jax(narrow, train):
    params, stats, model = _narrow_start()
    u8 = np.random.default_rng(1).integers(0, 256, (16, 32, 32, 3),
                                           dtype=np.uint8)
    want, _ = jvgg.apply(params, stats,
                         jax_as_input(jnp.asarray(u8), jnp.bfloat16),
                         train=train, compute_dtype=jnp.bfloat16)
    assert want.dtype == jnp.float32
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((type(mod).__name__, out.dtype)))
        for name, m in model.named_modules()
        if name.count(".") == 1 or name == "classifier"]
    model.train(train)
    with torch.no_grad():
        logits = model(_as_input(torch.from_numpy(u8), BF16),
                       compute_dtype=BF16)
    for h in hooks:
        h.remove()
    err = _of_max(logits, want)
    print(f"VGG bf16 {'train' if train else 'eval'}: logits {err:.3e} of "
          f"max|logit| {float(np.abs(np.asarray(want)).max()):.3f}")
    assert logits.dtype == torch.float32
    assert len(seen) == 2 * 3 + 1 and all(d == BF16 for _, d in seen), seen
    assert err <= LOGIT_TOL


def test_bf16_state_stays_float32(narrow):
    """Under bf16: activations bfloat16, while parameters, their gradients,
    momentum (replicated and the ZeRO slice), BN buffers and the logits are
    float32, before and after a step."""
    _, _, model = _narrow_start()
    train, _ = tcifar.synthetic(n_train=8, n_test=8, seed=1)
    res = ResidentData(train, torch.device("cpu"))
    loss, grads = make_local_grads(model, compute_dtype=BF16)(res.images,
                                                              res.labels)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    for shard_update in (False, True):
        state = tinit(model)
        if shard_update:
            state.momentum = tzero.list_to_opt_shard(state.momentum)
        tepoch.make_train_epoch(model, SGDConfig(lr=LR), lambda s: LR,
                                shard_update=shard_update,
                                compute_dtype=BF16)(
            state, res.images, res.labels,
            torch.arange(8, dtype=torch.int32)[None])
        assert all(m.dtype == torch.float32 for m in state.momentum)
        assert all(v.dtype == torch.float32
                   for v in model.state_dict().values())
    with pytest.raises(TypeError, match="float32 gradients"):
        tzero.make_zero_update(SGDConfig(), lambda s: LR)(
            state, [g.to(BF16) for g in grads])


# ------------------------------------------------------ steps and epochs


def _updates(before: dict, after: dict, want_before, want_after) -> float:
    """The worst tensor's change ``after - before`` against the
    reference's, as a share of the reference change's largest magnitude."""
    worst = 0.0
    for k, a in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        got = a.double() - before[k].double()
        ref = np.asarray(want_after[k], np.float64) - \
            np.asarray(want_before[k], np.float64)
        worst = max(worst, _of_max(got, ref))
    return worst


def test_one_resident_step_matches_jax(narrow):
    """One bf16 step at a constant lr on one device: the port's
    ``make_train_epoch`` against JAX's on ``make_mesh(1)``."""
    params, stats, model = _narrow_start()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    train, _ = tcifar.synthetic(n_train=16, n_test=8, seed=2)
    jtrain, _ = jcifar.synthetic(n_train=16, n_test=8, seed=2)
    rows = np.arange(16, dtype=np.int32)[None]
    res = ResidentData(train, torch.device("cpu"))
    state = tinit(model)
    losses = tepoch.make_train_epoch(model, SGDConfig(lr=LR), lambda s: LR,
                                     compute_dtype=BF16)(
        state, res.images, res.labels, torch.from_numpy(rows))
    mesh = make_mesh(1)
    jstate, jlosses = make_train_epoch(
        jget_model("vgg"), JSGDConfig(lr=LR), lambda s: LR, mesh,
        compute_dtype=jnp.bfloat16)(
        init_train_state(params, stats), jnp.asarray(jtrain.images),
        jnp.asarray(jtrain.labels), put_index_matrix(rows, mesh),
        jax.random.key(0))
    want = interop.state_dict_from_jax("vgg",
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    loss_err = abs(float(losses[0]) - float(jlosses[0])) / abs(float(jlosses[0]))
    upd = _updates(sd0, model.state_dict(), sd0, want)
    print(f"one bf16 step: loss {float(losses[0]):.6f} vs JAX "
          f"{float(jlosses[0]):.6f} ({loss_err:.3e} relative), worst "
          f"update {upd:.3e} of its max")
    assert loss_err <= LOSS_TOL and upd <= UPDATE_TOL


def test_composed_flags_world2_bf16_matches_jax(narrow):
    """``--bf16 --grad_accum 2 --sync_bn --shard_update`` at world 2 (the
    drill over gloo, 48 images a rank in 6 micro-batches of 8: 3 optimizer
    steps) against JAX's ``make_train_epoch_zero_accum(sync_bn=True,
    compute_dtype=bfloat16)`` on ``make_mesh(2)`` and its eval."""
    params, stats, model = _narrow_start()
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    jtrain, jtest = jcifar.synthetic(n_train=96, n_test=20)
    ttrain, ttest = tcifar.synthetic(n_train=96, n_test=20)
    ranks = in_background(
        drill.run, drill.spec(NARROW, sd0, ttrain, ttest, batch=BATCH, lr=LR,
                              seed=SEED, augment=False, device="cpu",
                              grad_accum=2, sync_bn=True, shard_update=True,
                              compute_dtype="bfloat16"),
        2, env=ENV, timeout=TIMEOUT)

    mesh = make_mesh(2)
    jl = jloader.TrainLoader(jtrain, BATCH, 2, seed=SEED, augment=False)
    jl.set_epoch(0)
    full, tail = jl.epoch_index_matrix()
    assert tail is None
    sched = lambda s: jlr(s, base_lr=LR, num_epochs=1,
                          steps_per_epoch=jl.optimizer_steps_per_epoch(2))
    jmodel = jget_model("vgg")
    epoch_fn = make_train_epoch_zero_accum(
        jmodel, JSGDConfig(lr=LR), sched, mesh, compute_dtype=jnp.bfloat16,
        sync_bn=True)
    jstate = init_train_state(params, stats)
    jstate = jstate._replace(opt_state=init_opt_shard(params, mesh))
    jstate, jlosses = epoch_fn(
        jstate, jnp.asarray(jtrain.images), jnp.asarray(jtrain.labels),
        put_index_matrix(full.reshape(-1, 2, full.shape[1]), mesh),
        jax.random.key(SEED))
    jmom = opt_shard_to_pytree(jstate.params, jstate.opt_state, mesh)
    idx, mask = jloader.EvalLoader(jtest, BATCH, 2).epoch_index_matrix()
    jcorrect, jtotal = (float(c) for c in make_eval_epoch(
        jmodel, mesh, jnp.bfloat16)(
        jstate.params, jstate.batch_stats, jnp.asarray(jtest.images),
        jnp.asarray(jtest.labels), put_index_matrix(idx, mesh),
        put_index_matrix(mask, mesh)))

    ranks = ranks.result()
    got = ranks[0]
    assert got["steps"] == 3 and len(got["losses"]) == 3
    for k, v in got["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k
        assert v.dtype == sd0[k].dtype, k
    assert all(m.dtype == torch.float32 for m in got["momentum"])
    jl_np = np.asarray(jlosses)
    loss_err = float(np.max(np.abs(got["losses"].numpy() - jl_np)
                            / np.abs(jl_np)))
    want = interop.state_dict_from_jax("vgg",
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    upd = _updates(sd0, got["state_dict"], sd0, want)
    jm = interop.momentum_list_from_tree(
        VGG(NARROW), jax.tree_util.tree_map(np.asarray, jmom.momentum_buf))
    mom = max(_of_max(a, b.numpy()) for a, b in zip(got["momentum"], jm))
    print(f"world-2 composed bf16 epoch: losses {loss_err:.3e} relative, "
          f"worst update {upd:.3e}, worst momentum {mom:.3e} of max; eval "
          f"{got['correct']}/{got['total']} vs JAX {jcorrect}/{jtotal}")
    assert loss_err <= LOSS_TOL and upd <= UPDATE_TOL and mom <= UPDATE_TOL
    assert got["total"] == jtotal == 20.0
    assert abs(got["correct"] - jcorrect) <= 1
    assert (got["correct"], got["total"]) == \
        (ranks[1]["correct"], ranks[1]["total"])


# ------------------------------------------------------------------- CLI


def test_singlegpu_bf16_checkpoint_is_float32_and_resumes(tmp_path):
    """``singlegpu 2 2 --bf16`` (full width): the summary's compute dtype,
    a float32 checkpoint that JAX's ``load_checkpoint`` reads, and a
    ``--resume --bf16`` run from it that trains epoch 1 only, bit for bit
    the uninterrupted run's."""
    ck, out = str(tmp_path / "ck.pt"), str(tmp_path / "r.json")
    args = ["2", "2", "--batch_size", "4", "--resident", "--synthetic",
            "--synthetic_size", "16", "--device", "cpu", "--lr", "0.05",
            "--bf16", "--snapshot_path", ck]
    full = cli.main(args + ["--result_json", out])
    assert json.load(open(out))["compute_dtype"] == "bfloat16"
    assert len(full["loss_history"]) == 8
    assert all(np.isfinite(full["loss_history"]))
    ckpt = jckpt.load_checkpoint(ck)
    assert (ckpt.step, ckpt.epoch) == (4, 0)
    leaves = jax.tree_util.tree_leaves((ckpt.params, ckpt.batch_stats,
                                        ckpt.opt_state.momentum_buf))
    assert leaves and all(np.asarray(a).dtype == np.float32 for a in leaves)
    resumed = cli.main(args + ["--resume"])
    assert resumed["loss_history"] == full["loss_history"][4:]
    assert resumed["accuracy"] == full["accuracy"]


def _multigpu(args, path):
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.multigpu", *args,
         "--result_json", str(path)],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(path.read_text())


def test_multigpu_spawn2_bf16_flags_and_resume(tmp_path):
    """``multigpu 2 2 --spawn 2 --bf16`` with the strategy flags composed:
    the summary, a float32 checkpoint JAX reads, and a resumed run equal to
    the uninterrupted run's second epoch."""
    ck = str(tmp_path / "ck.pt")
    common = ["2", "2", "--batch_size", "4", "--resident", "--synthetic",
              "--synthetic_size", "16", "--device", "cpu", "--lr", "0.05",
              "--spawn", "2", "--bf16", "--grad_accum", "2", "--sync_bn",
              "--shard_update", "--snapshot_path", ck]
    full = _multigpu(common, tmp_path / "full.json")
    assert (full["world"], full["backend"], full["compute_dtype"]) == \
        (2, "gloo", "bfloat16")
    assert len(full["loss_history"]) == 2 and \
        all(np.isfinite(full["loss_history"]))
    ckpt = jckpt.load_checkpoint(ck)
    leaves = jax.tree_util.tree_leaves((ckpt.params, ckpt.batch_stats,
                                        ckpt.opt_state.momentum_buf))
    assert all(np.asarray(a).dtype == np.float32 for a in leaves)
    assert (ckpt.step, ckpt.epoch) == (1, 0)
    resumed = _multigpu(common + ["--resume"], tmp_path / "resumed.json")
    assert resumed["loss_history"] == full["loss_history"][1:]
    assert resumed["accuracy"] == full["accuracy"]


# --------------------------------------------------------------- serving


def test_serve_cli_bf16_stats_and_logits_bit_for_bit(tmp_path):
    """``python -m ddp_tpu_torch.serve --bf16 --device cpu`` on a
    full-width checkpoint: ``/stats`` reports bfloat16, and a /predict of 3
    rows (bucket 8) equals the eager bfloat16 forward of the same padded
    batch bit for bit."""
    model = VGG(generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck.pt")
    save_checkpoint(ck, model, tinit(model).momentum, 0, 0)
    env = {k: v for k, v in ENV.items() if not k.startswith("JAX")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--bf16", "--port", "0", "--buckets", "1,8", "--snapshot_path", ck,
         "--trace_spill", ""], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                             dtype=np.uint8)
    try:
        line = proc.stdout.readline()
        assert "serving vgg on http://" in line, line
        base = line.split("on ")[1].split(" ")[0].rstrip("/")
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"instances": imgs.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert stats["engine"]["compute_dtype"] == "bfloat16"
    padded = np.zeros((8, 32, 32, 3), dtype=np.uint8)
    padded[:3] = imgs
    images, _ = tgather.gather_batch(
        torch.from_numpy(padded), torch.zeros(8, dtype=torch.int64),
        torch.arange(8, dtype=torch.int32), dtype=BF16)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the server's OMP_NUM_THREADS=1
    try:
        want = make_eval_apply(model, BF16)(images)[:3].numpy()
    finally:
        torch.set_num_threads(threads)
    got = np.asarray(out["logits"], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
