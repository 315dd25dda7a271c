"""The port's data-parallel strategy flags on the CPU (``--grad_accum``,
``--sync_bn``, ``--shard_update``): gloo process groups of spawned ranks
against ``ddp_tpu`` on a JAX mesh of as many CPU devices.

Tolerances: world-2 epochs (narrow VGG, augmentation off) against JAX's
``make_train_epoch_accum`` / ``make_train_epoch_zero`` /
``make_train_epoch_zero_accum`` on ``make_mesh(2)`` at 1e-4, the resident
epoch's tolerance in ``tests/test_torch_ddp.py`` (float32 sums taken in
other orders, grown through a few SGD steps); eval counters exactly.  The
synchronised BatchNorm ops at world 2 against JAX's under ``bn_sync_axis``
in a ``shard_map`` at 1e-5 (one layer: the statistics' and dβ/dγ's sums in
another order).  World-2 sync-BN against world-1 sync-BN on the
concatenated batch at 1e-5 (the same sums split in two).  Where the
arithmetic is the same op for op (A = 1 against the unflagged step, the
sharded update against the replicated one, an interrupted and resumed run
against an uninterrupted one, per-rank BN with a group against without),
bit for bit.

Every multi-process case gives its ranks one CPU thread and a hard
timeout, so a hung rendezvous fails the test instead of stalling the
suite.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ddp_tpu.cli as jcli
import ddp_tpu.models.vgg as jvgg
from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import loader as jloader
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.ops import layers as jlayers
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.parallel import make_mesh
from ddp_tpu.parallel.mesh import DATA_AXIS
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.epoch import (make_train_epoch, make_train_epoch_accum,
                                 put_index_matrix)
from ddp_tpu.train.step import init_train_state
from ddp_tpu.train.trainer import Trainer as JTrainer, _stack_groups
from ddp_tpu.train.zero import (init_opt_shard, make_train_epoch_zero,
                                make_train_epoch_zero_accum,
                                opt_shard_to_pytree, pytree_to_opt_shard)
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data import loader as tloader
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops import layers as tlayers
from ddp_tpu_torch.ops.gather import gather_batch
from ddp_tpu_torch.ops.losses import cross_entropy_sum_count
from ddp_tpu_torch.optim import SGDConfig, sgd, triangular_lr as tlr
from ddp_tpu_torch.parallel import dist, drill
from ddp_tpu_torch.data.resident import ResidentData
from ddp_tpu_torch.train import epoch as tepoch, zero as tzero
from ddp_tpu_torch.train.step import (_as_input, init_train_state as tinit,
                                      make_local_grads)
from ddp_tpu_torch.train.trainer import draw_seed
from torch_float64 import float64_epoch as _float64_epoch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 16, "M", 512, "M"]
N_BN = 3  # BatchNorm layers of NARROW
TIMEOUT = 120
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
CLI_ARGS = ["--resident", "--synthetic", "--device", "cpu", "--lr", "0.05"]
SEED, LR, BATCH = 3, 0.05, 4


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    return NARROW


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, tol, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol,
                               err_msg=what)


# --------------------------------------------------------------- grouping


@pytest.mark.parametrize("n,batch,world", [(37, 4, 1), (55, 4, 2),
                                           (64, 8, 2), (50, 4, 3)])
@pytest.mark.parametrize("accum", [1, 2, 3, 5])
def test_optimizer_steps_and_groups_match_jax(n, batch, world, accum):
    """Step counts against ``TrainLoader.optimizer_steps_per_epoch`` and
    each rank's groups against JAX's grouping of the global batches
    (``_stack_groups``: full groups of A, the remainder, the ragged tail
    alone), over sets with and without a remainder group and a tail."""
    jds, _ = jcifar.synthetic(n_train=n, n_test=8)
    tds, _ = tcifar.synthetic(n_train=n, n_test=8)
    jl = jloader.TrainLoader(jds, batch, world, seed=5, augment=False)
    tl = tloader.TrainLoader(tds, batch, world, seed=5)
    assert tl.optimizer_steps_per_epoch(accum) == \
        jl.optimizer_steps_per_epoch(accum)
    jl.set_epoch(1)
    tl.set_epoch(1)
    full, tail = jl.epoch_index_matrix()
    rows = [{"label": r} for r in full] + \
        ([{"label": tail}] if tail is not None else [])
    want = [g["label"] for g in _stack_groups(rows, accum)]
    for r in range(world):
        got = [step for g in tloader.optimizer_groups(
            *tl.rank_index_matrix(r), accum) for step in g]
        assert len(got) == len(want) == tl.optimizer_steps_per_epoch(accum)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(
                a, tloader.replica_columns(b, r, world))


def test_lr_schedule_counts_optimizer_steps_like_jax():
    argv = ["3", "1", "--batch_size", "4", "--synthetic", "--synthetic_size",
            "55", "--grad_accum", "3", "--lr", "0.3"]
    jargs = jcli.build_parser("jax").parse_args(argv)
    targs = cli.build_parser("port").parse_args(argv + ["--resident"])
    jds, _ = jcifar.synthetic(n_train=55, n_test=8)
    tds, _ = tcifar.synthetic(n_train=55, n_test=8)
    jl = jloader.TrainLoader(jds, 4, 2, seed=0, augment=False)
    tl = tloader.TrainLoader(tds, 4, 2, seed=0)
    jsched = jcli.build_schedule(jargs, jl.optimizer_steps_per_epoch(3))
    tsched = cli.build_schedule(targs, tl)
    # 28 samples a rank: 7 batches of 4, grouped 3 + 3 + 1.
    assert tl.optimizer_steps_per_epoch(3) == 3
    assert tsched.keywords == jsched.keywords == {
        "base_lr": 0.3, "num_epochs": 3, "steps_per_epoch": 3}
    # The port's rate is a Python float, JAX's a float32 array.
    np.testing.assert_allclose([tsched(s) for s in range(10)],
                               [float(jsched(s)) for s in range(10)],
                               rtol=1e-6)


@pytest.mark.parametrize("main", [cli.main, cli.main_multi])
def test_grad_accum_below_one_is_refused(main, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="--grad_accum must be at least 1"):
        main(["1", "1", "--resident", "--synthetic", "--device", "cpu",
              "--grad_accum", "0"])


def test_micro_zero_keeps_the_draw_key():
    for seed, epoch, step in ((0, 0, 0), (3, 7, 97)):
        for rank in (0, 1, 3):
            assert draw_seed(seed, epoch, step, rank, 0) == \
                draw_seed(seed, epoch, step, rank)
        keys = {draw_seed(seed, epoch, step, r, k)
                for r in range(3) for k in range(3)}
        assert len(keys) == 9


# ------------------------------------------------- one rank, in process


def _cpu_setup(n_train=24):
    train, _ = tcifar.synthetic(n_train=n_train, n_test=8, seed=1)
    model = VGG(NARROW, generator=torch.Generator().manual_seed(0))
    return train, model, ResidentData(train, torch.device("cpu"))


def test_accum_1_is_the_unflagged_step_bit_for_bit():
    """A = 1 through the grouped epoch, replicated or sharded, against the
    step written out as before the strategy flags: forward, gradients,
    their all-reduce, the buffers' average, SGD."""
    train, model0, res = _cpu_setup()
    rows = torch.arange(24, dtype=torch.int32).view(6, 4)
    sched = lambda s: tlr(s, base_lr=LR, num_epochs=1, steps_per_epoch=6)
    cfg = SGDConfig(lr=LR)

    model = VGG(NARROW)
    model.load_state_dict(model0.state_dict())
    params = list(model.parameters())
    momentum = sgd.init(params)
    want = []
    for step, row in enumerate(rows):
        x, y = gather_batch(res.images, res.labels, row)
        model.train()
        ce_sum, count = cross_entropy_sum_count(model(_as_input(x)), y)
        loss = ce_sum / (count * 1)
        grads = dist.all_reduce_grads(torch.autograd.grad(loss, params))
        dist.average_buffers(model)
        sgd.apply_updates(params, grads, momentum, sched(step), cfg)
        want.append(loss.detach())

    for shard_update in (False, True):
        got_model = VGG(NARROW)
        got_model.load_state_dict(model0.state_dict())
        state = tinit(got_model)
        if shard_update:
            state.momentum = tzero.list_to_opt_shard(state.momentum)
        run = tepoch.make_train_epoch(got_model, cfg, sched,
                                      shard_update=shard_update)
        losses = run(state, res.images, res.labels, rows[:, None])
        assert torch.equal(losses, torch.stack(want))
        for k, v in model.state_dict().items():
            assert torch.equal(got_model.state_dict()[k], v), k
        got_m = (tzero.opt_shard_to_list(list(got_model.parameters()),
                                         state.momentum)
                 if shard_update else state.momentum)
        assert all(torch.equal(a, b) for a, b in zip(got_m, momentum))


def test_accum_matches_hand_composition():
    """A = 2: the grouped epoch equals two local gradient calls with the
    BN buffers chained, their gradients averaged, one SGD update (the
    counterpart of ``tests/test_grad_accum.py``'s test of that name)."""
    train, model0, res = _cpu_setup(16)
    group = torch.arange(16, dtype=torch.int32).view(1, 2, 8)
    sched = lambda s: 0.1
    cfg = SGDConfig(lr=0.1)

    model = VGG(NARROW)
    model.load_state_dict(model0.state_dict())
    lg = make_local_grads(model)
    l0, g0 = lg(res.images[:8], res.labels[:8])
    l1, g1 = lg(res.images[8:], res.labels[8:])
    params = list(model.parameters())
    momentum = sgd.init(params)
    sgd.apply_updates(params, [(a + b) / 2 for a, b in zip(g0, g1)],
                      momentum, 0.1, cfg)

    got = VGG(NARROW)
    got.load_state_dict(model0.state_dict())
    state = tinit(got)
    loss = tepoch.make_train_epoch(got, cfg, sched)(
        state, res.images, res.labels, group)
    assert state.step == 1
    _close(loss, [(l0 + l1) / 2], 1e-6)
    for k, v in model.state_dict().items():
        _close(got.state_dict()[k], v, 1e-6, k)


# ------------------------------------------- sync-BN ops at world 2


_BN_WORKER = r'''
import sys
import torch
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.ops import layers
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.train.step import make_local_grads

torch.set_num_threads(1)
s = torch.load(sys.argv[1], weights_only=True)
dist.initialize(torch.device("cpu"))
try:
    r, w = dist.rank(), dist.world_size()
    half = lambda t: t[r * t.shape[0] // w:(r + 1) * t.shape[0] // w]
    out = {}
    for name in ("bn_relu", "batch_norm"):
        for sync in (False, True):
            x, scale, bias = (t.clone().requires_grad_() for t in
                              (half(s["x"]), s["scale"], s["bias"]))
            before = dist.collective_calls["all_reduce"]
            y, new = getattr(layers, name)(
                x, scale, bias, layers.BatchNormState(s["mean"], s["var"]),
                train=True, sync=sync)
            dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias),
                                                    half(s["ct"]))
            out[f"{name}/{sync}"] = {
                "y": y.detach(), "mean": new.mean.detach(),
                "var": new.var.detach(), "dx": dx, "dscale": dscale,
                "dbias": dbias,
                "all_reduces": dist.collective_calls["all_reduce"] - before}
    model = VGG(s["arch"])
    model.load_state_dict(s["state_dict"])
    loss, grads = make_local_grads(model, sync_bn=True)(
        half(s["images"]), half(s["labels"]))
    out["model"] = {"loss": loss, "grads": grads,
                    "state": dict(model.state_dict())}
    torch.save(out, f"{sys.argv[2]}/rank{r}.pt")
finally:
    dist.shutdown()
'''


def _bn_inputs():
    rng = np.random.default_rng(0)
    n, c, h = 8, 6, 5
    x = rng.normal(1.5, 2.0, (n, h, h, c)).astype(np.float32)  # NHWC
    ct = rng.normal(0.0, 1.0, (n, h, h, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.3, c).astype(np.float32)
    bias = rng.normal(0.0, 0.3, c).astype(np.float32)
    mean = rng.normal(0.0, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, ct, scale, bias, mean, var


def _jax_sync_bn(fn, x, ct, scale, bias, mean, var):
    """JAX's op under ``bn_sync_axis`` in a ``shard_map`` over
    ``make_mesh(2)``: the output, the new running statistics and the VJP,
    per shard (``check_vma=False``: the per-shard dγ/dβ come back local, as
    the ZeRO core takes them)."""
    state = jlayers.BatchNormState(jnp.asarray(mean), jnp.asarray(var))

    def body(x, scale, bias, ct):
        with jlayers.bn_sync_axis(DATA_AXIS):
            (y, new), vjp = jax.vjp(
                lambda x, s, b: fn(x, s, b, state, train=True),
                x, scale, bias)
            dx, ds, db = vjp((ct, jax.tree_util.tree_map(jnp.zeros_like,
                                                         new)))
        return (y, new.mean[None], new.var[None], dx, ds[None], db[None])

    d = P(DATA_AXIS)
    out = jax.jit(jax.shard_map(
        body, mesh=make_mesh(2), in_specs=(d, P(), P(), d),
        out_specs=(d,) * 6, check_vma=False))(x, scale, bias, ct)
    return [np.asarray(o) for o in out]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_sync_bn_ops_and_model_at_world_2(tmp_path):
    """``bn_relu`` and ``batch_norm`` with ``sync`` on two gloo ranks
    against JAX's under ``bn_sync_axis``; without ``sync`` bit for bit the
    rank's own op with no group and no collective; the model's summed
    local gradients, loss shares and buffers against world-1 sync-BN on the
    concatenated batch (the counterpart of
    ``test_sync_bn_sharded_equals_unsharded``), which also pins that the
    γ/β gradients are counted once and not ``world`` times."""
    x, ct, scale, bias, mean, var = _bn_inputs()
    train, model, res = _cpu_setup(16)
    spec = {"x": _nchw(x), "ct": _nchw(ct), "scale": torch.from_numpy(scale),
            "bias": torch.from_numpy(bias), "mean": torch.from_numpy(mean),
            "var": torch.from_numpy(var), "arch": NARROW,
            "state_dict": model.state_dict(), "images": res.images,
            "labels": res.labels}
    torch.save(spec, tmp_path / "spec.pt")
    code = dist.launch_local(
        [sys.executable, "-c", _BN_WORKER, str(tmp_path / "spec.pt"),
         str(tmp_path)], 2, env=ENV, timeout=TIMEOUT)
    assert code == 0
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]

    for name, jfn, n_reduce in (("bn_relu", jlayers.bn_relu, 3),
                                ("batch_norm", jlayers.batch_norm, 4)):
        jy, jmean, jvar, jdx, jds, jdb = _jax_sync_bn(jfn, x, ct, scale,
                                                      bias, mean, var)
        for r, got in enumerate(ranks):
            g = got[f"{name}/True"]
            # bn_relu: two statistics passes and the packed [dβ, dγ];
            # batch_norm: the two passes and their transposes.
            assert g["all_reduces"] == n_reduce
            sl = slice(4 * r, 4 * (r + 1))
            _close(g["y"], _nchw(jy[sl]), 1e-5, name)
            _close(g["dx"], _nchw(jdx[sl]), 1e-5, name)
            _close(g["mean"], jmean[r], 1e-5, name)
            _close(g["var"], jvar[r], 1e-5, name)
            _close(g["dscale"], jds[r], 1e-5, name)
            _close(g["dbias"], jdb[r], 1e-5, name)
            # Per-rank BN with a group: the op without one, bit for bit.
            u = got[f"{name}/False"]
            assert u["all_reduces"] == 0
            xx, sc, bi = (t.clone().requires_grad_() for t in
                          (spec["x"][sl], spec["scale"], spec["bias"]))
            y, new = getattr(tlayers, name)(
                xx, sc, bi, tlayers.BatchNormState(spec["mean"],
                                                   spec["var"]), train=True)
            want = dict(zip(("dx", "dscale", "dbias"), torch.autograd.grad(
                y, (xx, sc, bi), spec["ct"][sl])), y=y, mean=new.mean,
                var=new.var)
            for k, v in want.items():
                assert torch.equal(u[k], v.detach()), (name, k)

    # The model: world 2 with sync-BN against world 1 on all 16 images.
    ref = VGG(NARROW)
    ref.load_state_dict(model.state_dict())
    loss, grads = make_local_grads(ref, sync_bn=True)(res.images,
                                                      res.labels)
    _close(sum(g["model"]["loss"] for g in ranks), loss, 1e-5)
    names = [k for k, _ in ref.named_parameters()]
    for i, k in enumerate(names):
        summed = ranks[0]["model"]["grads"][i] + ranks[1]["model"]["grads"][i]
        _close(summed, grads[i], 1e-5, k)
    for k, v in ref.state_dict().items():
        assert torch.equal(ranks[0]["model"]["state"][k],
                           ranks[1]["model"]["state"][k]), k
        _close(ranks[0]["model"]["state"][k], v, 1e-5, k)


# ------------------------------------------ world-2 epochs against JAX


def _jax_epoch(params, stats, train, test, *, accum, sync_bn, zero):
    """JAX's resident epoch with the flags on ``make_mesh(2)``, grouped as
    its trainer groups them: (losses, params, stats, per-leaf momentum)."""
    mesh = make_mesh(2)
    jl = jloader.TrainLoader(train, BATCH, 2, seed=SEED, augment=False)
    jl.set_epoch(0)
    full, tail = jl.epoch_index_matrix()
    assert tail is None
    sched = lambda s: jlr(s, base_lr=LR, num_epochs=1,
                          steps_per_epoch=jl.optimizer_steps_per_epoch(accum))
    make_epoch = {(False, False): make_train_epoch,
                  (True, False): make_train_epoch_accum,
                  (False, True): make_train_epoch_zero,
                  (True, True): make_train_epoch_zero_accum}[accum > 1, zero]
    epoch_fn = make_epoch(jget_model("vgg"), JSGDConfig(lr=LR), sched, mesh,
                          sync_bn=sync_bn)
    state = init_train_state(params, stats)
    if zero:
        state = state._replace(opt_state=init_opt_shard(params, mesh))
    idx = full.reshape(-1, accum, full.shape[1]) if accum > 1 else full
    state, losses = epoch_fn(state, jnp.asarray(train.images),
                             jnp.asarray(train.labels),
                             put_index_matrix(idx, mesh),
                             jax.random.key(SEED))
    opt = (opt_shard_to_pytree(state.params, state.opt_state, mesh)
           if zero else state.opt_state)
    return (np.asarray(losses), _np(state.params), _np(state.batch_stats),
            _np(opt.momentum_buf))


def _world2(flags, n_train=48):
    """(JAX's epoch, the port's ranks, the start's state dict, the port's
    train set) from the same start, 24 images a rank in 6 batches of 4."""
    jtrain, jtest = jcifar.synthetic(n_train=n_train, n_test=20)
    ttrain, ttest = tcifar.synthetic(n_train=n_train, n_test=20)
    params, stats = jvgg.init(jax.random.key(SEED))
    sd = interop.state_dict_from_jax("vgg", _np(params), _np(stats))
    ranks = drill.run(drill.spec(NARROW, sd, ttrain, ttest, batch=BATCH,
                                 lr=LR, seed=SEED, augment=False,
                                 device="cpu", **flags),
                      2, env=ENV, timeout=TIMEOUT)
    want = _jax_epoch(params, stats, jtrain, jtest,
                      accum=flags.get("grad_accum", 1),
                      sync_bn=flags.get("sync_bn", False),
                      zero=flags.get("shard_update", False))
    return want, ranks, sd, ttrain


def _expected_collectives(steps, micro, *, sync_bn, zero):
    """The drill's collectives on each rank, counted from the code: per
    micro-batch 3 all-reduces per BN layer under sync-BN; per step the
    buffers' average and either the gradients' all-reduce or one
    reduce-scatter and one all-gather; the epoch's loss sum, the eval
    counters, the start's broadcast, and under ZeRO the momentum's gather
    at the end."""
    want = {"all_reduce": 3 * N_BN * micro * sync_bn + steps * (2 - zero)
            + 2, "broadcast": 1}
    if zero:
        want.update(reduce_scatter=steps, all_gather=steps + 1)
    return want


def _check_against_jax(want, ranks, steps, micro, flags, sd, train):
    """The ranks in lockstep with the expected collectives; rank 0 against
    JAX's losses and weights at 1e-4, and against the float64 epoch at 1e-4
    in losses, weights, buffers and momentum.  JAX's momentum is held only
    where it agrees with the float64 epoch: its float32 reductions on the
    mesh drift further (``pytest -s`` prints the distances)."""
    jlosses, jparams, jstats, jmom = want
    for got in ranks:
        assert (got["world"], got["backend"], got["steps"]) == \
            (2, "gloo", steps)
        assert got["collectives"] == _expected_collectives(
            steps, micro, sync_bn=flags.get("sync_bn", False),
            zero=flags.get("shard_update", False))
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k
    got = ranks[0]
    _close(got["losses"], jlosses, 1e-4)
    port_p, port_s = interop.jax_from_state_dict("vgg", got["state_dict"])
    for a, b in zip(jax.tree_util.tree_leaves((port_p, port_s)),
                    jax.tree_util.tree_leaves((jparams, jstats))):
        _close(a, b, 1e-4)

    accum = flags.get("grad_accum", 1)
    tl = tloader.TrainLoader(train, BATCH, 2, seed=SEED)
    tl.set_epoch(0)
    full, _ = tl.epoch_index_matrix()
    flosses, fstate, fmom = _float64_epoch(
        sd, train, full.reshape(-1, accum, full.shape[1]),
        lambda s: tlr(s, base_lr=LR, num_epochs=1, steps_per_epoch=steps),
        world=2, sync_bn=flags.get("sync_bn", False))
    jm = interop.momentum_list_from_tree(VGG(NARROW), jmom)
    dist_of = lambda ts, ref: max(float((t.double() - r).abs().max())
                                  for t, r in zip(ts, ref))
    print(f"{flags}: float64 epoch, {steps} steps: port momentum "
          f"{dist_of(got['momentum'], fmom):.3e}, JAX momentum "
          f"{dist_of(jm, fmom):.3e}")
    _close(got["losses"], flosses, 1e-4)
    for k, v in fstate.items():
        _close(got["state_dict"][k], v, 1e-4, k)
    for a, b in zip(got["momentum"], fmom):
        _close(a, b, 1e-4)
    for a, b, f in zip(got["momentum"], jm, fmom):
        if float((b.double() - f).abs().max()) <= 1e-4:
            _close(a, b, 1e-4)


def test_grad_accum_world2_matches_jax_accum_epoch(narrow):
    flags = {"grad_accum": 2}
    want, ranks, sd, train = _world2(flags)
    _check_against_jax(want, ranks, 3, 6, flags, sd, train)


def test_shard_update_world2_matches_replicated_and_jax(narrow):
    flags = {"shard_update": True}
    want, ranks, sd, train = _world2(flags)
    _check_against_jax(want, ranks, 6, 6, flags, sd, train)
    # Each rank keeps half the (padded) momentum.
    n = sum(p.numel() for p in VGG(NARROW).parameters())
    assert all(g["momentum_numel"] == (n + n % 2) // 2 for g in ranks)
    # The replicated update on the same ranks: the same sums of two, so
    # the same bits.
    _, plain, _, _ = _world2({})
    assert torch.equal(ranks[0]["losses"], plain[0]["losses"])
    for k, v in plain[0]["state_dict"].items():
        assert torch.equal(ranks[0]["state_dict"][k], v), k
    for a, b in zip(ranks[0]["momentum"], plain[0]["momentum"]):
        assert torch.equal(a, b)


def test_all_three_composed_world2_matches_jax(narrow):
    """``--grad_accum 2 --sync_bn --shard_update`` against JAX's
    ``make_train_epoch_zero_accum(sync_bn=True)`` (the counterpart of
    ``test_zero_resident_accum_all_composed``)."""
    flags = {"grad_accum": 2, "sync_bn": True, "shard_update": True}
    want, ranks, sd, train = _world2(flags)
    _check_against_jax(want, ranks, 3, 6, flags, sd, train)


# --------------------------------------------------------------- the CLI


def _multigpu(args, tmp_path, name):
    path = tmp_path / f"{name}.json"
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.multigpu", *args,
         "--result_json", str(path)],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(path.read_text())


def test_multigpu_cli_flags_resume_and_checkpoints_cross(tmp_path):
    """``multigpu 2 2 --spawn 2`` with all three flags (full VGG width, 15
    images a rank: groups of 2 batches, then 1, then the ragged 3): its
    summary and collectives.  Its epoch-0 checkpoint restores into JAX's
    replicated and ZeRO trainers; JAX's ZeRO trainer's rewrite of it
    resumes in the port, and the resumed run's epoch repeats the
    uninterrupted run's bit for bit (losses and accuracy; both runs share
    the two-epoch LR schedule)."""
    flags = ["--grad_accum", "2", "--sync_bn", "--shard_update"]
    common = ["2", "2", "--batch_size", "4", "--synthetic_size", "30",
              *CLI_ARGS, "--spawn", "2", *flags]
    snapshot = tmp_path / "port.pt"
    full = _multigpu([*common, "--snapshot_path", str(snapshot)], tmp_path,
                     "full")
    assert (full["world"], full["backend"]) == (2, "gloo")
    assert (full["grad_accum"], full["sync_bn"], full["shard_update"]) == \
        (2, True, True)
    steps, micro = 2 * 3, 2 * 4
    assert len(full["loss_history"]) == steps
    assert all(np.isfinite(full["loss_history"]))
    # VGG-11 has 8 BN layers; the eval adds one all-reduce, the epoch-0
    # checkpoint one all-gather of the momentum; each (resident) epoch
    # boundary one preemption stop vote.
    assert full["collectives"] == {
        "all_reduce": 3 * 8 * micro + steps + 2 + 1, "broadcast": 1,
        "reduce_scatter": steps, "all_gather": steps + 1, "stop_vote": 2}

    ck = jckpt.load_checkpoint(str(snapshot))
    assert (ck.step, ck.epoch, ck.data_state["epoch"]) == (3, 0, 1)
    params, stats, momentum = _np((ck.params, ck.batch_stats,
                                   ck.opt_state.momentum_buf))
    jds, _ = jcifar.synthetic(n_train=30, n_test=64)
    mesh = make_mesh(2)
    jmodel = jget_model("vgg")
    params0, stats0 = jmodel.init(jax.random.key(0))
    for shard_update in (False, True):
        tr = JTrainer(jmodel, jloader.TrainLoader(jds, 4, 2, augment=False),
                      params0, stats0, mesh=mesh, lr_schedule=lambda s: 0.0,
                      snapshot_path=str(snapshot), resume=True,
                      resident=True, shard_update=shard_update,
                      sync_bn=True, grad_accum=2)
        opt = (opt_shard_to_pytree(tr.state.params, tr.state.opt_state,
                                   mesh) if shard_update
               else tr.state.opt_state)
        assert int(tr.state.step) == 3
        for a, b in zip(jax.tree_util.tree_leaves((params, momentum)),
                        jax.tree_util.tree_leaves(
                            _np((tr.state.params, opt.momentum_buf)))):
            np.testing.assert_array_equal(b, a)

    # What JAX's ZeRO trainer writes: the canonical momentum of its flat
    # sharded buffer.
    mom = opt_shard_to_pytree(params, pytree_to_opt_shard(momentum, mesh),
                              mesh)
    jfile = tmp_path / "jax.pt"
    jckpt.save_checkpoint(str(jfile), params, stats,
                          SGDState(_np(mom.momentum_buf)), step=ck.step,
                          epoch=ck.epoch, data_state=ck.data_state)
    resumed = _multigpu([*common, "--snapshot_path", str(jfile),
                         "--resume"], tmp_path, "resumed")
    assert resumed["loss_history"] == full["loss_history"][3:]
    assert resumed["accuracy"] == full["accuracy"]
