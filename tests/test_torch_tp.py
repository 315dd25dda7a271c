"""Tensor parallelism in the port (``ddp_tpu_torch/parallel/mesh.py``,
``parallel/tp/``, DeepNN's TP hooks, the TP step, the sharded update and
the checkpoints under ``--mesh_shape D,M``) against ``ddp_tpu`` on the same
numpy inputs.

The multi-rank checks run as gloo ranks on the CPU with one thread each and
a hard timeout (``tests/torch_tp_worker.py``, launched by
``dist.launch_local``), three launches in all: world 2 at mesh (1,2), then
world 4 at (2,2) and world 1 at once.  JAX runs its plan-wired steps on the suite's 8-device
CPU mesh at the same mesh shapes.

Tolerances: the wrappers against the unsharded ops at 1e-6 of the largest
|value| (float32 sums split over two ranks); two DeepNN steps at (1,2) and (2,2) against JAX's
plan-wired train step at ``TP_TRAJ_ATOL`` = 2e-6 on the weights
(``tests/test_tp.py:61``) and 1e-5 on the losses, dropout off and with
JAX's full-width masks passed in; ``--shard_update`` and ``--grad_accum 2``
at the same tolerances against JAX's ZeRO and accumulation steps; the m = 1
path bit for bit against the 1-D path; every checkpoint bit for bit.
"""
import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ddp_tpu.models.deepnn as jdeepnn
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.optim.sgd import SGDState
from ddp_tpu.parallel.mesh import (local_batch_slice as jlocal_batch_slice,
                                   local_replica_ids as jlocal_replica_ids,
                                   make_mesh as jmake_mesh)
from ddp_tpu.parallel.tp import plan as jplan_lib
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train import ckpt_shard as jckpt_shard
from ddp_tpu.train.step import (init_train_state, make_train_step,
                                make_train_step_accum, shard_batch,
                                shard_batch_stacked)
from ddp_tpu.train.zero import (init_opt_shard, make_train_step_zero,
                                opt_shard_to_pytree)
from torch_float64 import float64_epoch
from torch_procs import in_background, module_argv, run_at_once
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.parallel import mesh as tmesh
from ddp_tpu_torch.parallel.tp import plan as tplan
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import ckpt_shard as tckpt_shard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
TIMEOUT = 120
TP_TRAJ_ATOL = 2e-6
LOSS_ATOL = 1e-5
KEEP = 1.0 - jdeepnn.DROPOUT_RATE
SHAPES = [(2, 4), (4, 2), (1, 2), (2, 2)]
_SGD = JSGDConfig(lr=0.1)
_SCHED = functools.partial(jlr, base_lr=0.1, num_epochs=2, steps_per_epoch=4)
GLOBAL_BATCH = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _max_diff(a, b):
    """The largest |a - b| over two equal-structured numpy trees."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.abs(np.asarray(x, np.float64) - y).max())
               for x, y in zip(la, lb))


def _bits_equal(a, b):
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _tree(sd):
    """A port (whole) state dict or momentum dict -> JAX's params tree."""
    return interop.jax_from_state_dict("deepnn", sd)[0]


@pytest.fixture(scope="module")
def start():
    params, _ = jget_model("deepnn").init(jax.random.key(0))
    params = _np(params)
    return params, interop.state_dict_from_jax("deepnn", params, {})


def _batches(n, accum=1, seed=0):
    rs = np.random.RandomState(seed)
    lead = (accum,) if accum > 1 else ()
    return [{"image": rs.randint(0, 256, lead + (GLOBAL_BATCH, 32, 32, 3)
                                 ).astype(np.uint8),
             "label": rs.randint(0, 10, lead + (GLOBAL_BATCH,)
                                 ).astype(np.int32)} for _ in range(n)]


def _torch_batches(batches):
    return [{"image": torch.from_numpy(b["image"]),
             "label": torch.from_numpy(b["label"].astype(np.int64))}
            for b in batches]


def _jax_masks(shape, n_steps):
    """JAX's dropout masks of its train step at mesh ``shape``:
    ``[step][micro][data index]``, each the full-width [B, 512] draw of the
    key the step folds (step, then the data index)."""
    b = GLOBAL_BATCH // shape[0]
    return [[[torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(jax.random.key(7), s), j),
        KEEP, (b, 512)))) for j in range(shape[0])]] for s in range(n_steps)]


def _jax_steps(params0, shape, batches, *, zero=False, accum=False):
    """JAX's plan-wired train steps at mesh ``shape``: (losses, params,
    momentum) as numpy trees."""
    mesh = jmake_mesh(shape=shape)
    plan = jplan_lib.plan_for_model("deepnn", params0, {},
                                    model_size=shape[1])
    model = jget_model("deepnn")
    state = init_train_state(jax.tree_util.tree_map(jnp.asarray, params0),
                             {})
    if zero:
        step = make_train_step_zero(model, _SGD, _SCHED, mesh, plan=plan)
        state = state._replace(opt_state=init_opt_shard(state.params, mesh,
                                                        plan=plan))
        state = jax.device_put(state, jplan_lib.state_shardings(
            plan, mesh, zero=True))
    else:
        make_step = make_train_step_accum if accum else make_train_step
        step = make_step(model, _SGD, _SCHED, mesh, plan=plan)
        state = jax.device_put(state, jplan_lib.state_shardings(plan, mesh))
    shard = shard_batch_stacked if accum else shard_batch
    losses = []
    for b in batches:
        state, loss = step(state, shard(b, mesh), jax.random.key(7))
        losses.append(float(loss))
    mom = (opt_shard_to_pytree(state.params, state.opt_state, mesh,
                               plan=plan).momentum_buf
           if zero else state.opt_state.momentum_buf)
    return losses, _np(state.params), _np(mom)


class _Data:  # the fields float64_epoch reads
    def __init__(self, images, labels):
        self.images, self.labels = images, labels


def _float64(sd, shape, batches, masks=None):
    """The float64 referee (``tests/torch_float64.py``) of the same steps:
    the unsharded DeepNN on each step's global batch, split over the data
    axis's ``shape[0]`` shards; ``masks`` as :func:`_jax_masks`'.  Returns
    (losses, params tree, momentum tree)."""
    images = np.concatenate([b["image"].reshape(-1, 32, 32, 3)
                             for b in batches])
    labels = np.concatenate([b["label"].reshape(-1) for b in batches])
    groups, at = [], 0
    for b in batches:
        rows = b["label"].reshape(-1, GLOBAL_BATCH).shape[0]
        groups.append(np.arange(at, at + rows * GLOBAL_BATCH).reshape(
            rows, GLOBAL_BATCH))
        at += rows * GLOBAL_BATCH
    losses, p, mom = float64_epoch(
        sd, _Data(images, labels), groups, lambda s: _SCHED(s),
        world=shape[0], sync_bn=False, model="deepnn",
        masks=None if masks is None else
        (lambda s, k, r: masks[s][k][r]))
    names = [n for n, _ in get_model("deepnn", device="meta")
             .named_parameters()]
    return (losses, _tree({k: v.float() for k, v in p.items()}),
            _tree({n: v.float() for n, v in zip(names, mom)}))


def _held(got, jl, jparams, jmom, ref, what):
    """``got`` (a steps task's rank-0 result) within ``TP_TRAJ_ATOL`` of
    JAX's weights and momentum, or, where JAX's own float32 drifts further
    from the float64 referee ``ref``, within it of the referee and nearer
    to it than JAX; the losses within ``LOSS_ATOL`` of JAX's.  Prints
    which."""
    params, mom = _tree(got["state_dict"]), _tree(got["momentum"])
    vs_jax = max(_max_diff(params, jparams), _max_diff(mom, jmom))
    vs_ref = max(_max_diff(params, ref[1]), _max_diff(mom, ref[2]))
    jax_ref = max(_max_diff(jparams, ref[1]), _max_diff(jmom, ref[2]))
    held = "JAX" if vs_jax <= TP_TRAJ_ATOL else "the float64 referee"
    print(f"{what}: weights and momentum {vs_jax:.3e} from JAX, "
          f"{vs_ref:.3e} from float64 (JAX {jax_ref:.3e}); held to {held}")
    assert vs_jax <= TP_TRAJ_ATOL or (vs_ref <= TP_TRAJ_ATOL
                                      and vs_ref < jax_ref)
    assert np.allclose(got["losses"], jl, atol=LOSS_ATOL, rtol=0)
    assert np.allclose(got["losses"], ref[0], atol=LOSS_ATOL, rtol=0)


def _launch(tasks, world, tmp):
    out = os.path.join(tmp, f"world{world}")
    os.makedirs(out)
    spec = os.path.join(out, "spec.pt")
    torch.save({"tasks": tasks}, spec)
    code = dist.launch_local(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_worker.py"),
         spec, out], world, env=ENV, timeout=TIMEOUT)
    assert code == 0, f"a tensor-parallel rank exited with {code}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(start):
    """The three launches' results, by world, and the (1,2) saves."""
    _, sd = start
    tmp = tempfile.mkdtemp(prefix="tp_test_")
    two = _torch_batches(_batches(2))
    save = {"sharded": os.path.join(tmp, "v2.pt"),
            "gathered": os.path.join(tmp, "v1.pt")}
    steps = dict(kind="steps", state_dict=sd, batches=two)
    out = {"tmp": tmp, "save": save, "batches": _batches(2)}
    out[2] = _launch([
        dict(kind="wrappers", name="wrappers", mesh=(1, 2)),
        dict(steps, name="off", mesh=(1, 2), dropout=0.0, save=save),
        dict(steps, name="on", mesh=(1, 2), dropout=jdeepnn.DROPOUT_RATE,
             masks=_jax_masks((1, 2), 2))], 2, tmp)
    train = _batches(1, seed=5)[0]
    resume = dict(kind="resume", path=save["sharded"],
                  images=torch.from_numpy(train["image"]),
                  labels=torch.from_numpy(train["label"].astype(np.int64)))
    # Both read the (1,2) sharded save; they run at once.
    four = in_background(_launch, [
        dict(steps, name="off", mesh=(2, 2), dropout=0.0),
        dict(steps, name="on", mesh=(2, 2), dropout=jdeepnn.DROPOUT_RATE,
             masks=_jax_masks((2, 2), 2)),
        dict(steps, name="zero", mesh=(2, 2), dropout=0.0,
             shard_update=True),
        dict(steps, name="accum", mesh=(2, 2), dropout=0.0,
             batches=_torch_batches(_batches(2, accum=2))),
        dict(resume, name="resume", mesh=(2, 2), batch=4,
             shard_update=True)], 4, tmp)
    one = in_background(_launch, [
        dict(steps, name="tp", mesh=(1, 1), dropout=jdeepnn.DROPOUT_RATE,
             force_tp=True, dropout_seed=3),
        dict(steps, name="plain", mesh=(1, 1),
             dropout=jdeepnn.DROPOUT_RATE, dropout_seed=3),
        dict(resume, name="resume", mesh=(1, 1), batch=8)], 1, tmp)
    out[4], out[1] = four.result(), one.result()
    return out


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_index_math_matches_jax(shape):
    jm = jmake_mesh(shape=shape)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    d, m = shape
    meshes = [tmesh.Mesh(shape, r) for r in range(d * m)]
    for r, tm in enumerate(meshes):
        assert grid[tm.data_index, tm.model_index] == r
        assert tm.data_ranks(tm.model_index) == list(grid[:, tm.model_index])
        assert tm.model_ranks(tm.data_index) == list(grid[tm.data_index])
    assert np.array_equal(meshes[0].devices, grid)
    assert meshes[0].shape == dict(jm.shape)
    assert tmesh.data_axis_size(meshes[0]) == d
    assert tmesh.model_axis_size(meshes[0]) == m
    # One JAX process feeds every data row; each port rank its own.
    assert sorted({i for tm in meshes
                   for i in tmesh.local_replica_ids(tm)}) == \
        jlocal_replica_ids(jm)
    for batch in (32, 6, 7):
        try:
            want = jlocal_batch_slice(batch, jm)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tmesh.local_batch_slice(batch, meshes[0])
            assert str(got.value) == str(e)
            continue
        assert tmesh.local_batch_slice(batch, meshes[0]) * d == want
    # A stage axis is a pipeline now (tests/test_torch_pp.py): rank 3 of
    # (1, 2, 2) is model index 1 at stage 1.
    m3 = tmesh.Mesh((1, 2, 2), 3)
    assert (m3.dims, m3.model_index, m3.stage_index) == ((1, 2, 2), 1, 1)
    assert tmesh.Mesh((2, 2, 1), 3).dims == (2, 2)


# -- the plan ----------------------------------------------------------------

def _plans(start, m):
    params, _ = start
    return (jplan_lib.plan_for_model("deepnn", params, {}, model_size=m),
            tplan.plan_for_model("deepnn", get_model("deepnn",
                                                     device="meta"),
                                 model_size=m))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_leaf_specs_split_the_dims_jax_splits(start, m):
    jp, tp = _plans(start, m)
    jspecs = dict(jax.tree_util.tree_flatten_with_path(
        jp.param_specs, is_leaf=lambda x: isinstance(x, P))[0])
    jspecs = {"/".join(k.key for k in path): spec
              for path, spec in jspecs.items()}
    assert set(jspecs) == set(tp.param_specs)
    model = get_model("deepnn", device="meta")
    for key, p in model.named_parameters():
        path, rule = interop.rule_of("deepnn", key)
        want = tuple(jspecs[path])
        assert tp.tree_specs[path] == want, path
        port = tp.param_specs[path]
        assert len(port) in (0, p.dim())
        for dim, name in enumerate(port):
            if name is not None:
                assert want[interop.tree_dim(rule.layout, dim)] == name
    # column splits the port's dim 0, row its dim 1 (torch layouts).
    if m > 1:
        assert tp.param_specs["features/conv0/kernel"] == \
            ("model", None, None, None)
        assert tp.param_specs["features/conv1/kernel"] == \
            (None, "model", None, None)
        assert tp.param_specs["classifier/linear0/weight"] == \
            ("model", None)
        assert tp.param_specs["classifier/linear1/weight"] == \
            (None, "model")
        assert tp.param_specs["features/conv1/bias"] == ()
    assert tplan.local_param_count(tp) == jplan_lib.local_param_count(jp)
    for backward in (True, False):
        assert tplan.expected_collectives(tp, backward=backward) == \
            jplan_lib.expected_collectives(jp, backward=backward)
        assert tplan.expected_collectives_by_layer(
            tp, backward=backward) == \
            jplan_lib.expected_collectives_by_layer(jp, backward=backward)
        assert tplan.format_collective_table(tp, backward=backward) == \
            jplan_lib.format_collective_table(jp, backward=backward)
    assert tplan.is_trivial(tp) == jplan_lib.is_trivial(jp)
    assert tplan.recipe_override(tp) == jplan_lib.recipe_override(jp)
    # The table's text, shape columns apart.
    jt = jplan_lib.format_plan_table(jp).splitlines()
    tt = tplan.format_plan_table(tp).splitlines()
    assert len(jt) == len(tt)
    assert tt[0] == jt[0] and tt[1].split() == jt[1].split()
    assert tt[-2:] == jt[-2:]
    for a, b in zip(jt[2:-2], tt[2:-2]):
        fa, fb = a.split(), b.split()
        assert (fa[0], fa[1], fa[-1]) == (fb[0], fb[1], fb[-1])


def test_plan_validation_messages_match_jax(start, monkeypatch):
    params, _ = start
    meta = get_model("deepnn", device="meta")
    with pytest.raises(ValueError) as j:
        jplan_lib.plan_for_model("deepnn", params, {}, model_size=3)
    with pytest.raises(ValueError) as t:
        tplan.plan_for_model("deepnn", meta, model_size=3)
    jl, tl = str(j.value).splitlines(), str(t.value).splitlines()
    assert tl[0] == jl[0]
    # Every violation named at once; the dims are each layout's own.
    assert [x.split(":")[0] for x in tl[1:]] == \
        [x.split(":")[0] for x in jl[1:]]
    for name in ("vgg", "resnet18"):
        jparams, jstats = jget_model(name).init(jax.random.key(0))
        with pytest.raises(ValueError) as j:
            jplan_lib.plan_for_model(name, jparams, jstats, model_size=2)
        with pytest.raises(ValueError) as t:
            tplan.plan_for_model(name, get_model(name, device="meta"),
                                 model_size=2)
        assert str(t.value) == str(j.value)
    import ddp_tpu_torch.models.deepnn as tdeepnn
    for mod in (jdeepnn, tdeepnn):
        monkeypatch.setitem(mod.TP_RECIPE, "features/conv9", "column")
    with pytest.raises(ValueError) as j:
        jplan_lib.plan_for_model("deepnn", params, {}, model_size=2)
    with pytest.raises(ValueError) as t:
        tplan.plan_for_model("deepnn", meta, model_size=2)
    assert str(t.value) == str(j.value) and "conv9" in str(t.value)
    with pytest.raises(ValueError, match="unknown TP styles"):
        tplan.plan_for_model("deepnn", meta, model_size=2,
                             recipe={"features/conv0": "diagonal"})


def test_plan_table_module(capsys):
    from ddp_tpu_torch.parallel.tp.__main__ import main
    assert main(["--model", "deepnn", "--mesh_shape", "2,2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "tensor-parallel plan: deepnn | model axis m=2"
    assert out[-1].startswith("expected collectives: psum(model) fwd=3 "
                              "bwd=2 train=5")
    assert main(["--model_axis", "3"]) == 1
    assert "not divisible" in capsys.readouterr().err
    assert main(["--model", "vgg", "--model_axis", "2"]) == 1
    assert main(["--search"]) == 2
    assert "A13c" in capsys.readouterr().err


# -- the wrappers and the steps ------------------------------------------------

def test_wrappers_match_the_unsharded_ops(runs):
    for got in runs[2]:
        w = got["wrappers"]
        for kind in ("linear", "conv"):
            errs = w[kind]
            # The upstream parameter's gradient is the unsharded one, not M
            # times it (the overcount of an all-reduce whose backward is
            # another all-reduce).
            assert abs(errs.pop("upstream_scale") - 1.0) < 1e-5, kind
            assert max(errs.values()) < 1e-6, (kind, errs)
        assert w["dropout"]
        # Two row layers' forward sums and two column layers' backward
        # sums (the stem's input needs its gradient here: it is upstream
        # of a parameter).
        assert w["collectives"] == {"psum_model_fwd": 2,
                                    "psum_model_bwd": 2}


def test_m1_tp_path_is_bit_for_bit_the_1d_path_with_dropout(runs):
    tp, plain = runs[1][0]["tp"], runs[1][0]["plain"]
    assert tp["losses"] == plain["losses"]
    for k, v in plain["state_dict"].items():
        assert torch.equal(tp["state_dict"][k], v), k
    for k, v in plain["momentum"].items():
        assert torch.equal(tp["momentum"][k], v), k
    # The TP forward ran: 3 forward and 2 backward sums a step.
    assert tp["collectives"]["psum_model_fwd"] == 3 * 2
    assert tp["collectives"]["psum_model_bwd"] == 2 * 2
    assert "psum_model_fwd" not in plain["collectives"]


def _check_ranks_agree(ranks, name):
    first = ranks[0][name]
    for got in ranks[1:]:
        assert got[name]["losses"] == first["losses"]
        for k, v in first["state_dict"].items():
            assert torch.equal(got[name]["state_dict"][k], v), k


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
@pytest.mark.parametrize("dropout", ["off", "on"])
def test_two_steps_match_jax_plan_wired_step(start, runs, world, shape,
                                             dropout, monkeypatch):
    params, _ = start
    if dropout == "off":
        monkeypatch.setattr(jdeepnn, "DROPOUT_RATE", 0.0)
    jl, jparams, jmom = _jax_steps(params, shape, runs["batches"])
    _check_ranks_agree(runs[world], dropout)
    got = runs[world][0][dropout]
    masks = None
    if dropout == "on":
        assert got["masks_left"] == 0
        masks = _jax_masks(shape, len(jl))
    _held(got, jl, jparams, jmom,
          _float64(start[1], shape, runs["batches"], masks),
          f"{shape} dropout {dropout}")
    steps = len(jl)
    assert got["collectives"]["psum_model_fwd"] == 3 * steps
    assert got["collectives"]["psum_model_bwd"] == 2 * steps
    # One gradient all-reduce a step over the data group, one loss sum.
    assert got["collectives"]["all_reduce"] == 2 * steps
    assert got["local_numel"] == jplan_lib.local_param_count(
        jplan_lib.plan_for_model("deepnn", params, {},
                                 model_size=shape[1]))


@pytest.mark.parametrize("flag", ["zero", "accum"])
def test_shard_update_and_grad_accum_at_2x2(start, runs, flag, monkeypatch):
    params, _ = start
    monkeypatch.setattr(jdeepnn, "DROPOUT_RATE", 0.0)
    batches = _batches(2, accum=2) if flag == "accum" else runs["batches"]
    jl, jparams, jmom = _jax_steps(params, (2, 2), batches,
                                   zero=flag == "zero",
                                   accum=flag == "accum")
    _check_ranks_agree(runs[4], flag)
    got = runs[4][0][flag]
    _held(got, jl, jparams, jmom, _float64(start[1], (2, 2), batches),
          f"(2, 2) {flag}")
    if flag == "zero":
        # Each rank keeps its local flat vector's half: local / D, padded.
        local = got["local_numel"]
        assert got["momentum_numel"] == (local + local % 2) // 2
        assert got["collectives"]["reduce_scatter"] == 2
        assert got["collectives"]["all_gather"] == 2 + 1
    else:
        assert got["collectives"]["psum_model_fwd"] == 3 * 4


# -- the checkpoints -----------------------------------------------------------

def test_port_v2_save_reads_in_jax_and_equals_v1(runs):
    state = runs[2][0]["off"]
    v1, v2 = runs["save"]["gathered"], runs["save"]["sharded"]
    d = os.path.dirname(v2)
    names = sorted(n for n in os.listdir(d) if ".shard" in n)
    assert names == [
        "v2.pt.ep00000000.shard00000-of-00002.npz",
        "v2.pt.ep00000000.shard00000-of-00002.npz.sha256",
        "v2.pt.ep00000000.shard00001-of-00002.npz",
        "v2.pt.ep00000000.shard00001-of-00002.npz.sha256"]
    jck = jckpt_shard.assemble_checkpoint(v2)
    assert _bits_equal(_np(jax.tree_util.tree_map(np.asarray, jck.params)),
                       _tree(state["state_dict"]))
    assert _bits_equal(
        _np(jax.tree_util.tree_map(np.asarray, jck.opt_state.momentum_buf)),
        _tree(state["momentum"]))
    index = jckpt_shard.read_shard_index(v2)
    assert index["mesh_shape"] == [1, 2] and index["n_slots"] == 2
    assert index["leaves"]["params/features/conv0/kernel"]["spec"] == \
        [None, None, None, "model"]
    assert index["leaves"]["params/classifier/linear1/weight"][
        "shard_dim"] == 0
    a, b = tckpt.load_checkpoint(v1), tckpt.load_checkpoint(v2)
    assert (a.step, a.epoch) == (b.step, b.epoch) == (2, 0)
    for x, y in ((a.params, b.params), (a.momentum, b.momentum)):
        assert _bits_equal(x, y)
    assert _bits_equal(jckpt.load_checkpoint(v1).params, b.params)


def test_jax_2x4_v2_restores_onto_port_meshes(start, tmp_path):
    params, _ = start
    mesh = jmake_mesh(shape=(2, 4))
    plan = jplan_lib.plan_for_model("deepnn", params, {}, model_size=4)
    mom = jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, params)
    state = init_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                             {})
    state = jax.device_put(state._replace(opt_state=SGDState(
        jax.tree_util.tree_map(jnp.asarray, mom))),
        jplan_lib.state_shardings(plan, mesh))
    path = str(tmp_path / "j.pt")
    jckpt_shard.save_checkpoint_sharded(path, state.params,
                                        state.batch_stats, state.opt_state,
                                        3, 1, mesh=mesh)
    assert jckpt_shard.read_shard_index(path)["n_slots"] == 4
    want_sd = interop.state_dict_from_jax("deepnn", params, {})
    want_mom = interop.state_dict_from_jax("deepnn", mom, {})
    for shape in [(1, 2), (2, 2), (1, 1)]:
        d, m = shape
        tp = tplan.plan_for_model("deepnn", get_model("deepnn",
                                                      device="meta"),
                                  model_size=m)
        for r in range(d * m):
            k = tmesh.Mesh(shape, r).model_index
            ck = tckpt_shard.load_for_mesh(path, tp, k)
            assert (ck.step, ck.epoch) == (3, 1)
            model = get_model("deepnn")
            tplan.shard_module_(model, tp, k)
            momentum = [torch.zeros_like(p) for p in model.parameters()]
            tckpt.restore(ck, model, momentum)
            names = [n for n, _ in model.named_parameters()]
            want = interop.shard_state(tp, want_sd, k)
            want_m = interop.shard_state(tp, want_mom, k)
            for key, v in model.state_dict().items():
                assert torch.equal(v, want[key]), (shape, r, key)
            for n, v in zip(names, momentum):
                assert torch.equal(v, want_m[n]), (shape, r, n)
    # A restore whose slices do not fit the model is refused, named.
    model = get_model("deepnn")
    with pytest.raises(tckpt.CheckpointError, match="deepnn"):
        tckpt.restore(tckpt_shard.load_for_mesh(path, tp_for(2), 0), model)


def tp_for(m):
    return tplan.plan_for_model("deepnn", get_model("deepnn", device="meta"),
                                model_size=m)


def test_interop_shard_and_gather_round_trip(start):
    params, sd = start
    for m in (1, 2, 4):
        tp = tp_for(m)
        slices = [interop.rank_state_from_jax(tp, params, {}, k)
                  for k in range(m)]
        assert slices[0]["features.0.weight"].shape[0] == 128 // m
        assert slices[0]["classifier.3.weight"].shape[1] == 512 // m
        back = interop.gather_state(tp, slices)
        for key, v in sd.items():
            assert torch.equal(back[key], v), key


def test_resume_across_mesh_shapes(runs):
    """The (1,2) sharded save, resumed by the trainer at (2,2) with
    --shard_update and at 1-D: the restored state is the file's, bit for
    bit, and the resumed epoch trains on every rank alike."""
    ck = tckpt.load_checkpoint(runs["save"]["sharded"])
    for world in (4, 1):
        ranks = [r["resume"] for r in runs[world]]
        for got in ranks:
            assert got["start_epoch"] == 1
            assert _bits_equal(_tree(got["state_dict"]), ck.params)
            assert _bits_equal(_tree(got["momentum"]), ck.momentum)
            assert got["losses"] == ranks[0]["losses"]
            assert got["losses"] and all(np.isfinite(got["losses"]))


# -- the CLI ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_rounds(tmp_path_factory):
    """The two CLI round trips, each a run and its resume: the (1,2) run
    with a sharded save beside the (2,2) run with a gathered one, at once;
    then the first resumed on the plain 1-D layout beside the second at
    (1,2), at once.  Per case, its paths, its runs' results and the
    ``--result_json`` each left."""
    tmp = tmp_path_factory.mktemp("cli")
    common = ["--batch_size", "8", "--resident", "--synthetic",
              "--synthetic_size", "64", "--model", "deepnn", "--device",
              "cpu"]
    cases = {}
    for name in ("mesh", "2x2"):
        ck, rj = str(tmp / f"{name}.pt"), str(tmp / f"{name}.json")
        cases[name] = [*common, "--snapshot_path", ck, "--result_json", rj]
    cases["mesh"] += ["--lr", "0.05", "--ckpt_format", "sharded"]
    rounds = (
        {"mesh": ["1", "1", *cases["mesh"], "--mesh_shape", "1,2",
                  "--spawn", "2"],
         "2x2": ["2", "1", *cases["2x2"], "--mesh_shape", "2,2",
                 "--spawn", "4"]},
        {"mesh": ["2", "1", *cases["mesh"], "--spawn", "2", "--resume"],
         "2x2": ["3", "1", *cases["2x2"], "--mesh_shape", "1,2", "--spawn",
                 "2", "--resume"]})
    out = {name: {"ck": str(tmp / f"{name}.pt"), "runs": [], "results": []}
           for name in cases}
    for runs in rounds:
        done = run_at_once([(module_argv("ddp_tpu_torch.multigpu", args),
                             ENV) for args in runs.values()])
        for name, r in zip(runs, done):
            assert r.returncode == 0, r.stderr[-3000:]
            out[name]["runs"].append(r)
            with open(tmp / f"{name}.json") as f:
                out[name]["results"].append(json.load(f))
        if runs is rounds[0]:
            # What the first runs wrote, read before the resumes rewrite it.
            out["mesh"]["n_slots"] = tckpt_shard.read_shard_index(
                out["mesh"]["ck"])["n_slots"]
            out["2x2"]["ckpt"] = tckpt.load_checkpoint(out["2x2"]["ck"])
    return out


def test_cli_mesh_round_trip(cli_rounds):
    (r, resumed), (res, res2) = (cli_rounds["mesh"]["runs"],
                                 cli_rounds["mesh"]["results"])
    assert "tensor-parallel plan: deepnn | model axis m=2" in r.stdout
    steps, evals = len(res["loss_history"]), 64 // 8
    assert (res["world"], res["mesh_shape"], steps) == (2, [1, 2], 8)
    exp = tplan.expected_collectives(tp_for(2), backward=True)
    assert res["model_axis_collectives"] == {
        "psum_model_fwd": exp["psum_model_fwd"] * steps + 3 * evals,
        "psum_model_bwd": exp["psum_model_bwd"] * steps}
    assert cli_rounds["mesh"]["n_slots"] == 2
    # Resumed on another shape, the plain 1-D layout.
    assert "Resuming training from snapshot at Epoch 0" in resumed.stdout
    assert res2["mesh_shape"] is None and len(res2["loss_history"]) == 4


def test_cli_2x2_gathered_and_resumed_at_1x2(cli_rounds):
    """The slice's CPU command: ``--mesh_shape 2,2 --spawn 4`` trains, prints
    the plan table, counts the model-axis all-reduces, and writes the whole
    v1 file, which ``--mesh_shape 1,2`` resumes."""
    (r, resumed), (res, res2) = (cli_rounds["2x2"]["runs"],
                                 cli_rounds["2x2"]["results"])
    assert "tensor-parallel plan: deepnn | model axis m=2" in r.stdout
    steps, evals = len(res["loss_history"]), 64 // (8 * 2)
    assert (res["world"], res["mesh_shape"], steps) == (4, [2, 2], 8)
    assert res["model_axis_collectives"] == {
        "psum_model_fwd": 3 * steps + 3 * evals,
        "psum_model_bwd": 2 * steps}
    assert res["collectives"]["ckpt_gather_model"] == 2
    ckpt = cli_rounds["2x2"]["ckpt"]
    assert (ckpt.step, ckpt.epoch) == (8, 1)
    assert ckpt.params["features"]["conv0"]["kernel"].shape == (3, 3, 3,
                                                                128)
    assert "Resuming training from snapshot at Epoch 1" in resumed.stdout
    # One epoch at a data axis of 1: 64 images in batches of 8.
    assert res2["mesh_shape"] == [1, 2] and len(res2["loss_history"]) == 8


def _refused(argv, main=cli.main_multi):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


def test_cli_refusals_in_jax_words(start):
    params, _ = start
    base = ["1", "1", "--synthetic", "--device", "cpu"]
    vgg, _ = jget_model("vgg").init(jax.random.key(0))
    with pytest.raises(ValueError) as j:
        jplan_lib.plan_for_model("vgg", _np(vgg), {}, model_size=2)
    assert _refused(base + ["--mesh_shape", "2,2"]) == str(j.value)
    assert "--mesh_shape wants 'D,M' or 'D,M,S'" in _refused(
        base + ["--mesh_shape", "2,x"])
    assert _refused(base + ["--model", "deepnn", "--mesh_shape", "2,2",
                            "--num_devices", "2"]) == (
        "--num_devices 2 contradicts --mesh_shape 2,2 (= 4 devices); "
        "drop one")
    assert "must equal" in _refused(base + ["--model", "deepnn",
                                            "--mesh_shape", "1,2",
                                            "--spawn", "3"])
    # --mesh_shape 1,2,2 is a pipelined mesh of four ranks now.
    assert "must equal D×M×S = 4" in _refused(
        base + ["--model", "deepnn", "--mesh_shape", "1,2,2", "--spawn",
                "2"])
    assert "A13c" in _refused(base + ["--auto_plan", "p.json"])
    assert "infeasible" in _refused(base + ["--model", "deepnn",
                                            "--mesh_shape", "1x3"])
    assert "belongs to multigpu" in _refused(
        base + ["--model", "deepnn", "--mesh_shape", "1,2"], cli.main)
