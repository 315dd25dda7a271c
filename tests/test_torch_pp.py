"""Pipeline parallelism in the port (``ddp_tpu_torch/parallel/pp/``, the 3-D
rank grid, DeepNN's block forward, the pipelined trainer and CLI, the
supervisor's stage-first shrink and the ``kill_stage`` drill) against
``ddp_tpu`` on the same numpy inputs.

The multi-rank checks run as gloo ranks on the CPU with one thread each and
a hard timeout: one launch of world 4 (``tests/torch_pp_worker.py``: the
(2,1,2) steps under 1F1B and GPipe, the (1,2,2) steps), one of world 2
(``tests/torch_tp_worker.py``: the port's own ``--grad_accum 2`` steps at
(2,1) and (1,2)), three pipelined CLI runs (one of three stages) beside
their ``--grad_accum`` runs, and the campaign's ``kill_stage`` drill.  JAX runs ``make_pp_step``
on the suite's 8-device CPU mesh at the same shapes.

Tolerances: the pipelined steps bit for bit against the port's
accumulation steps, GPipe bit for bit against 1F1B, and the pipelined CLI
runs bit for bit against the ``--grad_accum`` runs (losses, weights,
momentum); against JAX's ``make_pp_step`` the weights and momentum within
``TP_TRAJ_ATOL`` = 2e-6 of JAX or, where JAX's own float32 drifts further,
of the float64 referee (``tests/torch_float64.py``), and the losses within
1e-5 (``tests/test_torch_tp.py``'s rule; ``-s`` prints each distance); the
tables, the plans, the op lists, the flop table and the supervisor's
relaunches exactly.
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

import ddp_tpu.models.deepnn as jdeepnn
from ddp_tpu.analysis.costmodel import layer_forward_costs as jlfc
from ddp_tpu.cli import _parse_mesh_shape as jparse
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.parallel.mesh import make_mesh as jmake_mesh
from ddp_tpu.parallel.pp import partition as jpart
from ddp_tpu.parallel.pp import schedule as jsched
from ddp_tpu.parallel.tp import plan as jplan_lib
from ddp_tpu.resilience import supervisor as jsup
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.step import init_train_state
from test_torch_tp import (GLOBAL_BATCH, KEEP, TP_TRAJ_ATOL, _SCHED, _SGD,
                           _batches, _float64, _held, _np, _torch_batches,
                           _tree)
from ddp_tpu_torch import chaos_campaign, cli, interop
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.parallel import dist
from ddp_tpu_torch.parallel import mesh as tmesh
from ddp_tpu_torch.parallel.pp import partition as tpart
from ddp_tpu_torch.parallel.pp import schedule as tsched
from ddp_tpu_torch.parallel.tp import plan as tplan
from ddp_tpu_torch.resilience import supervisor as tsup
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import ckpt_shard as tckpt_shard
from torch_procs import in_background, module_argv, run_at_once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
TIMEOUT = 150
META = get_model("deepnn", device="meta")


@pytest.fixture(scope="module")
def start():
    params, _ = jget_model("deepnn").init(jax.random.key(0))
    params = _np(params)
    return params, interop.state_dict_from_jax("deepnn", params, {})


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (2, 2, 2),
                                   (1, 1, 4), (2, 1, 1)])
def test_mesh_index_math_matches_jax(shape):
    jm = jmake_mesh(shape=shape)
    grid = np.vectorize(lambda d: d.id)(jm.devices)
    meshes = [tmesh.Mesh(shape, r) for r in range(int(np.prod(shape)))]
    assert np.array_equal(meshes[0].devices, grid)
    assert meshes[0].shape == dict(jm.shape)
    assert meshes[0].axis_names == jm.axis_names
    for r, tm in enumerate(meshes):
        if len(grid.shape) == 2:  # (d, m, 1) is the 2-D mesh
            assert tm.stages == 1 and tm.stage_index == 0
            assert grid[tm.data_index, tm.model_index] == r
            continue
        j, k, s = tm.data_index, tm.model_index, tm.stage_index
        assert grid[j, k, s] == r
        assert tm.data_ranks(k, s) == list(grid[:, k, s])
        assert tm.model_ranks(j, s) == list(grid[j, :, s])
        assert tm.stage_ranks(j, k) == list(grid[j, k, :])
        assert tm.stage_plane(s) == sorted(grid[:, :, s].ravel())
        assert tm.rank_of(j, k, s) == r
    assert tmesh.stage_axis_size(meshes[0]) == (shape[2] if shape[2] > 1
                                                else 1)


@pytest.mark.parametrize("bad", [(2, 1, 2, 2), (), (2, 0, 2), (2, -1),
                                 ("a", 1)])
def test_mesh_refuses_malformed_shapes_in_jax_words(bad):
    with pytest.raises(ValueError) as j:
        jmake_mesh(shape=bad)
    with pytest.raises(ValueError) as t:
        tmesh.Mesh(bad)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("text", ["2,1,2", "4x2", "1x2x2", "2,a",
                                  "2,1,2,2", "2,0,2", "2"])
def test_mesh_shape_parsing_matches_jax(text):
    try:
        want = jparse(text)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            cli._parse_mesh_shape(text)
        assert str(got.value) == str(e)
        return
    assert cli._parse_mesh_shape(text) == want


# -- the partition -----------------------------------------------------------

def _jplan(params, s, m=1, costs=None, with_params=True):
    return jpart.plan_stages("deepnn", s, model_size=m,
                             params=params if with_params else None,
                             batch_stats={}, costs=costs)


def _tplan(s, m=1, costs=None, with_model=True):
    return tpart.plan_stages("deepnn", s, model_size=m,
                             model=META if with_model else None,
                             costs=costs)


LOPSIDED = {"features/conv0": 100.0, "features/conv1": 1.0,
            "features/conv2": 1.0, "features/conv3": 1.0,
            "classifier/linear0": 1.0, "classifier/linear1": 1.0}


@pytest.mark.parametrize("s,m,costs,priced", [
    (2, 1, None, True), (3, 1, None, True), (6, 1, None, True),
    (2, 2, None, True), (3, 2, None, True), (2, 1, LOPSIDED, False),
    (4, 1, LOPSIDED, False), (3, 1, None, False), (5, 1, None, False)])
def test_plan_stages_matches_jax(start, s, m, costs, priced):
    params, _ = start
    want = _jplan(params, s, m, costs, priced)
    got = _tplan(s, m, costs, priced)
    assert tuple(got) == tuple(want)
    assert got.uniform_costs == (costs is None and not priced)


@pytest.mark.parametrize("model,s,m", [("deepnn", 99, 1), ("deepnn", 4, 2),
                                       ("deepnn", 0, 1), ("deepnn", 7, 2),
                                       ("vgg", 2, 1), ("resnet18", 2, 1)])
def test_plan_stages_reports_every_violation_in_jax_words(start, model, s,
                                                          m):
    with pytest.raises(ValueError) as j:
        jpart.plan_stages(model, s, model_size=m)
    with pytest.raises(ValueError) as t:
        tpart.plan_stages(model, s, model_size=m)
    assert str(t.value) == str(j.value)


def test_flop_table_equals_layer_forward_costs(start):
    params, _ = start
    jp = jplan_lib.plan_for_model("deepnn", params, {}, model_size=1)
    want = jlfc(jget_model("deepnn"), jp, params, {})
    got = tpart.layer_forward_costs("deepnn", META)
    assert got == want
    assert tpart.block_costs("deepnn", META) == jpart.block_costs(
        "deepnn", params, {})
    assert tpart.layer_forward_costs("vgg", get_model(
        "vgg", device="meta")) is None


@pytest.mark.parametrize("s,m", [(2, 1), (3, 1), (4, 1), (6, 1), (2, 2),
                                 (3, 2)])
def test_stage_table_and_bubble_match_jax(start, s, m):
    params, _ = start
    for priced in (True, False):
        jp, tp = _jplan(params, s, m, None, priced), _tplan(s, m, None,
                                                            priced)
        for a in (None, 1, 2, 8):
            assert tpart.format_stage_table(tp, a) == \
                jpart.format_stage_table(jp, a)
    for a in (1, 2, 4, 7):
        assert tpart.predicted_bubble(s, a) == jpart.predicted_bubble(s, a)
    for bad in ((0, 4), (2, 0)):
        with pytest.raises(ValueError) as j:
            jpart.predicted_bubble(*bad)
        with pytest.raises(ValueError) as t:
            tpart.predicted_bubble(*bad)
        assert str(t.value) == str(j.value)


@pytest.mark.parametrize("s,m", [(2, 1), (3, 1), (2, 2), (3, 2)])
def test_stage_subtrees_and_model_psums_match_jax(start, s, m):
    params, sd = start
    jp, tp = _jplan(params, s, m), _tplan(s, m)
    parts = [tpart.stage_subtree(tp, k, params) for k in range(s)]
    merged = tpart.merge_subtrees(parts)
    assert jax.tree_util.tree_structure(merged) == \
        jax.tree_util.tree_structure(params)
    assert all(x is y for x, y in zip(jax.tree_util.tree_leaves(merged),
                                      jax.tree_util.tree_leaves(params)))
    for k in range(s):
        assert tpart.stage_param_paths(tp, k) == jpart.stage_param_paths(
            jp, k)
        want = jpart.stage_subtree(jp, k, params)
        assert jax.tree_util.tree_structure(parts[k]) == \
            jax.tree_util.tree_structure(want)
        # The port's stage keys are the same leaves, named the port's way.
        keys = tsched.stage_keys("deepnn", tp, k, sd)
        assert _tree({n: sd[n] for n in keys}).keys() == want.keys()
        assert list(interop.stage_state(tp, sd, k)) == keys
    jtp = jplan_lib.plan_for_model("deepnn", params, {}, model_size=m)
    ttp = tplan.plan_for_model("deepnn", META, model_size=m)
    for k in range(s):
        for role in ("forward", "backward", "fwdbwd", "update"):
            assert tpart.stage_model_psums(tp, ttp, k, role=role) == \
                jpart.stage_model_psums(jp, jtp, k, role=role)
    assert tpart.stage_model_psums(tp, None, 0, role="forward") == 0
    with pytest.raises(ValueError) as j:
        jpart.stage_model_psums(jp, jtp, 0, role="sideways")
    with pytest.raises(ValueError) as t:
        tpart.stage_model_psums(tp, ttp, 0, role="sideways")
    assert str(t.value) == str(j.value)


def test_stage_cut_module_holds_its_blocks_and_composes_with_tp(start):
    _, sd = start
    tp2 = tplan.plan_for_model("deepnn", META, model_size=2)
    plan = _tplan(2, 2)
    for k in range(2):
        model = get_model("deepnn")
        model.load_state_dict(sd)
        tplan.shard_module_(model, tp2, 1)
        tsched.stage_module_(model, plan, k)
        assert list(model.state_dict()) == tsched.stage_keys(
            "deepnn", plan, k, sd)
        want = interop.rank_state_from_jax(tp2, start[0], {}, 1,
                                           pp_plan=plan, stage=k)
        assert list(want) == list(model.state_dict())
        assert all(torch.equal(model.state_dict()[n], v)
                   for n, v in want.items())
    # Whole-model forward is the block forward over every block.
    model = get_model("deepnn")
    model.load_state_dict(sd)
    model.eval()
    x = torch.rand(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    h = model.forward_blocks(x, (0, 2))
    assert tsched.handoff_shapes("deepnn", plan) == [tuple(h.shape[1:])]
    assert torch.equal(model.forward_blocks(h, (2, 6)), model(x))
    with pytest.raises(ValueError, match="non-empty range"):
        model.forward_blocks(x, (3, 3))


# -- the schedules -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("a,s", [(1, 2), (2, 2), (4, 2), (4, 3), (3, 4),
                                 (1, 5), (8, 3)])
def test_schedule_ops_match_jax(kind, a, s):
    ops = tsched.schedule_ops(kind, a, s)
    assert ops == jsched.schedule_ops(kind, a, s)
    for j in range(s):
        mine = [op for op in ops if tsched.stage_of(op, s) == j]
        # Each stage's backward (or fused) ops take the micros in order:
        # the accumulation order of the --grad_accum step.
        assert [op[-1] for op in mine if op[0] != "F"] == list(range(a))


@pytest.mark.parametrize("args", [("zigzag", 2, 2), ("1f1b", 2, 1)])
def test_schedule_refusals_in_jax_words(args):
    with pytest.raises(ValueError) as j:
        jsched.schedule_ops(*args)
    with pytest.raises(ValueError) as t:
        tsched.schedule_ops(*args)
    assert str(t.value) == str(j.value)


# -- the steps ---------------------------------------------------------------

def _jax_masks(shape, n_steps, accum):
    """JAX's dropout masks of its pipelined (and accumulation) step at mesh
    ``shape``: ``[step][micro][data index]``, each the full-width [B, 512]
    draw of the key the step folds (step, data index, micro)."""
    b = GLOBAL_BATCH // shape[0]
    return [[[torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.key(7), s), j), k), KEEP, (b, 512))))
        for j in range(shape[0])] for k in range(accum)]
        for s in range(n_steps)]


def _jax_pp(params0, shape, batches, kind, dropout):
    """JAX's ``make_pp_step`` at mesh ``shape``: (losses, params, momentum,
    the end state)."""
    from ddp_tpu.parallel.pp import make_pp_step, place_state, pp_shard_fn
    mesh = jmake_mesh(shape=shape)
    tp = jplan_lib.plan_for_model("deepnn", params0, {},
                                  model_size=shape[1])
    pp = jpart.plan_stages("deepnn", shape[2], model_size=shape[1],
                           params=params0, batch_stats={})
    rate = jdeepnn.DROPOUT_RATE
    jdeepnn.DROPOUT_RATE = dropout
    try:
        step = make_pp_step("deepnn", _SGD, _SCHED, mesh, pp, tp_plan=tp,
                            schedule=kind)
        state = place_state(init_train_state(jax.tree_util.tree_map(
            jnp.asarray, params0), {}), mesh, pp, tp)
        shard = pp_shard_fn(pp)
        losses = []
        for b in batches:
            state, loss = step(state, shard(b, mesh), jax.random.key(7))
            losses.append(float(loss))
    finally:
        jdeepnn.DROPOUT_RATE = rate
    state = jax.device_get(state)
    return (losses, _np(state.params), _np(state.opt_state.momentum_buf),
            state)


def _launch(worker, tasks, world, tmp):
    out = os.path.join(tmp, f"{worker[:-3]}{world}")
    os.makedirs(out)
    spec = os.path.join(out, "spec.pt")
    torch.save({"tasks": tasks}, spec)
    code = dist.launch_local(
        [sys.executable, os.path.join(ROOT, "tests", worker), spec, out],
        world, env=ENV, timeout=TIMEOUT)
    assert code == 0, f"a {worker} rank exited with {code}"
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(start):
    """The world-4 pipelined steps and the world-2 accumulation steps from
    the same start on the same two stacked groups, and JAX's."""
    params, sd = start
    tmp = tempfile.mkdtemp(prefix="pp_test_")
    groups = _batches(2, accum=2)
    two = _torch_batches(groups)
    masks = _jax_masks((2, 1), 2, 2)
    pp = dict(kind="pp", state_dict=sd, batches=two)
    out = {"tmp": tmp, "groups": groups, "masks": masks}
    # The two launches run at once.
    pp_ranks = in_background(_launch, "torch_pp_worker.py", [
        dict(pp, name="dm_1f1b", mesh=(2, 1, 2), schedule="1f1b",
             dropout=jdeepnn.DROPOUT_RATE, masks=masks),
        dict(pp, name="dm_gpipe", mesh=(2, 1, 2), schedule="gpipe",
             dropout=jdeepnn.DROPOUT_RATE, masks=masks),
        dict(pp, name="tp", mesh=(1, 2, 2), schedule="1f1b", dropout=0.0)],
        4, tmp)
    steps = dict(kind="steps", state_dict=sd, batches=two)
    accum = in_background(_launch, "torch_tp_worker.py", [
        dict(steps, name="dm", mesh=(2, 1), dropout=jdeepnn.DROPOUT_RATE,
             masks=masks),
        dict(steps, name="tp", mesh=(1, 2), dropout=0.0)], 2, tmp)
    out["pp"], out["accum"] = pp_ranks.result(), accum.result()
    return out


def _bitwise(a, b):
    return (a["losses"] == b["losses"]
            and list(a["state_dict"]) == list(b["state_dict"])
            and all(torch.equal(v, b["state_dict"][k])
                    for k, v in a["state_dict"].items())
            and all(torch.equal(v, b["momentum"][k])
                    for k, v in a["momentum"].items()))


@pytest.mark.parametrize("task,ref", [("dm_1f1b", "dm"), ("dm_gpipe", "dm"),
                                      ("tp", "tp")])
def test_pp_steps_equal_the_accumulation_step_bit_for_bit(runs, task, ref):
    got, want = runs["pp"][0][task], runs["accum"][0][ref]
    assert _bitwise(got, want)
    # Every rank saw the same global-mean losses, and the masks were each
    # drawn once, on the stage that owns the dropout.
    assert all(r[task]["losses"] == got["losses"] for r in runs["pp"])
    last = [r[task] for r in runs["pp"] if r[task]["stage"] == 1]
    if task != "tp":
        assert all(r["masks_left"] == 0 for r in last)


def test_gpipe_equals_1f1b_and_the_handoffs_are_counted(runs):
    a, b = runs["pp"][0]["dm_1f1b"], runs["pp"][0]["dm_gpipe"]
    assert _bitwise(a, b)
    # Per rank and step: A forward handoffs out and A cotangents in on
    # stage 0, the mirror on stage 1; the activation after conv1 is
    # [B, 64, 16, 16] float32.
    d = 2
    act = (GLOBAL_BATCH // d) * 64 * 16 * 16 * 4
    for r in runs["pp"]:
        for task in ("dm_1f1b", "dm_gpipe"):
            t = r[task]
            assert t["collectives"]["pp_handoff"] == 2 * 2 * 2
            assert t["handoff"]["bytes_sent"] == 2 * 2 * act
            assert "all_reduce" in t["collectives"] and \
                "psum_model_fwd" not in t["collectives"]
    stage0 = [r for r in runs["pp"] if r["dm_1f1b"]["stage"] == 0]
    assert {r["dm_1f1b"]["peak_inflight"] for r in stage0} == {1}
    assert {r["dm_gpipe"]["peak_inflight"] for r in stage0} == {2}
    bub = a["bubble"]
    assert (bub["num_stages"], bub["num_micro"], bub["schedule"]) == \
        (2, 2, "1f1b")
    assert bub["bubble_predicted"] == 1 / 3
    assert 0.0 <= bub["bubble_measured"] < 1.0 and bub["makespan_s"] > 0


def test_tp_composed_with_pp_counts_each_stages_model_sums(runs):
    """At (1,2,2) the cut falls after conv1 (column conv0 + row conv1 on
    stage 0; column conv2, row conv3, column linear0, row linear1 on stage
    1): per micro-batch stage 0 sums once forward and never backward (the
    stem's input gradient is not asked for), stage 1 twice forward and
    twice backward: ``stage_model_psums``' forward and backward counts."""
    tp2 = tplan.plan_for_model("deepnn", META, model_size=2)
    plan = _tplan(2, 2)
    for r in runs["pp"]:
        t = r["tp"]
        k, micros = t["stage"], 2 * 2
        fwd = tpart.stage_model_psums(plan, tp2, k, role="forward")
        both = tpart.stage_model_psums(
            plan, tp2, k, role="backward" if k == 0 else "fwdbwd")
        assert t["collectives"].get("psum_model_fwd", 0) == fwd * micros
        assert t["collectives"].get("psum_model_bwd", 0) == \
            (both - fwd) * micros


@pytest.mark.parametrize("shape,task", [((2, 1, 2), "dm_1f1b"),
                                        ((1, 2, 2), "tp")])
def test_pp_steps_match_jax_make_pp_step(start, runs, shape, task):
    params, sd = start
    dropout = jdeepnn.DROPOUT_RATE if task != "tp" else 0.0
    jl, jp, jm, _ = _jax_pp(params, shape, runs["groups"], "1f1b", dropout)
    got = runs["pp"][0][task]
    # The float64 referee of the same steps (no masks: dropout off).
    ref = _float64(sd, shape[:2], runs["groups"],
                   runs["masks"] if dropout else None)
    _held(got, jl, jp, jm, ref, f"pp {shape} against make_pp_step")


# -- the checkpoints ---------------------------------------------------------

def test_checkpoints_cross_between_the_packages(start, runs, tmp_path):
    """JAX's pipelined end state, saved as its trainer saves one (the
    canonical v1 file), restores onto each (2,1,2) stage of the port
    through ``load_for_mesh`` bit for bit; the port's pipelined save
    (rank 0's gathered state) reads in JAX bit for bit."""
    params, _ = start
    _, jp, jm, state = _jax_pp(params, (2, 1, 2), runs["groups"], "gpipe",
                               0.0)
    path = str(tmp_path / "jax_pp.pt")
    jckpt.save_checkpoint(path, state.params, {}, state.opt_state, 2, 0)
    plan = _tplan(2, 1)
    for k in range(2):
        model = get_model("deepnn")
        tsched.stage_module_(model, plan, k)
        mom = [torch.zeros_like(p) for p in model.parameters()]
        tckpt.restore(tckpt_shard.load_for_mesh(path, pp_plan=plan,
                                                stage=k), model, mom)
        want = interop.stage_state(plan, interop.state_dict_from_jax(
            "deepnn", jp, {}), k)
        assert all(torch.equal(model.state_dict()[n], v)
                   for n, v in want.items())
        names = [n for n, _ in model.named_parameters()]
        wmom = interop.stage_state(plan, interop.state_dict_from_jax(
            "deepnn", jm, {}), k)
        assert all(torch.equal(m, wmom[n]) for n, m in zip(names, mom))
    got = runs["pp"][0]["dm_1f1b"]
    port = str(tmp_path / "port_pp.pt")
    tckpt.write_gathered(port, tckpt.state_arrays(
        "deepnn", got["state_dict"], got["momentum"]), 2, 0)
    back = jckpt.load_checkpoint(port)
    assert back.step == 2
    for a, b in ((back.params, _tree(got["state_dict"])),
                 (back.opt_state.momentum_buf, _tree(got["momentum"]))):
        assert all(np.array_equal(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


# -- the CLI -----------------------------------------------------------------

def _clis(runs):
    """Each ``(entry, args)`` of ``runs`` as a process, all at once; their
    ``CompletedProcess``-like results in order."""
    return run_at_once([(module_argv(f"ddp_tpu_torch.{e}", args), ENV)
                        for e, args in runs])


def _same_file(a, b):
    return chaos_campaign.same_state(tckpt.load_checkpoint(a),
                                     tckpt.load_checkpoint(b))


CLI_COMMON = ["--model", "deepnn", "--grad_accum", "2", "--device", "cpu",
              "--synthetic", "--synthetic_size", "64", "--batch_size", "8"]
# pipelined mesh -> (its schedule, the --grad_accum run's mesh)
CLI_CASES = {"2,1,2": ("1f1b", "2,1"), "1,2,2": ("gpipe", "1,2"),
             "1,1,3": ("1f1b", "1,1")}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The slice's CPU commands, ``--mesh_shape D,M,S --grad_accum 2
    --spawn D·M·S`` under each schedule (three stages too), beside the
    ``D,M`` ``--grad_accum 2`` runs, all at once; then the (2,1,2) and
    (1,2,2) files resumed at (1,1), and the (2,1,2) file at (2,1), at
    once."""
    tmp = tmp_path_factory.mktemp("pp_cli")
    runs, out = [], {}
    for mesh, (schedule, ref) in CLI_CASES.items():
        for what, shape, extra in (
                ("pp", mesh, ["--pp_schedule", schedule]), ("ref", ref, [])):
            spawn = str(int(np.prod([int(v) for v in shape.split(",")])))
            ck, rj = str(tmp / f"{what}{mesh}.pt"), str(tmp /
                                                       f"{what}{mesh}.json")
            out[what, mesh] = {"ck": ck, "rj": rj}
            runs.append(("multigpu", ["2", "1", *CLI_COMMON, "--mesh_shape",
                                      shape, "--spawn", spawn, *extra,
                                      "--snapshot_path", ck,
                                      "--result_json", rj]))
    for (key, r) in zip(list(out), _clis(runs)):
        assert r.returncode == 0, r.stderr[-3000:]
        out[key]["proc"] = r
    resumes = [("singlegpu", "2,1,2", []), ("singlegpu", "1,2,2", []),
               ("multigpu", "2,1,2", ["--mesh_shape", "2,1", "--spawn",
                                      "2"])]
    runs = []
    for entry, mesh, extra in resumes:
        ck = str(tmp / f"resume_{entry}{mesh}.pt")
        with open(out["pp", mesh]["ck"], "rb") as src, open(ck, "wb") as dst:
            dst.write(src.read())
        rj = ck + ".json"
        out["resume", entry, mesh] = {"rj": rj}
        runs.append((entry, ["3", "1", *CLI_COMMON, *extra, "--resume",
                             "--snapshot_path", ck, "--result_json", rj]))
    for (entry, mesh, _), r in zip(resumes, _clis(runs)):
        assert r.returncode == 0, r.stderr[-3000:]
        out["resume", entry, mesh]["proc"] = r
    return out


@pytest.mark.parametrize("mesh", list(CLI_CASES))
def test_cli_pipelined_run_equals_grad_accum_and_resumes(cli_runs, mesh):
    """Each pipelined run exits 0, prints JAX's stage table, and its losses,
    accuracy and saved state equal the ``--grad_accum`` run's bit for bit;
    the (2,1,2) and (1,2,2) files resume at (1,1) and the (2,1,2) one at
    (2,1)."""
    pp, ref = cli_runs["pp", mesh], cli_runs["ref", mesh]
    d, m, s = (int(v) for v in mesh.split(","))
    params, _ = jget_model("deepnn").init(jax.random.key(0))
    table = jpart.format_stage_table(jpart.plan_stages(
        "deepnn", s, model_size=m, params=_np(params), batch_stats={}),
        num_micro=2)
    assert table in pp["proc"].stdout
    got, want = json.load(open(pp["rj"])), json.load(open(ref["rj"]))
    assert got["loss_history"] == want["loss_history"]
    assert got["accuracy"] == want["accuracy"]
    assert _same_file(pp["ck"], ref["ck"])
    schedule = CLI_CASES[mesh][0]
    assert got["mesh_shape"] == [d, m, s] and got["pp_schedule"] == schedule
    assert got["pp_bubble"]["bubble_predicted"] == (s - 1) / (2 + s - 1)
    steps = len(got["loss_history"])
    # Stage 0 (rank 0) sends each micro-batch's activation and receives its
    # cotangent; 1F1B holds min(s - 1, A) forward graphs there, GPipe A.
    assert got["pp_handoff"]["sends"] == steps * 2
    assert got["collectives"]["pp_handoff"] == steps * 2 * 2
    assert got["pp_handoff"]["peak_inflight"] == (
        min(s - 1, 2) if schedule == "1f1b" else 2)
    for key, run in cli_runs.items():
        if key[0] != "resume" or key[2] != mesh:
            continue
        assert "Resuming training from snapshot at Epoch 1" in \
            run["proc"].stdout
        res = json.load(open(run["rj"]))
        assert res["data_state"]["epoch"] == 3 and all(
            np.isfinite(res["loss_history"]))


def _refused(argv, main=cli.main_multi):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


def test_cli_refusals_in_jax_words(start):
    params, _ = start
    base = ["1", "1", "--synthetic", "--device", "cpu", "--model",
            "deepnn", "--mesh_shape", "2,1,2"]
    # The trainer's refusal: JAX's Trainer with a stage plan says it.
    from ddp_tpu.data import TrainLoader, synthetic
    from ddp_tpu.train.trainer import Trainer as JTrainer
    train, _ = synthetic(n_train=16)
    with pytest.raises(ValueError) as j:
        JTrainer(jget_model("deepnn"), TrainLoader(train, 4, 2), params, {},
                 mesh=jmake_mesh(shape=(2, 1, 2)), lr_schedule=_SCHED,
                 snapshot_path=None, resident=True, shard_update=True,
                 sync_bn=True, drift_audit_every=2, ckpt_format="sharded",
                 pp_plan=_jplan(params, 2))
    assert _refused(base + ["--resident", "--shard_update", "--sync_bn",
                            "--drift_audit_every", "2", "--ckpt_format",
                            "sharded"]) == str(j.value)
    assert "incompatible with:\n  - --resident" in _refused(
        base + ["--resident"])
    # A model without PP_BLOCKS, in the JAX CLI's words.
    with pytest.raises(ValueError) as j:
        jpart.plan_stages("vgg", 2, model_size=1)
    assert _refused(["1", "1", "--synthetic", "--device", "cpu",
                     "--mesh_shape", "2,1,2"]) == f"--mesh_shape: {j.value}"
    with pytest.raises(ValueError) as j:
        jpart.plan_stages("deepnn", 4, model_size=2)
    assert _refused(base[:-1] + ["1,2,4"]) == f"--mesh_shape: {j.value}"
    assert "must equal D×M×S = 4" in _refused(base + ["--spawn", "2"])
    assert "belongs to multigpu" in _refused(base, cli.main)


# -- the supervisor and the drill --------------------------------------------

@pytest.mark.parametrize("full", [(2, 1, 2), (2, 2, 2), (4, 1, 4), (1, 1, 2),
                                  (8, 1), (2, 4), (1, 8), (3, 3, 3)])
def test_shrink_mesh_matches_jax(full):
    for ndev in range(1, int(np.prod(full)) + 2):
        assert tsup.shrink_mesh(full, ndev) == jsup.shrink_mesh(full, ndev)


@pytest.mark.parametrize("mesh,probes", [
    ("2,1,2", [2, 4]), ("2,1,2", [3, None]), ("2,2,2", [3, 1]),
    ("8,1", [4, 8]), ("1,1,2", [1, 1])])
def test_supervisor_relaunches_equal_jax(tmp_path, capsys, mesh, probes):
    """The relaunch argv and the ledger's meshes of both supervisors, with
    the same fake launcher and probe, and the stage-plane note."""
    out = {}
    for name, mod in (("port", tsup), ("jax", jsup)):
        launches, seq = [], list(probes)

        def launcher(argv, env):
            launches.append(list(argv))
            return 75 if len(launches) <= len(probes) else 0

        child = ["train.py", "3", "1", "--mesh_shape", mesh]
        sup = mod.Supervisor(child, launcher=launcher, sleep=lambda s: None,
                             device_probe=lambda env: seq.pop(0), env={},
                             seed=0)
        assert sup.run() == 0
        out[name] = (launches, [d["mesh"] for d in sup.ledger.deaths],
                     capsys.readouterr().err.replace("ddp_tpu_torch",
                                                     "ddp_tpu"))
    assert out["port"] == out["jax"]
    if mesh == "2,1,2":
        assert "stage plane lost" in out["port"][2]


def test_kill_stage_drill_on_the_cpu(tmp_path):
    """``python -m ddp_tpu_torch.chaos_campaign --device cpu --drills
    kill_stage``: the (2,1,2) run preempted at step 2, relaunched at
    (2,1,1) on the probe's 2 cards, finishes bit for bit the undisturbed
    pipelined control."""
    out = tmp_path / "card.json"
    r = subprocess.run(
        [sys.executable, "-m", "ddp_tpu_torch.chaos_campaign", "--device",
         "cpu", "--drills", "kill_stage", "--out", str(out), "--workdir",
         str(tmp_path / "w")], cwd=tmp_path, env=ENV, capture_output=True,
        text=True, timeout=400)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    drill = json.loads(out.read_text())["drills"]["kill_stage"]
    assert drill["pass"] and drill["bit_identical"]
    assert drill["restart_reasons"] == {"preempted": 1}
    assert drill["postmortem"]["reason"] == "preemption"
    assert "shrinking mesh 2,1,2 -> 2,1,1" in r.stderr
