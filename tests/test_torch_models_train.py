"""DeepNN and ResNet-18 trained by the port on the CPU: resident epochs at
world 1 against JAX's epoch program and a float64 epoch written apart from
both packages (``tests/torch_float64.py``), DeepNN's ``--grad_accum 2`` with
a dropout mask per micro-batch, ResNet-18 at world 2 over gloo with
``--sync_bn`` against ``make_mesh(2)``, and the CLI round trips (``--model``,
``--resume``, ``--export_torch``/``--init_from_torch``, streaming,
``multigpu --spawn 2``, ``serve --model``).

Tolerances: the port within 1e-4 of the float64 epoch (losses, weights,
BatchNorm buffers, momentum), and within 1e-4 of JAX plus JAX's own
distance from the float64 epoch: on ResNet-18 JAX's float32 drifts from it
by more than that (BatchNorm's backward over small counts amplifies
rounding, ``tests/test_torch_models.py``), as on the VGG epochs
(``tests/test_torch_ddp.py``).  DeepNN's masks are JAX's, drawn from the
JAX trainer's key chain (``key(seed)``, ``fold_in(step)``,
``fold_in(axis_index)``, ``fold_in(k)`` a micro-batch) and passed in.
``-s`` prints the distances.  The CLI round trips hold bit for bit.
"""
import functools
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import loader as jloader
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.parallel import make_mesh
from ddp_tpu.train.epoch import (make_train_epoch, make_train_epoch_accum,
                                 put_index_matrix)
from ddp_tpu.train.step import init_train_state
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data import loader as tloader
from ddp_tpu_torch.data.resident import ResidentData
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.models import get_model
from ddp_tpu_torch.ops import layers as tlayers
from ddp_tpu_torch.optim import SGDConfig, triangular_lr
from ddp_tpu_torch.parallel import drill
from ddp_tpu_torch.serve import ServeEngine
from ddp_tpu_torch.train import epoch as tepoch
from ddp_tpu_torch.train import step as tstep
from ddp_tpu_torch.train.checkpoint import CheckpointError

from torch_float64 import float64_epoch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
TOL, LR, SEED, KEEP, MARGIN = 1e-4, 0.05, 3, 0.9, 1e-6
N_PARAMS = {"deepnn": 1_186_986, "resnet18": 11_181_642}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mask(seed, step, rank=0, micro=None, rows=8):
    """JAX's dropout mask of a train step: the key its trainer folds."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), step),
                             rank)
    if micro is not None:
        key = jax.random.fold_in(key, micro)
    return np.asarray(jax.random.bernoulli(key, KEEP, (rows, 512)))


@pytest.fixture
def jax_masks(monkeypatch):
    queue = []

    def from_queue(shape, keep, generator, device):
        mask = queue.pop(0)
        assert tuple(mask.shape) == tuple(shape) and keep == KEEP
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(tlayers, "keep_mask", from_queue)
    return queue


def _far(got_losses, got_sd, got_mom, ref):
    """The largest distance of (losses, state dict, momentum list) from a
    float64 epoch's ``(losses, state, momentum)``."""
    losses, state, mom = ref
    d = [float(np.abs(np.asarray(got_losses, np.float64) - losses).max())]
    d += [float((got_sd[k].double() - v).abs().max())
          for k, v in state.items()]
    d += [float((a.double() - b).abs().max()) for a, b in zip(got_mom, mom)]
    return max(d)


def _jax_as_port(name, losses, state):
    """JAX's epoch result as the port's (losses, state dict, momentum)."""
    sd = interop.state_dict_from_jax(name, _np_tree(state.params),
                                     _np_tree(state.batch_stats))
    model = get_model(name)
    mom = interop.momentum_list_from_tree(
        model, _np_tree(state.opt_state.momentum_buf))
    return np.asarray(losses), sd, mom


@pytest.mark.parametrize("name,n_train,accum,seed", [
    ("deepnn", 16, 1, 3), ("deepnn", 32, 2, 3), ("resnet18", 9, 1, 5)])
def test_resident_epoch_matches_jax_and_float64(name, n_train, accum, seed,
                                                jax_masks):
    """One resident epoch at world 1, batch 8, augmentation off: DeepNN
    with JAX's masks (per micro-batch under ``--grad_accum 2``), ResNet-18
    with a ragged tail of 1 row (its layer4 BatchNorm then normalises a
    count of 1: variance 0, the unbiased factor clamped).  ResNet-18's
    float64 trajectory first shows every ReLU and max-pool decision at
    least MARGIN from flipping (``drill.Margins``): BatchNorm's batch
    statistics carry float32 rounding into every activation, and on 17
    images at seeds 1-12 some lie 2e-8 to 3e-7 from a kink, where the
    float32 runs and the float64 one took opposite sides at 3 of 4 seeds
    tried (up to 1.5e-1 apart).  DeepNN has no BatchNorm: its runs stay
    within 2e-6 of float64 (printed)."""
    batch, SEED = 8, seed
    jtrain, _ = jcifar.synthetic(n_train=n_train, n_test=8)
    ttrain, _ = tcifar.synthetic(n_train=n_train, n_test=8)
    params, stats = _np_tree(jget_model(name).init(jax.random.key(SEED)))
    sd = interop.state_dict_from_jax(name, params, stats)
    tl = tloader.TrainLoader(ttrain, batch, seed=SEED)
    tl.set_epoch(0)
    full, tail = tl.epoch_index_matrix()
    calls = tloader.optimizer_groups(full, tail, accum)  # [G, A, B] each
    groups = [g for call in calls for g in call]  # [A, B] a step
    steps = tl.optimizer_steps_per_epoch(accum)
    assert steps == len(groups) == -(-n_train // (batch * accum))
    masks = {(s, k): _mask(SEED, s, micro=k if accum > 1 else None,
                           rows=g.shape[-1])
             for s, g in enumerate(groups) for k in range(g.shape[0])}

    # JAX: the scan-per-epoch program on a 1-device mesh, one call per shape
    # of group, as its trainer calls it.
    mesh = make_mesh(1)
    sched = functools.partial(jlr, base_lr=LR, num_epochs=1,
                              steps_per_epoch=steps)
    jmodel = jget_model(name)
    make = make_train_epoch_accum if accum > 1 else make_train_epoch
    epoch_fn = make(jmodel, JSGDConfig(lr=LR), sched, mesh)
    state = init_train_state(params, stats)
    jl = []
    for call in calls:
        idx = call if accum > 1 else call[:, 0]
        state, losses = epoch_fn(state, jax.numpy.asarray(jtrain.images),
                                 jax.numpy.asarray(jtrain.labels),
                                 put_index_matrix(idx, mesh),
                                 jax.random.key(SEED))
        jl.append(np.asarray(losses))
    jax_run = _jax_as_port(name, np.concatenate(jl), state)

    # The port: the same groups through make_train_epoch, JAX's masks.
    if name == "deepnn":
        jax_masks.extend(masks[key] for key in sorted(masks))
    model = get_model(name)
    model.load_state_dict(sd)
    tstate = tstep.init_train_state(model)
    run = tepoch.make_train_epoch(model, SGDConfig(lr=LR), functools.partial(
        triangular_lr, base_lr=LR, num_epochs=1, steps_per_epoch=steps))
    res = ResidentData(ttrain, torch.device("cpu"))
    tlosses = torch.cat([run(tstate, res.images, res.labels,
                             torch.from_numpy(call), None, None,
                             lambda step, micro=0: torch.Generator())
                         for call in calls])
    assert not jax_masks and tstate.step == steps == int(state.step)
    port_run = (tlosses.numpy(), model.state_dict(), tstate.momentum)

    decisions = []
    ref = float64_epoch(
        sd, ttrain, groups, sched, world=1, sync_bn=False, model=name,
        masks=(lambda s, k, r: torch.from_numpy(masks[s, k]))
        if name == "deepnn" else None, margins=decisions)
    margin = min(min(d) for d in decisions)
    print(f"{name}: nearest ReLU or max-pool decision of the float64 "
          f"trajectory {margin:.3e} from flipping")
    if name == "resnet18":
        assert margin >= MARGIN
    port, jax_far = _far(*port_run, ref), _far(*jax_run, ref)
    apart = max(
        float(np.abs(port_run[0] - jax_run[0]).max()),
        max(float((port_run[1][k] - v).abs().max())
            for k, v in jax_run[1].items()),
        max(float((a - b).abs().max())
            for a, b in zip(port_run[2], jax_run[2])))
    print(f"{name} accum {accum}: from the float64 epoch, port {port:.3e}, "
          f"JAX {jax_far:.3e}; port from JAX {apart:.3e}")
    assert port <= TOL and apart <= jax_far + TOL


def test_resnet18_world2_sync_bn_matches_jax_mesh():
    """ResNet-18 at world 2 over gloo with ``--sync_bn`` (all 20 BatchNorm
    layers over both ranks' batches) against JAX's ``make_train_epoch(
    sync_bn=True)`` on ``make_mesh(2)`` and the float64 epoch on the global
    batch; the collectives a rank: 3 a fused BN+ReLU and 4 a plain
    BatchNorm per micro-batch (71), and per step one gradient and one
    buffer all-reduce.  At seed 12 the float64 trajectory's decisions lie
    at least MARGIN from flipping."""
    batch, n_train, SEED = 8, 32, 12
    jtrain, jtest = jcifar.synthetic(n_train=n_train, n_test=8)
    ttrain, ttest = tcifar.synthetic(n_train=n_train, n_test=8)
    params, stats = _np_tree(jget_model("resnet18").init(
        jax.random.key(SEED)))
    sd = interop.state_dict_from_jax("resnet18", params, stats)
    ranks = drill.run(drill.spec("resnet18", sd, ttrain, ttest, batch=batch,
                                 lr=LR, seed=SEED, augment=False,
                                 device="cpu", sync_bn=True),
                      2, env=ENV, timeout=180)

    mesh = make_mesh(2)
    jl = jloader.TrainLoader(jtrain, batch, 2, seed=SEED, augment=False)
    jl.set_epoch(0)
    full, tail = jl.epoch_index_matrix()
    assert tail is None and full.shape == (2, 16)
    sched = lambda s: jlr(s, base_lr=LR, num_epochs=1,
                          steps_per_epoch=len(full))
    epoch_fn = make_train_epoch(jget_model("resnet18"), JSGDConfig(lr=LR),
                                sched, mesh, sync_bn=True)
    state, losses = epoch_fn(init_train_state(params, stats),
                             jax.numpy.asarray(jtrain.images),
                             jax.numpy.asarray(jtrain.labels),
                             put_index_matrix(full, mesh),
                             jax.random.key(SEED))
    jax_run = _jax_as_port("resnet18", losses, state)
    decisions = []
    ref = float64_epoch(sd, ttrain, [row[None] for row in full], sched,
                        world=2, sync_bn=True, model="resnet18",
                        margins=decisions)
    assert min(min(d) for d in decisions) >= MARGIN
    for got in ranks:
        assert got["collectives"] == {"all_reduce": 71 * 2 + 2 * 2 + 2,
                                      "broadcast": 1}
        port_run = (got["losses"].numpy(), got["state_dict"],
                    got["momentum"])
        port, jax_far = _far(*port_run, ref), _far(*jax_run, ref)
        apart = max(float(np.abs(port_run[0] - jax_run[0]).max()),
                    max(float((got["state_dict"][k] - v).abs().max())
                        for k, v in jax_run[1].items()))
        print(f"resnet18 world 2 sync-BN rank {got['rank']}: from the "
              f"float64 epoch, port {port:.3e}, JAX {jax_far:.3e}; port "
              f"from JAX {apart:.3e}")
        assert port <= TOL and apart <= jax_far + TOL
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


def _cli_args(name, *extra):
    return ["1", "1", "--batch_size", "8", "--resident", "--synthetic",
            "--synthetic_size", "32", "--device", "cpu", "--model", name,
            "--lr", "0.05", *extra]


@pytest.mark.parametrize("name", ["deepnn", "resnet18"])
def test_cli_model_resume_and_torch_round_trip(name, tmp_path, capsys):
    """``singlegpu --model M`` writes ``"model"`` to ``--result_json``,
    reports M's size, resumes from its file, exports the reference's
    ``state_dict`` that ``--init_from_torch`` loads back bit for bit
    (weights; lr 0 keeps them), streams without ``--resident``, and refuses
    a file of the other model with CheckpointError."""
    snap, res = str(tmp_path / "c.pt"), str(tmp_path / "r.json")
    ref = str(tmp_path / "ref.pt")
    out = cli.main(_cli_args(name, "--snapshot_path", snap, "--result_json",
                             res, "--export_torch", ref))
    printed = capsys.readouterr().out
    with open(res) as f:
        assert json.load(f)["model"] == name
    assert f"fp32 model has size={N_PARAMS[name] * 32 / cli.MiB:.2f} MiB" \
        in printed and f"Torch state_dict exported to {ref}" in printed
    trained = {k: v.clone() for k, v in out["state"].model.state_dict()
               .items()}
    again = cli.main(["2"] + _cli_args(name, "--snapshot_path", snap,
                                       "--resume")[1:])
    assert len(again["loss_history"]) == 4 and again["state"].step == 8

    init = cli.main(_cli_args(name, "--snapshot_path",
                              str(tmp_path / "i.pt"), "--init_from_torch",
                              ref, "--lr", "0"))
    for k, p in init["state"].model.named_parameters():
        assert torch.equal(p.detach(), trained[k]), k
    saved = torch.load(ref, weights_only=True)
    assert sum(k.endswith("num_batches_tracked") for k in saved) == \
        (20 if name == "resnet18" else 0)

    streamed = cli.main([a for a in _cli_args(name) if a != "--resident"]
                        + ["--snapshot_path", str(tmp_path / "s.pt")])
    assert streamed["data_path"] == "streaming" and \
        len(streamed["loss_history"]) == 4
    other = "resnet18" if name == "deepnn" else "deepnn"
    with pytest.raises(CheckpointError, match=f"holds a {name} tree"):
        cli.main(["2"] + _cli_args(other, "--snapshot_path", snap,
                                   "--resume")[1:])


@pytest.mark.parametrize("entry", ["singlegpu", "multigpu", "serve"])
def test_entry_points_refuse_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ddp_tpu_torch.serve import __main__ as serve_main
    main = {"singlegpu": cli.main, "multigpu": cli.main_multi,
            "serve": serve_main.main}[entry]
    args = ["--model", "resnet18"] if entry == "serve" else \
        [a for a in _cli_args("deepnn") if a not in ("--device", "cpu")]
    with pytest.raises(NoCardError, match="--device cpu"):
        main(args)


@pytest.mark.parametrize("name,flags,per_micro", [
    ("deepnn", ["--grad_accum", "2", "--shard_update"], 0),
    ("resnet18", ["--sync_bn"], 71)])
def test_multigpu_spawn2_models(name, flags, per_micro, tmp_path):
    """``multigpu --spawn 2`` over gloo for each model with strategy flags:
    its collectives as counted from the code (DeepNN has no buffers, so
    no buffer all-reduce), and a file that resumes."""
    res = str(tmp_path / "r.json")
    args = ["1", "1", "--batch_size", "4", "--resident", "--synthetic",
            "--synthetic_size", "32", "--device", "cpu", "--spawn", "2",
            "--model", name, "--lr", "0.05", *flags, "--snapshot_path",
            str(tmp_path / "c.pt"), "--result_json", res]
    r = subprocess.run([sys.executable, "-m", "ddp_tpu_torch.multigpu",
                        *args], cwd=ROOT, env=ENV, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(res) as f:
        got = json.load(f)
    accum = 2 if "--grad_accum" in flags else 1
    steps, micro = 4 // accum, 4
    zero = "--shard_update" in flags
    buffers = name == "resnet18"
    # One preemption stop vote at the (resident) epoch boundary, after the
    # gather of the epoch's straggler record (the default run is traced).
    want = {"all_reduce": per_micro * micro + steps * ((not zero) + buffers)
            + 2, "broadcast": 1, "stop_vote": 1, "straggler_gather": 1}
    if zero:
        want.update(reduce_scatter=steps, all_gather=steps + 1)
    assert (got["model"], got["world"], got["backend"]) == (name, 2, "gloo")
    assert got["collectives"] == want and len(got["loss_history"]) == steps


@pytest.mark.parametrize("name", ["deepnn", "resnet18"])
def test_serve_model_from_the_trainers_file(name, tmp_path):
    """``serve --model M`` answers from the trainer's file (the CLI over
    HTTP for ResNet-18, the engine for DeepNN): the logits equal the eager
    forward of the same padded batch bit for bit; the file's model must be
    the one asked for."""
    snap = str(tmp_path / "c.pt")
    out = cli.main(_cli_args(name, "--snapshot_path", snap))
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                             dtype=np.uint8)
    padded = np.zeros((8, 32, 32, 3), dtype=np.uint8)
    padded[:3] = imgs
    model = out["state"].model
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the server's OMP_NUM_THREADS=1
    try:
        want = tstep.make_eval_apply(model)(torch.from_numpy(padded))[:3]
    finally:
        torch.set_num_threads(threads)
    if name == "deepnn":
        engine = ServeEngine.from_checkpoint(snap, name, device="cpu",
                                             buckets=(1, 8))
        engine.warm()
        np.testing.assert_array_equal(engine.forward(imgs),
                                      want.numpy())
        with pytest.raises(CheckpointError, match="model is vgg"):
            ServeEngine.from_checkpoint(snap, "vgg", device="cpu")
        return
    env = {k: v for k, v in ENV.items() if not k.startswith("JAX")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddp_tpu_torch.serve", "--device", "cpu",
         "--model", name, "--port", "0", "--buckets", "1,8",
         "--snapshot_path", snap, "--trace_spill", ""], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"serving {name} on http://" in line, line
        base = line.split("on ")[1].split(" ")[0].rstrip("/")
        req = urllib.request.Request(
            base + "/predict",
            data=json.dumps({"instances": imgs.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    np.testing.assert_array_equal(np.asarray(got["logits"], np.float32),
                                  want.numpy())
