"""The port's data-parallel path on the CPU: gloo process groups of spawned
ranks against ``ddp_tpu`` on a JAX mesh of as many CPU devices.

Tolerances: a world-2 epoch (3 full batches and a ragged tail, narrow VGG,
augmentation off) against JAX's ``make_train_epoch`` on ``make_mesh(2)``
at 1e-4, the tolerance ``tests/test_torch_vgg.py`` states for the resident
epoch (float32 sums taken in other orders, grown through four SGD steps);
eval counters exactly.  JAX's float32 reductions on the mesh drift further
than that from exact arithmetic on these sets (its momentum on the
28-image set, its weights on the 55-image one; the float64 checks print
the distances), so a float64 epoch written apart from both packages holds
the port's whole state at the same 1e-4, and JAX is held where it agrees
with it.  A
world-1 run and ``singlegpu`` compare bit for bit: the same kernels on the
same inputs, the collectives the identity of one rank.

Every multi-process case gives its ranks one CPU thread and a hard
timeout, so a hung rendezvous fails the test instead of stalling the
suite.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_tpu.models.vgg as jvgg
from ddp_tpu.data import cifar10 as jcifar
from ddp_tpu.data import loader as jloader
from ddp_tpu.models import get_model as jget_model
from ddp_tpu.optim import SGDConfig as JSGDConfig, triangular_lr as jlr
from ddp_tpu.parallel import make_mesh
from ddp_tpu.train import checkpoint as jckpt
from ddp_tpu.train.epoch import (make_eval_epoch, make_train_epoch,
                                 put_index_matrix)
from ddp_tpu.train.step import init_train_state
from ddp_tpu_torch import cli, interop
from ddp_tpu_torch.data import cifar10 as tcifar
from ddp_tpu_torch.data import loader as tloader
from ddp_tpu_torch.data.sampler import DistributedShardSampler
from ddp_tpu_torch.device import NoCardError
from ddp_tpu_torch.models.vgg import VGG
from ddp_tpu_torch.parallel import dist, drill
from ddp_tpu_torch.train.trainer import draw_seed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = [8, "M", 16, "M", 512, "M"]
TIMEOUT = 120
# One thread per rank, and the repo importable from any working directory.
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
CLI_ARGS = ["--resident", "--synthetic", "--device", "cpu", "--lr", "0.05"]


def _run(module, args, env=ENV, timeout=TIMEOUT):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _jax_state(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(jvgg, "ARCH", NARROW)
    return NARROW


def _jax_world2(params, stats, train, test, batch, lr, seed):
    """JAX's resident epoch and eval on ``make_mesh(2)``: (per-step losses,
    trained state, (correct, total), the epoch's index rows)."""
    mesh = make_mesh(2)
    jl = jloader.TrainLoader(train, batch, 2, seed=seed, augment=False)
    jl.set_epoch(0)
    full, tail = jl.epoch_index_matrix()
    jmodel = jget_model("vgg")
    epoch_fn = make_train_epoch(
        jmodel, JSGDConfig(lr=lr),
        lambda s: jlr(s, base_lr=lr, num_epochs=1, steps_per_epoch=len(jl)),
        mesh)
    state = init_train_state(params, stats)
    images, labels = jnp.asarray(train.images), jnp.asarray(train.labels)
    rng = jax.random.key(seed)
    state, l_full = epoch_fn(state, images, labels,
                             put_index_matrix(full, mesh), rng)
    state, l_tail = epoch_fn(state, images, labels,
                             put_index_matrix(tail[None], mesh), rng)
    idx, mask = jloader.EvalLoader(test, batch, 2).epoch_index_matrix()
    counts = make_eval_epoch(jmodel, mesh)(
        state.params, state.batch_stats, jnp.asarray(test.images),
        jnp.asarray(test.labels), put_index_matrix(idx, mesh),
        put_index_matrix(mask, mesh))
    losses = np.concatenate([np.asarray(l_full), np.asarray(l_tail)])
    return (losses, state, tuple(float(c) for c in counts),
            list(full) + [tail])


def _check_ranks(ranks, steps):
    for r, got in enumerate(ranks):
        assert (got["rank"], got["world"], got["backend"]) == (r, 2, "gloo")
        assert got["steps"] == steps
        # Per step: one gradient and one buffer all-reduce; then the loss
        # sum and the eval counters.  One broadcast at the start.
        assert got["collectives"] == {"all_reduce": 2 * steps + 2,
                                      "broadcast": 1}
    # The replicas stay in lockstep: the same summed gradients and averaged
    # buffers give bit-equal state on every rank.
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k
    assert torch.equal(ranks[0]["losses"], ranks[1]["losses"])
    assert (ranks[0]["correct"], ranks[0]["total"]) == \
        (ranks[1]["correct"], ranks[1]["total"])


def test_world2_epoch_and_eval_match_jax_mesh(narrow):
    # The images of test_torch_vgg.py's resident-epoch parity; each of the
    # 2 replicas takes 14 of them: 3 batches of 4 and a ragged tail of 2.
    seed, lr, batch = 3, 0.05, 4
    jtrain, jtest = jcifar.synthetic(n_train=28, n_test=20)
    ttrain, ttest = tcifar.synthetic(n_train=28, n_test=20)
    params, stats = jvgg.init(jax.random.key(seed))
    # Before the JAX epoch, which donates the state it is given.
    sd = interop.state_dict_from_jax("vgg", _jax_state(params),
                                         _jax_state(stats))
    jlosses, state, counts, rows = _jax_world2(params, stats, jtrain, jtest,
                                               batch, lr, seed)
    assert [len(r) for r in rows] == [8, 8, 8, 4]
    ranks = drill.run(drill.spec(narrow, sd, ttrain, ttest, batch=batch,
                                 lr=lr, seed=seed, augment=False,
                                 device="cpu"),
                      2, env=ENV, timeout=TIMEOUT)
    _check_ranks(ranks, int(state.step))

    got = ranks[0]
    np.testing.assert_allclose(got["losses"].numpy(), jlosses, rtol=1e-4,
                               atol=1e-4)
    port_p, port_s = interop.jax_from_state_dict("vgg", got["state_dict"])
    for a, b in zip(jax.tree_util.tree_leaves((port_p, port_s)),
                    jax.tree_util.tree_leaves(_jax_state(
                        (state.params, state.batch_stats)))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert (got["correct"], got["total"]) == counts and counts[1] == 20.0
    # Momentum is the sum of the steps' gradients, where JAX's float32
    # reductions on the mesh drift from float64 by more than 1e-4 here: the
    # float64 epoch holds it, and the whole state again.
    _check_float64(got, state, narrow, sd, ttrain, rows, lr)


def _float64_epoch(arch, sd, train, rows, world, lr, schedule,
                   momentum=0.9, wd=5e-4, eps=1e-5, bn_momentum=0.1):
    """The data-parallel epoch in float64 plain PyTorch, written apart from
    both packages: per-replica BN statistics, running buffers averaged over
    the replicas, the sum of the replicas' gradients of their shares of the
    global-mean loss, SGD with momentum and weight decay.  Returns
    (losses, state dict, momentum list in parameter order)."""
    p = {k: v.detach().double().clone() for k, v in sd.items()}
    names = [k for k in sd if not k.endswith(("running_mean", "running_var"))]
    buf = {k: torch.zeros_like(p[k]) for k in names}
    images = torch.from_numpy(train.images)
    labels = torch.from_numpy(train.labels).long()
    losses = []
    for step, row in enumerate(rows):
        b = len(row) // world
        grads = {k: torch.zeros_like(p[k]) for k in names}
        stats, total = {}, 0.0
        for r in range(world):
            idx = torch.from_numpy(np.asarray(row[r * b:(r + 1) * b])).long()
            x = images[idx].permute(0, 3, 1, 2).double() / 255.0
            q = {k: p[k].clone().requires_grad_() for k in names}
            i = 0
            for a in arch:
                if a == "M":
                    x = torch.nn.functional.max_pool2d(x, 2, 2)
                    continue
                x = torch.nn.functional.conv2d(
                    x, q[f"backbone.conv{i}.weight"], padding=1)
                mean = x.mean((0, 2, 3))
                var = x.var((0, 2, 3), unbiased=False)
                n = x.shape[0] * x.shape[2] * x.shape[3]
                for key, v in (("running_mean", mean),
                               ("running_var", var * n / (n - 1))):
                    k = f"backbone.bn{i}.{key}"
                    stats.setdefault(k, []).append(
                        (1 - bn_momentum) * p[k] + bn_momentum * v.detach())
                ch = lambda t: t[None, :, None, None]
                x = torch.relu((x - ch(mean)) / ch(torch.sqrt(var + eps))
                               * ch(q[f"backbone.bn{i}.weight"])
                               + ch(q[f"backbone.bn{i}.bias"]))
                i += 1
            logits = torch.nn.functional.linear(
                x.mean((2, 3)), q["classifier.weight"], q["classifier.bias"])
            loss = torch.nn.functional.cross_entropy(
                logits, labels[idx], reduction="sum") / (b * world)
            for k, g in zip(names, torch.autograd.grad(
                    loss, [q[k] for k in names])):
                grads[k] += g
            total += float(loss.detach())
        for k, vs in stats.items():
            p[k] = sum(vs) / world
        lr_t = float(schedule(step))
        for k in names:
            buf[k] = momentum * buf[k] + grads[k] + wd * p[k]
            p[k] = p[k] - lr_t * buf[k]
        losses.append(total)
    return np.array(losses), p, [buf[k] for k in names]


def _check_float64(got, state, arch, sd, train, rows, lr):
    """Rank 0's losses, weights, BN buffers and momentum against
    :func:`_float64_epoch` on the same rows, at the resident epoch's 1e-4.
    Prints the largest distance from the float64 epoch of the port's state
    and momentum and of JAX's ``state`` (``pytest -s`` shows it)."""
    flosses, fstate, fmomentum = _float64_epoch(
        arch, sd, train, rows, 2, lr,
        lambda s: jlr(s, base_lr=lr, num_epochs=1, steps_per_epoch=len(rows)))
    model = VGG(arch)
    jsd = interop.state_dict_from_jax("vgg",
        *_jax_state((state.params, state.batch_stats)))
    jmomentum = interop.momentum_list_from_tree(
        model, _jax_state(state.opt_state.momentum_buf))
    dist_of = lambda tensors, ref: max(
        float((t.double() - r).abs().max()) for t, r in zip(tensors, ref))
    keys = list(fstate)
    print(f"float64 epoch, {len(rows)} steps: port state "
          f"{dist_of([got['state_dict'][k] for k in keys], fstate.values()):.3e}"
          f", momentum {dist_of(got['momentum'], fmomentum):.3e}; JAX state "
          f"{dist_of([jsd[k] for k in keys], fstate.values()):.3e}, "
          f"momentum {dist_of(jmomentum, fmomentum):.3e}")
    np.testing.assert_allclose(got["losses"].numpy(), flosses, rtol=1e-4,
                               atol=1e-4)
    for k, v in fstate.items():
        np.testing.assert_allclose(got["state_dict"][k].double().numpy(),
                                   v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for a, b in zip(got["momentum"], fmomentum):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_world2_epoch_matches_a_float64_reference(narrow):
    """55 images: each replica pads to 28 = 3 batches of 8 and a tail of 4.
    Here JAX's mesh epoch ends further than 1e-4 from the float64 epoch
    (its float32 reductions under the one-pass BN variance; the printed
    distances), so the float64 epoch holds the state and JAX the losses and
    the eval counters."""
    seed, lr, batch = 3, 0.05, 8
    jtrain, jtest = jcifar.synthetic(n_train=55, n_test=20)
    ttrain, ttest = tcifar.synthetic(n_train=55, n_test=20)
    params, stats = jvgg.init(jax.random.key(seed))
    sd = interop.state_dict_from_jax("vgg", _jax_state(params),
                                         _jax_state(stats))
    jlosses, state, counts, rows = _jax_world2(params, stats, jtrain, jtest,
                                               batch, lr, seed)
    assert [len(r) for r in rows] == [16, 16, 16, 8]
    ranks = drill.run(drill.spec(narrow, sd, ttrain, ttest, batch=batch,
                                 lr=lr, seed=seed, augment=False,
                                 device="cpu"),
                      2, env=ENV, timeout=TIMEOUT)
    _check_ranks(ranks, 4)
    got = ranks[0]
    np.testing.assert_allclose(got["losses"].numpy(), jlosses, rtol=1e-4,
                               atol=1e-4)
    assert (got["correct"], got["total"]) == counts and counts[1] == 20.0
    _check_float64(got, state, narrow, sd, ttrain, rows, lr)


def test_world1_run_is_bit_equal_to_singlegpu(tmp_path):
    args = ["2", "1", "--batch_size", "8", "--synthetic_size", "16",
            *CLI_ARGS]
    results = {}
    for entry, extra in (("singlegpu", []), ("multigpu", ["--spawn", "1"])):
        path = tmp_path / f"{entry}.json"
        r = _run(f"ddp_tpu_torch.{entry}",
                 args + extra + ["--snapshot_path", str(tmp_path / entry),
                                 "--result_json", str(path)])
        assert r.returncode == 0, r.stdout + r.stderr
        results[entry] = json.loads(path.read_text())
    single, multi = results["singlegpu"], results["multigpu"]
    assert (single["world"], single["backend"]) == (1, None)
    assert (multi["world"], multi["backend"]) == (1, "gloo")
    # The world-1 group ran every collective: two a step, the loss sum of
    # each epoch, the eval counters, and the start's broadcast.
    assert multi["collectives"] == {"all_reduce": 2 * 4 + 2 + 1,
                                    "broadcast": 1}
    assert len(single["loss_history"]) == 4
    assert multi["loss_history"] == single["loss_history"]
    assert multi["accuracy"] == single["accuracy"]


def test_rank_zero_keeps_the_single_device_draw_key():
    for seed, epoch, step in ((0, 0, 0), (3, 7, 97)):
        want = int(np.random.SeedSequence([seed, epoch, step]).generate_state(
            1, np.uint64)[0]) & ((1 << 63) - 1)
        assert draw_seed(seed, epoch, step) == want
        assert draw_seed(seed, epoch, step, rank=0) == want
        others = {draw_seed(seed, epoch, step, rank=r) for r in (1, 2, 3)}
        assert want not in others and len(others) == 3


@pytest.mark.parametrize("world,n", [(1, 37), (2, 55), (3, 50), (4, 64)])
@pytest.mark.parametrize("epoch", [0, 2])
def test_rank_columns_are_the_distributed_sampler_stream(world, n, epoch):
    ds, _ = tcifar.synthetic(n_train=n, n_test=8)
    loader = tloader.TrainLoader(ds, 4, world, seed=5)
    loader.set_epoch(epoch)
    for r in range(world):
        full, tail = loader.rank_index_matrix(r)
        assert full.flags.c_contiguous and full.shape[1] == 4
        stream = np.concatenate([full.reshape(-1)] +
                                ([tail] if tail is not None else []))
        if world == 1:
            sampler = loader.samplers[0]
        else:
            sampler = DistributedShardSampler(n, world, r, seed=5)
        sampler.set_epoch(epoch)
        np.testing.assert_array_equal(stream, sampler.indices())


@pytest.mark.parametrize("world", [1, 2, 3])
def test_eval_rank_columns_match_jax_device_blocks(world):
    _, ds = tcifar.synthetic(n_train=8, n_test=23)
    _, jds = jcifar.synthetic(n_train=8, n_test=23)
    idx, mask = jloader.EvalLoader(jds, 4, world).epoch_index_matrix()
    loader = tloader.EvalLoader(ds, 4, world)
    cover = np.zeros(23)
    for r in range(world):
        ridx, rmask = loader.rank_index_matrix(r)
        np.testing.assert_array_equal(ridx, idx[:, 4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(rmask, mask[:, 4 * r:4 * (r + 1)])
        np.add.at(cover, ridx[rmask > 0], 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("argv,want", [
    (["1", "1", "--spawn", "2", "--lr", "0.1"], ["1", "1", "--lr", "0.1"]),
    (["--spawn=2", "1", "1"], ["1", "1"]),
    (["1", "--sp", "4", "1"], ["1", "1"]),
    (["1", "--spa=3", "1"], ["1", "1"]),
    (["--spaw", "2", "1", "1", "--snapshot_path", "x"],
     ["1", "1", "--snapshot_path", "x"]),
])
def test_strip_spawn_in_every_spelling(argv, want):
    assert dist.strip_spawn(argv) == want


def test_a_rank_never_spawns(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="never spawns"):
        dist.spawn_local(2, "ddp_tpu_torch.multigpu", ["1", "1"])
    # A rank started with --spawn in its argv (here under a world-1
    # rendezvous) trains as that rank and spawns nothing.
    env = dict(ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    path = tmp_path / "r.json"
    r = _run("ddp_tpu_torch.multigpu",
             ["1", "1", "--batch_size", "8", "--synthetic_size", "16",
              *CLI_ARGS, "--spawn", "2", "--snapshot_path",
              str(tmp_path / "c.pt"), "--result_json", str(path)], env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("Batchsize:") == 1
    assert json.loads(path.read_text())["world"] == 1


def test_multigpu_cli_round_trip_two_ranks(tmp_path):
    snapshot = tmp_path / "checkpoint.pt"
    path = tmp_path / "r.json"
    r = _run("ddp_tpu_torch.multigpu",
             ["2", "1", "--batch_size", "8", "--synthetic_size", "64",
              *CLI_ARGS, "--spawn", "2", "--snapshot_path", str(snapshot),
              "--result_json", str(path)])
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    for epoch in (0, 1):
        for rank in (0, 1):
            assert out.count(f"[GPU{rank}] Epoch {epoch} | Batchsize: 8 | "
                             f"Steps: 4") == 1
        assert out.count(f"Epoch {epoch} | Training checkpoint saved") == 1
    assert out.count("fp32 model has accuracy=") == 1
    assert out.count("Total training time:") == 1
    result = json.loads(path.read_text())
    assert (result["world"], result["backend"]) == (2, "gloo")
    assert len(result["loss_history"]) == 8
    assert all(np.isfinite(result["loss_history"]))
    ckpt = jckpt.load_checkpoint(str(snapshot))
    assert (ckpt.step, ckpt.epoch) == (8, 1)
    assert ckpt.data_state["epoch"] == 2


def test_a_failing_rank_fails_the_spawner(tmp_path):
    # Rank 1 fails at once; rank 0 would wait a minute.  The launcher ends
    # rank 0 and returns rank 1's code.
    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    assert dist.launch_local([sys.executable, "-c", code], 2, env=ENV,
                             timeout=TIMEOUT) == 3
    assert time.monotonic() - t0 < 30
    # A rank that raises exits 1, and the spawner returns it: here both
    # ranks refuse a checkpoint that is not one.
    bad = tmp_path / "checkpoint.pt"
    bad.write_bytes(b"not a checkpoint")
    r = _run("ddp_tpu_torch.multigpu",
             ["1", "1", "--batch_size", "8", "--synthetic_size", "16",
              *CLI_ARGS, "--spawn", "2", "--snapshot_path", str(bad),
              "--resume"])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "Traceback" in r.stderr


def test_launch_local_times_out():
    code = "import time; time.sleep(60)"
    t0 = time.monotonic()
    assert dist.launch_local([sys.executable, "-c", code], 2, env=ENV,
                             timeout=2) == 124
    assert time.monotonic() - t0 < 30


def test_multigpu_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(NoCardError, match="--device cpu"):
        cli.main_multi(["1", "1", "--resident", "--synthetic"])


def test_singlegpu_refuses_spawn():
    with pytest.raises(SystemExit, match="multigpu"):
        cli.main(["1", "1", "--resident", "--synthetic", "--device", "cpu",
                  "--spawn", "2"])


@pytest.mark.parametrize("main", [cli.main, cli.main_multi])
def test_label_noise_needs_synthetic(main, monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="only applies to the --synthetic"):
        main(["1", "1", "--resident", "--device", "cpu",
              "--synthetic_label_noise", "0.25"])


def test_label_noise_changes_the_labels(monkeypatch, tmp_path):
    made = []
    real = tcifar.synthetic

    def recording(**kw):
        made.append((kw, real(**kw)))
        return made[-1][1]

    monkeypatch.setattr(cli.cifar10, "synthetic", recording)
    cli.main(["1", "1", "--batch_size", "8", "--synthetic_size", "16",
              *CLI_ARGS, "--synthetic_label_noise", "0.5",
              "--snapshot_path", str(tmp_path / "c.pt")])
    (kw, (train, test)), = made
    assert kw["label_noise"] == 0.5
    clean_train, clean_test = real(n_train=16, n_test=64)
    assert (train.labels != clean_train.labels).any()
    assert (test.labels != clean_test.labels).any()
    np.testing.assert_array_equal(train.images, clean_train.images)
    jtrain, jtest = jcifar.synthetic(n_train=16, n_test=64, label_noise=0.5)
    np.testing.assert_array_equal(train.labels, jtrain.labels)
    np.testing.assert_array_equal(test.labels, jtest.labels)
